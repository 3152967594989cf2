"""Optimizer construction: AdamW with the reference's three LR param groups
(PyTorch port of ``egtr_tpu/train/optim.py``).

Reference (train_egtr.py:426-467 / pretrain_detr.py:171-193):
- ``lr_backbone``: backbone convs + ``reference_points`` + the MSDA
  ``sampling_offsets`` linears,
- ``lr_initialized``: the freshly initialized relation head (only when
  fine-tuning from a pretrained detector),
- ``lr``: everything else.

Frozen (no update): the set ``egtr_tpu``'s ``param_label`` freezes, label for
label. The port's parameter names carry the flax names, so the same rules
read them.

What is held to the JAX package rather than to ``torch.optim`` habits:

- **The clip norm covers the frozen leaves.** ``egtr_tpu`` differentiates
  every flax param (frozen-BN weight, bias and statistics, the stem, the
  frequency-bias tables) and clips by the global norm before the per-label
  transforms, so the frozen leaves' gradients count in the clip scale and in
  ``grad_norm``. The original EGTR clips trainable parameters only.
- **The clip formula is optax's**: unchanged where ``norm < max_norm``, else
  ``(g / norm) * max_norm``; ``torch.nn.utils.clip_grad_norm_`` would add
  1e-6 to the norm.
- **AdamW**: optax applies ``-lr * (m/(sqrt(v)+eps) + wd*p)`` in one step;
  ``torch.optim.AdamW`` decays the parameter first (``p *= 1 - lr*wd``) and
  then takes the Adam step. The two agree to first order in ``lr*wd``
  (2e-8 at the largest learning rate of the recipe).

A step a CUDA graph can hold, as the JAX package's ``_update`` is one
compiled program (``utils/aot.py`` captures the train step): on the card
the AdamW is ``capturable`` (its step counts and bias corrections on the
device), each group's learning rate is a float32 device tensor that
``step`` writes in place from the group's base rate times ``lr_scale`` (a
number or a 0-d device tensor), and the gradient buffers are allocated once
and zeroed in place. A captured step reads those tensors; restoring a
checkpoint into the optimizer (``adamw.load_state_dict``) replaces them, so
it comes before the first step, as every caller does it. ``torch.optim``
has no capturable AdamW on the CPU: there the learning rates stay numbers.
"""

from __future__ import annotations

from typing import Collection, Dict, List, Optional, Tuple

import torch
from torch import nn


def param_label(name: str,
                initialized_paths: Optional[Collection[str]] = None) -> str:
    """Label one parameter (its dotted ``named_parameters`` name) with its
    LR group: "main", "backbone", "initialized" or "frozen".

    ``initialized_paths``: freshly initialized parameter paths ("/"-joined;
    entries may be subtree prefixes; a leading "params/" is ignored). None
    falls back to the relation-head heuristic, which equals the reference
    set for the standard detector -> EGTR finetune.
    """
    keys = name.split(".")
    joined = "/".join(keys)
    # frozen sets
    if "rel_dist" in joined or "triplet_dist" in joined:
        return "frozen"
    if "backbone" in joined:
        # as egtr_tpu writes it: "conv1"/"bn1" match the stem and also every
        # bottleneck's first conv and norm
        if ("conv1" in keys or "bn1" in keys
                or any(k.startswith("layer1_") for k in keys)):
            return "frozen"
        if "running_mean" in joined or "running_var" in joined:
            return "frozen"
        # frozen-BN affine params are never trained
        if keys[-1] in ("weight", "bias") and any("bn" in k for k in keys):
            return "frozen"
        return "backbone"
    if "reference_points" in joined or "sampling_offsets" in joined:
        return "backbone"
    if initialized_paths is None:
        if "relation_head" in joined:
            return "initialized"
    else:
        for p in initialized_paths:
            p = p.removeprefix("params/")
            if joined == p or joined.startswith(p + "/"):
                return "initialized"
    return "main"


class Optimizer:
    """AdamW over the three LR groups plus the global-norm clip.

    ``step`` clips the gradients in place over *all* leaves, the frozen ones
    included, then updates the trainable ones; the frozen leaves are in no
    group and stay bit-identical.
    """

    def __init__(self, named_params: List[Tuple[str, nn.Parameter]],
                 labels: Dict[str, str], lrs: Dict[str, float],
                 weight_decay: float, grad_clip: float):
        self.labels = labels
        self.leaves = [p for _, p in named_params]
        self.grad_clip = grad_clip
        # capturable on the card only: torch.optim refuses it on the CPU
        self.capturable = bool(self.leaves) and all(
            p.device.type == "cuda" for p in self.leaves)
        groups = []
        for label, lr in lrs.items():
            params = [p for n, p in named_params if labels[n] == label]
            if params:
                group = {"params": params, "lr": lr, "base_lr": lr,
                         "name": label}
                if self.capturable:
                    group["lr"], group["base_lr_tensor"] = (
                        torch.tensor(lr, dtype=torch.float32,
                                     device=params[0].device)
                        for _ in range(2))
                groups.append(group)
        self.adamw = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay,
                                       capturable=self.capturable)

    def init_state(self) -> None:
        """Make every leaf's gradient and AdamW's state now, as the first
        ``grads`` and ``step`` would (zeros, the step count a float32 on
        the leaf's device where capturable): made before the first step's
        warm-up, they take segments of their own instead of pinning the
        warm-up's freed activations (``utils/aot.py``)."""
        self.grads()
        for group in self.adamw.param_groups:
            for p in group["params"]:
                state = self.adamw.state[p]
                if state:
                    continue
                state["step"] = (
                    torch.zeros((), dtype=torch.float32, device=p.device)
                    if self.capturable else torch.tensor(0.0))
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)

    def zero_grad(self) -> None:
        """Zero every leaf's gradient in place (allocated at the first
        call): the buffers keep their storage from step to step."""
        torch._foreach_zero_(self.grads())

    def grads(self) -> List[torch.Tensor]:
        """Gradients of all leaves; a leaf the loss did not reach gets
        zeros, as ``jax.grad`` gives it."""
        for p in self.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.leaves]

    def step(self, lr_scale=1.0) -> torch.Tensor:
        """Clip, update, and return the global gradient norm before the
        clip. ``lr_scale`` (a number, or on the card a 0-d device tensor)
        multiplies the whole update, weight decay included: each group's
        learning rate is scaled."""
        grads = self.grads()
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip:
            trigger = norm < self.grad_clip
            one = torch.ones_like(norm)
            # optax: select(norm < max_norm, g, (g / norm) * max_norm)
            torch._foreach_div_(grads, torch.where(trigger, one, norm))
            torch._foreach_mul_(grads, torch.where(
                trigger, one, torch.full_like(norm, self.grad_clip)))
        for group in self.adamw.param_groups:
            if self.capturable:
                # float32 on the device, the same for a number or a tensor
                torch.mul(group["base_lr_tensor"], lr_scale, out=group["lr"])
            else:
                group["lr"] = group["base_lr"] * float(lr_scale)
        self.adamw.step()
        return norm


def make_optimizer(model: nn.Module, lr: float, lr_backbone: float,
                   lr_initialized: Optional[float] = None,
                   weight_decay: float = 1e-4, grad_clip: float = 0.1,
                   initialized_paths: Optional[Collection[str]] = None
                   ) -> Optimizer:
    paths = tuple(initialized_paths) if initialized_paths is not None \
        else None
    named = list(model.named_parameters())
    labels = {n: param_label(n, paths) for n, _ in named}
    lrs = {"main": lr, "backbone": lr_backbone,
           "initialized": lr_initialized if lr_initialized is not None
           else lr}
    return Optimizer(named, labels, lrs, weight_decay, grad_clip)
