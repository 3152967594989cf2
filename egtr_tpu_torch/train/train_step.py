"""Train / eval steps (PyTorch port of ``egtr_tpu/train/train_step.py``).

One step: forward -> loss -> backward -> clip -> AdamW update, eagerly.
Gradient accumulation (the reference's Lightning
``accumulate_grad_batches=2``, train_egtr.py:531,771) runs the microbatches
one after the other, so the peak memory is one microbatch's; the gradients
are summed and divided by the depth, and the logged metrics are averaged
over the microbatches.

The model and the optimizer carry the state (parameters, AdamW moments) and
are updated in place; a step returns the metrics only. Randomness (dropout
masks, uniform negative sampling) comes from the ``torch.Generator`` handed
to the step, on the model's device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..config import EgtrConfig
from ..ops.criterion import detection_criterion, sgg_criterion
from .optim import Optimizer


def _map_batch(fn, value):
    """Apply ``fn`` to every tensor of a (nested) dict of tensors."""
    if isinstance(value, dict):
        return {k: _map_batch(fn, v) for k, v in value.items()}
    return fn(value)


def split_microbatches(batch: dict, accum_steps: int) -> List[dict]:
    """Split a global batch into ``accum_steps`` microbatches by row stride
    (microbatch ``a`` takes rows ``a::accum_steps``), the JAX package's
    convention.

    EVERY key of the batch is split (each value must be a [B, ...] tensor or
    a dict of them, like ``labels``): dropping unknown keys would strip e.g.
    the ``valid`` mask from an accumulated masked step. Values without a
    batch axis are rejected rather than passed through."""
    def sp(a, x):
        if getattr(x, "ndim", 0) == 0 or x.shape[0] % accum_steps:
            raise ValueError(
                f"batch leaf with shape {getattr(x, 'shape', None)} cannot "
                f"be split into {accum_steps} microbatches (leading axis "
                "must exist and divide by the accumulation depth)")
        return x[a::accum_steps]

    return [{k: _map_batch(lambda x: sp(a, x), val)
             for k, val in batch.items()}
            for a in range(accum_steps)]


def make_train_step(model, cfg: EgtrConfig, optimizer: Optimizer,
                    task: str = "sgg", accum_steps: int = 1) -> Callable:
    """Returns ``train_step(batch, generator=None, lr_scale=1.0) -> metrics``.

    batch: dict with pixel_values [A*B,H,W,3], pixel_mask [A*B,H,W] (or
    None), the padded ``labels`` dict and optionally ``valid`` [A*B]; with
    ``accum_steps=A`` it is split into A microbatches by row stride, or may
    already be a list of A microbatch dicts. Metrics, as 0-d tensors on the
    device: every loss term, ``rel_gate_{i}`` (sgg), ``total_loss`` and
    ``grad_norm`` (the global norm before the clip, frozen leaves included).
    """
    def loss_fn(mb, generator):
        out = model(mb["pixel_values"], mb.get("pixel_mask"),
                    generator=generator)
        if task == "sgg":
            total, losses = sgg_criterion(out, mb["labels"], cfg, train=True,
                                          generator=generator,
                                          valid=mb.get("valid"))
            # per-layer mean gate values logged as pseudo-losses
            # (egtr.py:496-505)
            for i in range(cfg.decoder_layers + 1):
                losses[f"rel_gate_{i}"] = out["rel_gate_mean"][i]
        else:
            total, losses = detection_criterion(out, mb["labels"], cfg,
                                                valid=mb.get("valid"))
        return total, losses

    def train_step(batch, generator: Optional[torch.Generator] = None,
                   lr_scale: float = 1.0) -> Dict[str, torch.Tensor]:
        if isinstance(batch, (list, tuple)):
            mbs = list(batch)
        elif accum_steps == 1:
            mbs = [batch]
        else:
            mbs = split_microbatches(batch, accum_steps)
        if len(mbs) != accum_steps:
            raise ValueError(f"{len(mbs)} microbatches for accum_steps="
                             f"{accum_steps}")
        model.train()
        optimizer.zero_grad()
        metrics: Dict[str, torch.Tensor] = {}
        for mb in mbs:
            total, losses = loss_fn(mb, generator)
            total.backward()  # sums into .grad across the microbatches
            losses["total_loss"] = total
            for k, x in losses.items():
                x = x.detach().float()
                metrics[k] = x if k not in metrics else metrics[k] + x
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            torch._foreach_mul_(optimizer.grads(), inv)
            metrics = {k: x * inv for k, x in metrics.items()}
        metrics["grad_norm"] = optimizer.step(lr_scale)
        return metrics

    return train_step


def make_eval_step(model, cfg: EgtrConfig, task: str = "sgg") -> Callable:
    """``eval_step(batch) -> (outputs, losses)`` without sampling or dropout.

    ``batch["valid"]`` (when present) masks the padded tail rows a loader
    appends, so the validation loss covers real images only."""
    def eval_step(batch):
        model.eval()
        with torch.no_grad():
            out = model(batch["pixel_values"], batch.get("pixel_mask"))
            valid = batch.get("valid")
            if task == "sgg":
                total, losses = sgg_criterion(out, batch["labels"], cfg,
                                              train=False, valid=valid)
            else:
                total, losses = detection_criterion(out, batch["labels"], cfg,
                                                    valid=valid)
        losses["total_loss"] = total
        return out, losses

    return eval_step
