"""Train / eval steps (PyTorch port of ``egtr_tpu/train/train_step.py``).

One step: forward -> loss (its matching on the device) -> backward -> clip
-> AdamW update. On the card each step is run as the JAX package splits it
into compiled programs, here captured CUDA graphs (``utils/aot.py``), one
per batch signature: with ``accum_steps == 1`` one program of the whole
step; with gradient accumulation (the reference's Lightning
``accumulate_grad_batches=2``, train_egtr.py:531,771) the microbatch
program (forward + backward into the gradient buffers, JAX's ``_grads_mb``)
once per microbatch, then the apply program (the gradient reduction in a
process group, the depth's mean, the clip and the update, JAX's
``_apply``), so the peak memory is one microbatch's; the logged metrics are
averaged over the microbatches. The eval step is one program. On the CPU
the same functions run eagerly; in a process group a function that holds a
collective is a program where the group's backend is NCCL, whose
collectives the graph records, and runs eagerly under gloo
(``aot.maybe_aot``'s rule).

The model and the optimizer carry the state (parameters, AdamW moments) and
are updated in place; a step returns the metrics only. Randomness (dropout
masks, uniform negative sampling) comes from the ``torch.Generator`` handed
to the step, on the model's device.

Inside a process group (``parallel.dist``) the step is data-parallel, with
the JAX package's semantics: its loss is the loss of the global batch, the
concatenation of the data ranks' batches. The layout is a
``parallel.mesh.Mesh`` of ``dp`` x ``mp`` ranks (``make_train_step``'s
``mesh``; by default the model's, else every rank data-parallel). Making
the step broadcasts the parameters from rank 0 (the JAX package's
``replicate_state``). The criterion sums its denominators over the data
group, so each data rank's loss is its share of the global loss, and the
ranks of a model group, which share one batch slice, hold the same share.
After the last microbatch's backward the step reduces the gradients itself
(``GradientReduction``, in the whole-step or the apply program): one
all-reduce over every rank of the world of one flat float32 buffer that
holds every leaf's gradient, divided by ``dp * mp``, so each rank
backpropagates ``dp`` times its share and the reduced gradient is the
global loss's. (Not ``DistributedDataParallel``: its hooks pick buckets
on the host during the backward and ``find_unused_parameters`` walks the
autograd graph every forward, which a captured program cannot repeat.)
With ``mp > 1`` each rank of a model group computes its rows of the
relation grid only (``models/egtr.py``): the gradients of the grid's
parameters (``EgtrModel.grid_parameters``) are partial sums, which the
world average divides by ``mp``, so the step multiplies them by ``mp``
before the clip;
the detector's gradients, which every rank of a model group computes in
full, come out of the average as they are. The reduction runs over the
world and not over the data group because the ranks of a model group
compute the detector's gradients each on its own: on the card the float32
scatter-adds of the MSDA backward round them differently from run to run,
and only one reduction over every rank keeps all parameters bit-equal.
Every leaf takes part, the frozen ones and those the loss does not reach
(``rel_dist``, the options' unused heads: zeros) too, so the clip norm and
``grad_norm`` cover them as in the JAX package; there are no buffers to
broadcast. Microbatches before the last reduce nothing. The logged metrics
are summed over the data group (``rel_gate_*``, a batch mean, averaged), so
every rank returns the same numbers. Dropout masks cannot match the JAX
package's global mask bit for bit (each data rank draws from its own
generator, and the ranks of a model group from the same one), so parity
with it holds at dropout 0.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch

from ..config import EgtrConfig
from ..ops.criterion import detection_criterion, sgg_criterion
from ..parallel import dist
from ..parallel.mesh import Mesh, make_mesh
from ..utils.aot import maybe_aot
from .optim import Optimizer


def _map_batch(fn, value):
    """Apply ``fn`` to every tensor of a (nested) dict of tensors."""
    if isinstance(value, dict):
        return {k: _map_batch(fn, v) for k, v in value.items()}
    return fn(value)


def split_microbatches(batch: dict, accum_steps: int) -> List[dict]:
    """Split a global batch into ``accum_steps`` microbatches by row stride
    (microbatch ``a`` takes rows ``a::accum_steps``), the JAX package's
    convention. Applied to each rank's contiguous slice of a global batch
    (the loader's), it keeps the rows of microbatch ``a`` over all ranks,
    in rank order, those of the single-process split.

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


def resolve_mesh(model, mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh``, else the model's, else (in a process group) every rank
    data-parallel; None in one process."""
    if mesh is None:
        mesh = getattr(model, "mesh", None)
    if mesh is None and dist.is_distributed():
        mesh = make_mesh()
    return mesh


def data_reduce(mesh: Optional[Mesh]):
    """The criterion's ``reduce``: a sum over the data group, None where
    there is one data rank (the batch is the global batch)."""
    if mesh is None or mesh.dp == 1:
        return None
    return functools.partial(dist.all_reduce_sum, group=mesh.data_group)


class GradientReduction:
    """The step's gradient reduction in a process group: ``grads`` (every
    leaf's, in the optimizer's order) copied into one flat float32 buffer,
    made here, before any capture, so that its address is the programs';
    the buffer averaged over every rank of the world in place
    (``dist.all_reduce_``); the result copied back. One collective per
    optimizer step, whatever the accumulation depth."""

    def __init__(self, grads: List[torch.Tensor]):
        self.grads = grads
        self.flat = torch.zeros(sum(g.numel() for g in grads),
                                dtype=torch.float32, device=grads[0].device)
        self.views, at = [], 0
        for g in grads:
            self.views.append(self.flat[at:at + g.numel()].view_as(g))
            at += g.numel()

    def __call__(self) -> None:
        torch._foreach_copy_(self.views, self.grads)
        dist.all_reduce_(self.flat, mean=True)
        torch._foreach_copy_(self.grads, self.views)


def make_train_step(model, cfg: EgtrConfig, optimizer: Optimizer,
                    task: str = "sgg", accum_steps: int = 1,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Returns ``train_step(batch, generator=None, lr_scale=1.0) -> metrics``.

    batch: dict with pixel_values [A*B,H,W,3], pixel_mask [A*B,H,W] (or
    None), the padded ``labels`` dict and optionally ``valid`` [A*B]; with
    ``accum_steps=A`` it is split into A microbatches by row stride, or may
    already be a list of A microbatch dicts. Metrics, as 0-d tensors on the
    device: every loss term, ``rel_gate_{i}`` (sgg), ``total_loss`` and
    ``grad_norm`` (the global norm before the clip, frozen leaves included).
    Inside a process group the batch is the rank's slice (the data rank's:
    the ranks of a model group take the same slice and the same generator)
    and the metrics are the global batch's (module docstring); making the
    step broadcasts the parameters from rank 0, so every rank makes it at
    the same point. ``mesh``: the ranks' layout (``resolve_mesh``); a model
    with a mesh of its own must have this one.
    """
    mesh = resolve_mesh(model, mesh)
    if getattr(model, "mesh", None) not in (None, mesh):
        raise ValueError("make_train_step: the model's mesh is not the "
                         "step's")
    reduce = data_reduce(mesh)
    dp = mesh.dp if mesh is not None else 1
    mp = mesh.mp if mesh is not None else 1
    grid = (model.grid_parameters() if hasattr(model, "grid_parameters")
            else [])
    distributed = dist.is_distributed()
    if distributed:
        dist.broadcast_(list(model.parameters()))
    device = next(model.parameters()).device
    if optimizer.capturable:
        # the step's persistent state before its programs' first warm-up
        optimizer.init_state()
    reduction = GradientReduction(optimizer.grads()) if distributed else None

    def loss_fn(mb, generator):
        out = model(mb["pixel_values"], mb.get("pixel_mask"),
                  generator=generator)
        if task == "sgg":
            total, losses = sgg_criterion(out, mb["labels"], cfg, train=True,
                                          generator=generator,
                                          valid=mb.get("valid"),
                                          reduce=reduce)
            # per-layer mean gate values logged as pseudo-losses
            # (egtr.py:496-505)
            for i in range(cfg.decoder_layers + 1):
                losses[f"rel_gate_{i}"] = out["rel_gate_mean"][i]
        else:
            total, losses = detection_criterion(out, mb["labels"], cfg,
                                                valid=mb.get("valid"),
                                                reduce=reduce)
        return total, losses

    def grads_mb(mb, generator):
        """One microbatch's forward + backward, its gradients added into
        the buffers; its loss terms as float32 metrics."""
        total, losses = loss_fn(mb, generator)
        # each data rank backpropagates dp times its share (module docstring)
        (total * dp if distributed else total).backward()
        losses["total_loss"] = total
        return {k: x.detach().float() for k, x in losses.items()}

    def apply(metrics, lr_scale):
        """The gradients reduced over the ranks, the grid's scaled by mp,
        the accumulation's mean, the metrics of the global batch, the clip
        and the update."""
        if reduction is not None:
            reduction()
        # the grid's gradients: each rank's rows, averaged over the world
        grid_grads = [p.grad for p in grid if p.grad is not None]
        if grid_grads:
            torch._foreach_mul_(grid_grads, float(mp))
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            torch._foreach_mul_(optimizer.grads(), inv)
            metrics = {k: x * inv for k, x in metrics.items()}
        if reduce is not None:
            metrics = _global_metrics(metrics, reduce, dp)
        metrics["grad_norm"] = optimizer.step(lr_scale)
        return metrics

    def whole_step(mb, generator, lr_scale):
        optimizer.zero_grad()
        return apply(grads_mb(mb, generator), lr_scale)

    # the reduction (and the global metrics) sit in the whole step and the
    # apply; a microbatch holds the criterion's sums and --mp's collectives
    whole_program = maybe_aot(whole_step, "train_step", device,
                              collectives=distributed)
    grads_program = maybe_aot(grads_mb, "train_grads_mb", device,
                              collectives=reduce is not None or mp > 1)
    apply_program = maybe_aot(apply, "train_apply", device,
                              collectives=distributed)

    def train_step(batch, generator: Optional[torch.Generator] = None,
                   lr_scale=1.0) -> Dict[str, torch.Tensor]:
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
        if device.type == "cuda" and not isinstance(lr_scale, torch.Tensor):
            # an input of the captured update, not a constant in it
            lr_scale = torch.full((), float(lr_scale), dtype=torch.float32,
                                  device=device)
        if accum_steps == 1:
            return whole_program(mbs[0], generator, lr_scale)
        optimizer.zero_grad()
        metrics: Dict[str, torch.Tensor] = {}
        for mb in mbs:
            m = grads_program(mb, generator)
            metrics = m if not metrics else {k: metrics[k] + x
                                             for k, x in m.items()}
        return apply_program(metrics, lr_scale)

    # the programs, as the JAX step exposes its inner ones
    train_step.whole = whole_program
    train_step.grads_mb = grads_program
    train_step.apply = apply_program
    return train_step


def _global_metrics(metrics: Dict[str, torch.Tensor], reduce, dp: int
                    ) -> Dict[str, torch.Tensor]:
    """The data ranks' metrics in one collective: the loss shares summed,
    the batch-mean gate values averaged."""
    total = reduce(torch.stack(list(metrics.values())))
    return {k: x / dp if k.startswith("rel_gate_") else x
            for k, x in zip(metrics, total.unbind())}


def make_eval_step(model, cfg: EgtrConfig, task: str = "sgg",
                   mesh: Optional[Mesh] = None) -> Callable:
    """``eval_step(batch) -> (outputs, losses)`` without sampling or dropout.

    ``batch["valid"]`` (when present) masks the padded tail rows a loader
    appends, so the validation loss covers real images only. Inside a
    process group the denominators are the global batch's, so the data
    ranks' losses add up to the global batch's loss (the caller sums them
    over the data group). ``mesh``: as ``make_train_step`` takes it."""
    mesh = resolve_mesh(model, mesh)
    reduce = data_reduce(mesh)
    mp = mesh.mp if mesh is not None else 1

    def forward_loss(batch):
        with torch.no_grad():
            out = model(batch["pixel_values"], batch.get("pixel_mask"))
            valid = batch.get("valid")
            if task == "sgg":
                total, losses = sgg_criterion(out, batch["labels"], cfg,
                                              train=False, valid=valid,
                                              reduce=reduce)
            else:
                total, losses = detection_criterion(out, batch["labels"], cfg,
                                                    valid=valid,
                                                    reduce=reduce)
        losses["total_loss"] = total
        return out, losses

    program = maybe_aot(forward_loss, "eval_step",
                        next(model.parameters()).device,
                        collectives=reduce is not None or mp > 1)

    def eval_step(batch):
        model.eval()
        return program(batch)

    eval_step.program = program
    return eval_step
