"""Tensor parallelism of the relation head over a model group (the port's
counterpart of the JAX package's ``model`` mesh axis on the Q x Q grid,
``_PAIR_SPEC = P(DATA_AXIS, MODEL_AXIS)`` in ``egtr_tpu/models/egtr.py``).

The ranks of a model group run the same detector on the same batch slice;
each computes only its subject rows ``i`` of the relation grid
(``RowSplit``), against every object ``j``. Two autograd functions join the
pieces:

- ``copy_to_model_group``: the identity in the forward; in the backward the
  sum over the group, since each rank's gradient covers its rows only;
- ``gather_rows``: the rows of every rank in the forward, so that the
  criterion and postprocess see the whole [B, Q, Q, .] grid; in the backward
  this rank's rows of the gradient (every rank holds the whole gradient).

As XLA pads a sharded axis that the mesh does not divide, ``RowSplit`` pads
each rank's rows to ``ceil(Q / mp)`` (zeros past Q, dropped by the gather),
so every rank sends a block of one shape to the ``all_gather``. The
gathered grid is the bits each rank computed.

Both collectives take the forms a captured program records
(``dist.capturable``): the backward's sum is an in-place ``all_reduce`` of
the one buffer it makes, the gather one ``all_gather_into_tensor`` into a
[mp, B, rows, ...] output, whose blocks are then laid side by side.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import dist


class RowSplit:
    """The subject rows of a Q-row grid that model index ``index`` of ``mp``
    computes: ``[lo, hi)``, padded to ``rows = ceil(Q / mp)``."""

    def __init__(self, Q: int, mp: int, index: int):
        self.Q, self.mp, self.index = Q, mp, index
        self.rows = -(-Q // mp)
        self.lo = min(index * self.rows, Q)
        self.hi = min(self.lo + self.rows, Q)

    @property
    def real(self) -> int:
        """How many of the rows are real (the rest is padding)."""
        return self.hi - self.lo

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x`` along dim 1, zero-padded to ``rows``."""
        part = x[:, self.lo:self.hi]
        pad = self.rows - self.real
        if not pad:
            return part
        return F.pad(part, (0, 0) * (x.ndim - 2) + (0, pad))


class _CopyToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.meta = [(x.shape, x.dtype) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        # one float32 all_reduce for all inputs, in a fixed order
        flat = torch.cat([
            (g if g is not None else torch.zeros(shape, device=_device(grads),
                                                 dtype=dtype)
             ).reshape(-1).float()
            for g, (shape, dtype) in zip(grads, ctx.meta)])
        dist.all_reduce_(flat, ctx.group)
        out, at = [], 0
        for shape, dtype in ctx.meta:
            n = shape.numel()
            out.append(flat[at:at + n].reshape(shape).to(dtype))
            at += n
        return (None, *out)


def _device(grads):
    return next(g.device for g in grads if g is not None)


def copy_to_model_group(tensors, group):
    """``tensors`` unchanged; their gradients summed over ``group``."""
    return _CopyToModelGroup.apply(group, *tensors)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split: RowSplit, group):
        ctx.split = split
        blocks = dist.all_gather(x, group)             # [mp, B, rows, ...]
        grid = blocks.movedim(0, 1).flatten(1, 2)      # [B, mp * rows, ...]
        return grid[:, :split.Q]

    @staticmethod
    def backward(ctx, grad):
        return ctx.split.take(grad), None, None


def gather_rows(x: torch.Tensor, split: RowSplit, group) -> torch.Tensor:
    """[B, rows, ...] of every rank of ``group`` -> [B, Q, ...] (padding
    dropped); the gradient of this rank's rows passes back."""
    return _GatherRows.apply(x, split, group)
