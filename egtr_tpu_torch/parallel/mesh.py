"""The layout of a run's ranks (PyTorch port of
``egtr_tpu/parallel/mesh.py``).

The JAX package runs one jit-compiled step over a ``(data, model)`` device
mesh: ``data`` splits the batch (the DDP analog), ``model`` shards the
subject rows of the Q x Q relation grid (``_PAIR_SPEC`` in
``egtr_tpu/models/egtr.py``). The port runs one process a rank and lays the
ranks out as JAX lays out its devices (``np.asarray(devices).reshape(dp,
mp)``): rank ``d * mp + m`` has data index ``d`` and model index ``m``.

- The **data group** holds the ranks with the same ``m``: each loads its
  slice of every global batch (``Loader(..., process_index=data_index,
  process_count=dp)``), and the losses' denominators, the logged metrics and
  the evaluators merge over it.
- The **model group** holds the ranks with the same ``d``: they share one
  batch slice, run the same detector, and each computes its
  ``ceil(Q / mp)`` rows of the relation grid (``models/egtr.py``,
  ``parallel/tensor_parallel.py``).

What replaces the JAX helpers that are not ported as code:

- ``shard_batch``: the loader's per-process slice is the rank's batch;
- ``replicate_state``: the broadcast of the parameters from rank 0 when the
  train step is made (``train_step.make_train_step``);
- ``_mesh_device_order`` (TPU slices): not applicable to ranks on one node.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch.distributed

from . import dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` x ``mp`` ranks and this rank's place among them.

    ``data_group`` / ``model_group``: the process groups of this rank's data
    and model groups, or None where the group needs no collective of its own:
    one rank, or (the data group at ``mp == 1``) the whole world, whose
    default group serves."""
    dp: int
    mp: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None


def mesh_ranks(dp: int, mp: int) -> tuple:
    """(data groups, model groups) as rank lists, for ``rank = d * mp + m``:
    data group ``m`` holds ``[m, mp + m, ...]``, model group ``d`` holds
    ``[d * mp, ..., d * mp + mp - 1]``."""
    data = [list(range(m, dp * mp, mp)) for m in range(mp)]
    model = [list(range(d * mp, (d + 1) * mp)) for d in range(dp)]
    return data, model


def _groups(rank_lists: List[List[int]], mine: int, needed: bool):
    """Create one process group for each list, on every rank and in the same
    order (``new_group`` is collective); returns the one holding ``mine``."""
    if not (needed and dist.is_distributed()):
        return None
    own = None
    for ranks in rank_lists:
        group = torch.distributed.new_group(ranks, timeout=dist.TIMEOUT)
        if mine in ranks:
            own = group
    return own


def make_mesh(dp: Optional[int] = None, mp: int = 1) -> Mesh:
    """The layout of this run's ranks: ``dp`` data-parallel (default: the
    world size over ``mp``) by ``mp`` model-parallel (1).

    Raises ValueError where ``dp * mp`` is not the world size. Inside a
    process group every rank must call it at the same point: where ``mp >
    1`` it creates every model group, and every data group too where also
    ``dp > 1``."""
    n = dist.process_count()
    if mp < 1 or (dp is not None and dp < 1):
        raise ValueError(f"dp({dp}) and mp({mp}) must be positive")
    if dp is None:
        dp = max(1, n // mp)
    if dp * mp != n:
        raise ValueError(f"dp({dp}) * mp({mp}) != world size ({n}); launch "
                         f"{dp * mp} ranks (torchrun --nproc_per_node) or "
                         "leave --dp at its default")
    rank = dist.process_index()
    d, m = divmod(rank, mp)
    data, model = mesh_ranks(dp, mp)
    # at mp == 1 the data group is the world: the default group serves it.
    # The model group is a group of its own even where it spans the world
    # (dp == 1): its collectives run inside the backward, the gradient
    # reduction on the default group, and two groups never interleave
    # their orders
    return Mesh(dp, mp, d, m, _groups(data, rank, mp > 1 and dp > 1),
                _groups(model, rank, mp > 1))
