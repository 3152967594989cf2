"""The data-parallel layout of a run (PyTorch port of
``egtr_tpu/parallel/mesh.py``).

The JAX package runs one jit-compiled step over a device mesh with a
``data`` axis (the batch, the DDP analog) and a ``model`` axis that puts
sharding constraints on the Q x Q relation grid. The port runs DDP: one
process a rank, each with its slice of every global batch. ``make_mesh``
keeps its name and its check (``dp * mp`` equals the number of devices,
here the world size) and refuses ``mp != 1``: DDP has no counterpart of the
grid sharding, and tensor parallelism of the relation head is not ported.

What replaces the JAX helpers that are not ported as code:

- ``shard_batch``: the loader's per-process slice (``Loader(...,
  process_index=, process_count=)``) is the rank's batch;
- ``replicate_state``: DDP's broadcast of the parameters from rank 0 when it
  wraps the model (``train_step.make_train_step``);
- ``_mesh_device_order`` (TPU slices) and ``maybe_constraint`` (the grid
  sharding): not applicable to ranks on one node.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int
    mp: int = 1


def make_mesh(dp: Optional[int] = None, mp: int = 1) -> Mesh:
    """The layout of this run's ranks: ``dp`` data-parallel (default: the
    world size) by ``mp`` model-parallel (1).

    Raises ValueError where ``dp * mp`` is not the world size and
    NotImplementedError for ``mp != 1``."""
    n = dist.process_count()
    if mp != 1:
        raise NotImplementedError(
            f"--mp {mp}: the port trains data-parallel only (DDP); tensor "
            "parallelism of the relation head is not ported")
    if dp is None:
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"dp({dp}) * mp({mp}) != world size ({n}); launch "
                         f"{dp * mp} ranks (torchrun --nproc_per_node) or "
                         "leave --dp at its default")
    return Mesh(dp, mp)
