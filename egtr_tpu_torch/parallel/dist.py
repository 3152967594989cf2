"""The process group of a data-parallel run (PyTorch port of
``egtr_tpu/parallel/dist.py``).

Ranks are started the way PyTorch users start DDP::

    torchrun --nproc_per_node N -m egtr_tpu_torch.scripts.train_egtr ...

``torchrun`` (which ``parallel.launch.spawn`` runs) sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
``init_from_env`` reads them, joins the group and returns the rank's
device. The backend is NCCL on
the card and gloo on the CPU unless the caller names one; ranks that share
a card (more local ranks than cards, as on a one-card machine) take gloo,
which takes CUDA tensors and stages them through the host: NCCL refuses two
ranks on one device. A failed init raises; nothing falls back to another
backend or to the CPU.

Without a process group every function here is the single-process identity
(rank 0 of 1, ``all_gather_objects(x) == [x]``, sums are the tensor itself),
so single-process code paths stay as they were. The collectives take a
``group`` (a data or model group of ``mesh.make_mesh``; None: the world).
Two collectives carry tensors, ``all_reduce`` and ``all_gather``: both
backends run them on CUDA tensors (gloo through the host).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def init_from_env(device=None, backend: Optional[str] = None
                  ) -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this rank's device.

    ``device``: "cpu" or the card (None, "cuda"); on the card the rank takes
    ``cuda:{LOCAL_RANK}`` (set with ``torch.cuda.set_device``), and with more
    ranks than cards, ``LOCAL_RANK`` modulo the card count under gloo.
    ``backend``: None picks NCCL where every local rank
    (``LOCAL_WORLD_SIZE``) has a card of its own, else gloo. Without
    ``WORLD_SIZE`` in the environment it joins nothing and returns the
    device, which is the card unless ``device`` says otherwise (raising where
    CUDA is absent). A second call returns the device of the first."""
    from ..infer import resolve_device

    device = resolve_device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if backend is None:
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if local_ranks <= cards else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the port runs nccl or gloo")
    if device.type == "cuda":
        if local >= cards and backend != "gloo":
            raise ValueError(
                f"LOCAL_RANK {local} on {cards} card(s): ranks that share a "
                "card need backend='gloo' (NCCL refuses two ranks on one "
                "device)")
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("backend 'nccl' needs the card; the CPU runs gloo")
    if dist.is_initialized():
        return device
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return device


def is_distributed() -> bool:
    """True inside a process group (of any size, one included)."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def is_primary() -> bool:
    """Rank 0: the one that writes metrics, checkpoints and artifacts."""
    return process_index() == 0


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def all_gather_objects(obj: Any, group=None) -> List[Any]:
    """Gather one picklable object per process of ``group`` (None: all);
    returns them in the group's rank order on every process (``[obj]``
    without a process group)."""
    if not is_distributed():
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``tensor`` over the processes of ``group`` (None: all), as
    a new tensor (the tensor itself without a process group). Every process
    gets the same bits."""
    if not is_distributed():
        return tensor
    out = tensor.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(tensor: torch.Tensor, group=None) -> List[torch.Tensor]:
    """``tensor`` of every process of ``group`` (None: all), equal shapes,
    as a list in the group's rank order on every process (``[tensor]``
    without a process group)."""
    if not is_distributed():
        return [tensor]
    tensor = tensor.detach().contiguous()
    out = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, tensor, group=group)
    return out


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if is_distributed():
        dist.destroy_process_group()
