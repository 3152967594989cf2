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
Three collectives carry tensors, ``all_reduce_`` (in place; ``all_reduce_sum``
its copy), ``all_gather`` (``all_gather_into_tensor``: one output tensor, not
a list) and ``broadcast_`` (in place): both backends run them on CUDA
tensors (gloo through the host).

Collectives inside a captured program (``utils/aot.py``). ``capturable``
says whether a group's collectives can be recorded in a CUDA graph: NCCL's
can, gloo's cannot (gloo copies a CUDA tensor to the host, reduces it there
and waits, which a capture cannot hold). The tensor forms above are the
ones a capture records: each writes into a tensor of fixed address (the
train step's gradient buffer is made before its first capture), with no
list of outputs made per call. What ProcessGroupNCCL needs for a capture
(the PyTorch CUDA-graphs notes, "Usage with DistributedDataParallel", step
1; the other two steps there are DDP's own: DDP built on a side stream and
11 eager iterations before the capture, for its reducer's buckets, and the
port has no DDP):

- ``TORCH_NCCL_ASYNC_ERROR_HANDLING=0``, set before the group is made
  (``init_from_env`` sets it unless the caller did): the watchdog thread
  polls each collective's CUDA event and, with error handling on, tears
  the process down on what it reads as an error; a collective issued
  while its stream captures is never handed to it (ProcessGroupNCCL skips
  the queue then, and ``torch.cuda.graph`` waits for the queries pending
  before it begins), and the captures run in thread-local mode
  (``aot.Program``), so the watchdog's own calls cannot break them. A
  collective that times out is then logged, not fatal: the ranks'
  launcher's timeout (``launch.spawn``) ends such a run.
- ``TORCH_NCCL_BLOCKING_WAIT`` unset: a blocking wait synchronizes the
  host, which a capture refuses (``init_from_env`` refuses it under NCCL).
- A communicator is made at a group's first collective, which a capture
  cannot hold: each program's first call warms up eagerly on the capture
  stream (``aot.maybe_aot``), so every group's first collective runs
  outside any capture, and the train step broadcasts the parameters when
  it is made.
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
    if backend == "nccl":
        if os.environ.get("TORCH_NCCL_BLOCKING_WAIT", "0") not in ("", "0"):
            raise ValueError("TORCH_NCCL_BLOCKING_WAIT: a blocking wait "
                             "cannot run inside a captured program")
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
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


def capturable(group=None) -> bool:
    """Whether the collectives of ``group`` (None: the world) can run inside
    a captured CUDA graph: NCCL's can, gloo's cannot (module docstring).
    True without a process group, where there is no collective."""
    return not is_distributed() or dist.get_backend(group) == "nccl"


def all_reduce_(tensor: torch.Tensor, group=None,
                mean: bool = False) -> torch.Tensor:
    """Sum ``tensor`` over the processes of ``group`` (None: all) in place,
    and return it; with ``mean`` divide by their count. Every process gets
    the same bits. NCCL's mean is its AVG, one collective that scales each
    rank's values by 1 / count before the sum (a kernel even at one rank);
    gloo's is the sum, then the division; the two agree bit for bit where
    the count is a power of two. Without a process group: ``tensor`` as it
    is."""
    if not is_distributed():
        return tensor
    if mean and dist.get_backend(group) == "nccl":
        dist.all_reduce(tensor, op=dist.ReduceOp.AVG, group=group)
        return tensor
    dist.all_reduce(tensor, group=group)
    if mean:
        tensor.div_(dist.get_world_size(group))
    return tensor


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``tensor`` over the processes of ``group`` (None: all), as
    a new tensor (the tensor itself without a process group). Every process
    gets the same bits."""
    if not is_distributed():
        return tensor
    return all_reduce_(tensor.detach().clone(), group)


def all_gather(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``tensor`` of every process of ``group`` (None: all), equal shapes,
    stacked in the group's rank order: [n, *tensor.shape] (``tensor[None]``
    without a process group). One ``all_gather_into_tensor`` into one
    output, the form a capture records."""
    if not is_distributed():
        return tensor[None]
    tensor = tensor.detach().contiguous()
    n = dist.get_world_size(group)
    out = tensor.new_empty((n * tensor.shape[0], *tensor.shape[1:]))
    dist.all_gather_into_tensor(out, tensor, group=group)
    return out.view(n, *tensor.shape)


def broadcast_(tensors: List[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s, over every rank:
    one broadcast of a flat buffer per dtype (their storage is kept, which
    captured programs read). No-op without a process group."""
    if not is_distributed():
        return
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src)
        at = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()


def agree(value: Any, what: str, group=None) -> None:
    """Raise unless every process of ``group`` (None: all) passes an equal
    ``value`` (a picklable description, compared with ``==``); the error
    names each rank's. A collective: every rank calls it at the same
    point."""
    values = all_gather_objects(value, group)
    if any(v != values[0] for v in values[1:]):
        raise RuntimeError(
            f"{what}: the ranks disagree: "
            + "; ".join(f"rank {r}: {v}" for r, v in enumerate(values)))


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if is_distributed():
        dist.destroy_process_group()
