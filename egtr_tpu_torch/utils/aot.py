"""One program per argument signature: per-shape CUDA graphs (PyTorch port of
``egtr_tpu/utils/aot.py``).

The JAX package runs each request, evaluation forward and training step as
one compiled XLA executable, one per argument-shape signature (a bucketed
loader feeds a handful of shapes), and dispatches them through
``maybe_aot``. On the card the counterpart of a compiled executable is a
captured CUDA graph: one replay launches the whole program, with no Python
between its kernels. This module keeps the JAX module's two names:

- ``load_or_compile(fn, *args, tag)`` captures ``fn`` at the signature of
  ``args`` into a :class:`Program`: one real call of ``fn`` on ``args`` on
  the capture stream first (the warm-up, which also makes the lazy state a
  capture must find: the optimizer's moments, the kernels' libraries, the
  cuBLAS workspace), its outputs kept as ``Program.warmup_outputs``; then
  the capture, from the one memory pool every program of the process
  shares (``graph_pool``; a bucketed loader's programs take about the
  largest one's memory, not the sum), into static input buffers for every
  tensor leaf of the (nested) arguments. The warm-up allocates outside the
  pool: a persistent tensor it makes (the optimizer's moments) must not
  take the free blocks of a program that replays later. So that a
  warm-up's memory is not reserved beside a pool's, the cached free blocks
  go back to the card before the warm-up (a dead program's pool among
  them) and after it (``release_cached``), and the static inputs are made
  after that; persistent state that a warm-up would make amid its
  activations, pinning their segments, is better made before it (the train
  step makes the gradients and the optimizer's moments first). A
  ``torch.Generator`` among the arguments (the step's dropout masks and
  negative samples) is registered with the graph, so that every replay
  draws new numbers from it, as an eager call would.
- ``maybe_aot(fn, tag)`` dispatches per signature: the key is the tree
  structure of the arguments, each tensor leaf's shape, dtype and device,
  the other leaves' values (``None`` included; a generator by identity),
  and the module state a program reads while it is captured
  (``msda.FWD_BATCH_P``, the TF32 switches: ``global_state``). The first
  call of the first signature is the warm-up and returns its outputs. The
  first call of any later signature (another bucket) captures without a
  warm-up and replays: an eager warm-up would reserve its activations
  beside the pool, whose free blocks the earlier programs keep, where a
  capture reuses them; the lazy state exists by then, and the one made
  per shape (``layers.level_wh``'s tables) a capture builds inside its
  graph. Later calls copy the inputs in, replay, and return fresh clones
  of the outputs (JAX returns new arrays; the trainer keeps metrics until
  ``log_every``, ``run_fps`` keeps several requests in flight). It
  returns ``fn`` itself, eager, on the CPU (a ``device`` that is not a
  card, or arguments without a CUDA tensor).

In a process group (the JAX wrapper keeps its jitted program there and
skips only its on-disk cache) the rule is one, in ``maybe_aot``, and its
caller says whether ``fn`` holds a collective (``collectives``):

- a function without one (the runner's forward at ``mp`` 1) is captured
  under any backend, each rank its own program;
- a function with one (the data-parallel train step's gradient
  all-reduce, the criterion's global denominators, ``--mp``'s row gather
  and gradient sum) is captured where the group's collectives can be
  (``dist.capturable``: NCCL, whose collectives the graph records) and
  runs eagerly under gloo, which stages CUDA tensors through the host: the
  layout where ranks share one card, a test layout. It prints
  ``[aot] TAG: eager, gloo collectives`` once, when it is made.

A capture executes nothing, so every rank must warm up, capture and replay
a function with collectives at the same call: before a call that would
warm up or capture, outside any capture, the ranks agree on its signature
(``dist.agree`` of ``portable_signature``: shapes, dtypes, structure, the
module state), and a disagreement raises with each rank's. Nothing falls
back to eager.

A replay launches its kernels without their wrappers, so
``msda_cuda.launches`` counts the warm-ups' launches and not the replays'
(the capture launches nothing); the card's own count of a replay's kernels
is in a torch.profiler trace, which sees inside graphs.

What the JAX module has and this one has not: an on-disk stage (a CUDA graph
cannot be serialized; the port's persistent stage is the kernels' nvcc build
in ``build/``, keyed by a hash of the sources, the counterpart of
``egtr_tpu/utils/cache.py``) and a fallback (a capture that fails raises;
nothing quietly runs eager). A captured program reads the tensors it was
captured with: parameters and optimizer state must keep their storage
(``load_state_dict`` on a module copies in place; restoring an optimizer
replaces its tensors, so it comes before the first step).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..ops import msda
from ..parallel import dist

_TENSOR = "tensor"


def flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """The tensor leaves of a nested structure of dicts, lists and tuples,
    in order, and its definition: the structure with each tensor leaf
    replaced by its (shape, dtype, device) and every other leaf kept as it
    is. The definition is hashable where the other leaves are; it is the
    signature ``maybe_aot`` keys its programs by."""
    leaves: List[torch.Tensor] = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            leaves.append(node)
            return (_TENSOR, tuple(node.shape), node.dtype, node.device)
        if isinstance(node, dict):
            return ("dict", tuple((k, walk(v)) for k, v in node.items()))
        if isinstance(node, (list, tuple)):
            return (type(node).__name__, tuple(walk(v) for v in node))
        return ("leaf", node)

    return leaves, walk(tree)


def unflatten(treedef, leaves) -> Any:
    """The structure ``treedef`` describes, with ``leaves`` in place of its
    tensor leaves, in order."""
    it = iter(leaves)

    def build(node):
        kind, body = node[0], node[1]
        if kind == _TENSOR:
            return next(it)
        if kind == "dict":
            return {k: build(v) for k, v in body}
        if kind in ("list", "tuple"):
            items = [build(v) for v in body]
            return items if kind == "list" else tuple(items)
        return body

    return build(treedef)


def global_state() -> tuple:
    """The module state a captured program holds as it was at capture: the
    batched-P flag of the MSDA forward and the TF32 switches."""
    return (msda.FWD_BATCH_P, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def signature(args) -> Any:
    """The dispatch key of a call: its arguments' ``flatten`` definition and
    the ``global_state``."""
    return flatten(args)[1], global_state()


def portable_signature(args) -> str:
    """``signature`` as the ranks of a process group can compare it: the
    device type in place of a tensor's device (each rank has its own card),
    a generator by its kind (each rank has its own)."""
    def port(node):
        kind, body = node[0], node[1]
        if kind == _TENSOR:
            return (kind, body, str(node[2]), node[3].type)
        if kind == "dict":
            return (kind, tuple((k, port(v)) for k, v in body))
        if kind in ("list", "tuple"):
            return (kind, tuple(port(v) for v in body))
        return (kind, "generator" if isinstance(body, torch.Generator)
                else body)

    return repr((port(flatten(args)[1]), global_state()))


_pools: Dict[torch.device, Any] = {}
_streams: Dict[torch.device, torch.cuda.Stream] = {}


def graph_pool(device: torch.device):
    """The memory pool that every program of the process on ``device``
    shares."""
    if device not in _pools:
        with torch.cuda.device(device):
            _pools[device] = torch.cuda.graph_pool_handle()
    return _pools[device]


def release_cached(device: torch.device) -> None:
    """Return the cached free blocks on ``device`` to the card, once its
    work is done. A graph's pool and the default pool never lend to each
    other, so what one caches stays reserved beside the other: before a
    warm-up this returns a dead program's pool (a training phase's, when
    the next phase warms up its own step), after it the warm-up's freed
    activations, so that the static inputs made next take segments of
    their own (``torch.cuda.graph`` empties the cache again as it
    begins a capture)."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every warm-up and capture on ``device`` runs on (a
    shared pool wants the same stream for each capture)."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


def _clone(tree):
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [t.clone() for t in leaves])


class Program:
    """``fn`` captured at one signature (``load_or_compile``), after an eager
    warm-up unless ``warm_up`` is false (``maybe_aot``'s later signatures).

    Calling it copies the arguments' tensor leaves into the static inputs,
    replays the graph on the current stream and returns clones of the
    outputs."""

    def __init__(self, fn: Callable, args: tuple, tag: str,
                 warm_up: bool = True):
        self.tag = tag
        leaves, self.treedef = flatten(args)
        devices = {t.device for t in leaves if t.device.type == "cuda"}
        if len(devices) != 1:
            raise ValueError(f"aot {tag}: a program runs on one card; its "
                             f"arguments' CUDA devices are {devices}")
        device = devices.pop()
        generators = [g for g in _other_leaves(self.treedef)
                      if isinstance(g, torch.Generator)
                      and g.device.type == "cuda"]
        stream = capture_stream(device)
        t0 = time.perf_counter()
        release_cached(device)
        self.warmup_outputs = None
        if warm_up:
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                warm = fn(*args)
            torch.cuda.current_stream(device).wait_stream(stream)
            # the caller's copy, made on its own stream
            self.warmup_outputs = _clone(warm)
            del warm
            # the warm-up's blocks back to the card: the pool grows into
            # them, and the static inputs take segments of their own
            release_cached(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self.static_in = [t.detach().clone() for t in leaves]
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        with torch.cuda.graph(self.graph, pool=graph_pool(device),
                              stream=stream,
                              capture_error_mode="thread_local"):
            self.static_out = fn(*unflatten(self.treedef, self.static_in))
        torch.cuda.current_stream(device).wait_stream(stream)
        self.capture_seconds = time.perf_counter() - t0
        print(f"[aot] {tag}: captured in {self.capture_seconds:.1f} s",
              flush=True)

    def __call__(self, *args):
        leaves, treedef = flatten(args)
        if treedef != self.treedef:
            raise ValueError(f"aot {self.tag}: the arguments' signature is "
                             "not the program's")
        for static, t in zip(self.static_in, leaves):
            static.copy_(t)
        self.graph.replay()
        return _clone(self.static_out)


def _other_leaves(treedef):
    kind, body = treedef[0], treedef[1]
    if kind == "leaf":
        yield body
    elif kind == "dict":
        for _, v in body:
            yield from _other_leaves(v)
    elif kind in ("list", "tuple"):
        for v in body:
            yield from _other_leaves(v)


def load_or_compile(fn: Callable, *args, tag: str) -> Program:
    """Capture ``fn`` at ``args``' signature (module docstring). The warm-up
    is one real call of ``fn`` on ``args``: a caller that must not run
    ``fn`` twice on the same arguments (a step that updates state) takes
    ``warmup_outputs`` instead of calling the program, as ``maybe_aot``
    does. Raises if the capture fails."""
    return Program(fn, args, tag)


def maybe_aot(fn: Callable, tag: str, device=None,
              collectives: bool = False) -> Callable:
    """``fn`` dispatched to one captured program per argument signature
    (module docstring), or ``fn`` itself where ``device`` is not a card, or
    in a process group whose collectives a capture cannot hold where ``fn``
    holds one (``collectives``). Calls whose arguments hold no CUDA tensor
    run ``fn`` eagerly."""
    if device is not None and torch.device(device).type != "cuda":
        return fn
    if collectives and not dist.capturable():
        print(f"[aot] {tag}: eager, gloo collectives", flush=True)
        return fn
    lockstep = collectives and dist.is_distributed()
    programs: Dict[Any, Program] = {}

    def call(*args):
        leaves, _ = flatten(args)
        if not any(t.device.type == "cuda" for t in leaves):
            return fn(*args)
        key = signature(args)
        program = programs.get(key)
        if program is None:
            if lockstep:
                dist.agree(portable_signature(args),
                           f"aot {tag}: the signature of a call that "
                           "captures")
            if programs:
                # a later signature: captured at once, then replayed
                programs[key] = Program(fn, args, tag, warm_up=False)
                return programs[key](*args)
            program = programs[key] = load_or_compile(fn, *args, tag=tag)
            out, program.warmup_outputs = program.warmup_outputs, None
            return out
        return program(*args)

    call.programs = programs
    return call
