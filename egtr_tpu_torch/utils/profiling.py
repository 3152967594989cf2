"""Profiling and tracing of the port (PyTorch port of
``egtr_tpu/utils/profiling.py``): layer scopes that survive CUDA-graph
replays, spans on the programs' call path, the live programs as plain data,
and a summarizer that adds up a trace's device time by layer and by op kind.

**Layer scopes.** ``scope(name)`` marks a layer of the model or of the step:

| scope | opened in | covers |
|---|---|---|
| ``backbone`` | ``models/detr.py`` | the ResNet trunk |
| ``input_proj`` | ``models/detr.py`` | input projections, masks, position embeddings, level flattening, valid ratios, encoder reference points |
| ``encoder`` | ``models/detr.py`` | the encoder layers |
| ``decoder`` | ``models/detr.py`` | query init, the decoder layers, the per-layer heads |
| ``relation_head`` | ``models/egtr.py`` | the relation head, logit adjustment, sigmoids |
| ``postprocess`` | ``infer.py:infer_eager`` | the top-k and the packing |
| ``criterion`` | ``train/train_step.py`` | matcher, losses, the metrics' packing |
| ``backward`` | ``train/train_step.py`` | ``.backward()`` (every layer's) |
| ``optimizer`` | ``train/train_step.py`` | zero-grad, reduction, accumulation mean, clip, AdamW |

Work outside every scope is ``other``. When nothing listens a scope costs a
check: it opens a ``record_function`` only while a profiler runs, and it
reads the graph under capture only inside ``capture_layers``, which
``aot.Program`` opens around its capture.

**Replays.** A replay runs no Python, so no scope opens in it. Instead, at
each scope boundary of a capture, ``capture_layers`` notes which of the
capture's nodes are new (the CUDA driver's ``cuStreamGetCaptureInfo`` and
``cuGraphGetNodes``, through ctypes), and at its end orders the graph's
nodes by its edges: the program's **layer map**, its work nodes (kernel,
memcpy and memset) in execution order, each with its kind and its innermost
scope path. Reading the graph adds no node to it. In a trace of the card
the device events of one replay share the correlation id of the graph
launch that issued them; taken in start order, the k-th is the map's k-th
node, where their count and kinds match (a memset or memcpy node may run as
a kernel, as ``memset32``). A replay whose events do not match
(CUPTI dropped rows, a graph that is not a chain) is left out and counted,
never guessed at.

**Call-path spans.** ``aot.Program`` and ``aot.maybe_aot``'s dispatcher
open ``egtr.dispatch/<tag>`` (flatten and signature), ``egtr.copy_in/<tag>``
(the static inputs), ``egtr.launch/<tag>`` (``graph.replay()``) and
``egtr.copy_out/<tag>`` (the outputs' clones) through ``span``: a
``record_function`` range while a profiler runs, on the clock of the card's
events in the same trace; nothing otherwise.

**``programs()``**, the contract for readers outside the package: one
plain dict per live program, in the order they were made, with ``tag``,
``nodes`` (the layer map, ``[kind, scope]`` pairs), ``warmup_s`` (the eager
warm-up, 0 for a later signature) and ``capture_s`` (the static inputs and
the capture).

**Summaries.** ``summarize_trace`` reads a Chrome trace. The device's work:
on the card its kernels, copies and fills (categories ``kernel``,
``gpu_memcpy``, ``gpu_memset``); on the CPU the outermost ``cpu_op`` events
of each thread. Which one a trace is, the trace says (``trace_device``); a
trace of the card without a device event is refused rather than read as
host time. ``by_module``: a replayed event under its map's scope; any other
event under the innermost ``record_function`` scope around it
(``gpu_user_annotation`` on the card, ``user_annotation`` on the CPU; the
``egtr.`` call-path spans and PyTorch's own ranges, whose names hold "#",
are not layers), digits after an underscore folded
(``encoder_layer_3`` -> ``encoder_layer_N``) and the name cut to three
"/"-separated parts; ``other`` where none holds it.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import glob
import gzip
import heapq
import json
import os
import re
import shutil
import tempfile
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the host's calls into the card's runtime: the card was in use
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
SCOPE_CATEGORIES = ("gpu_user_annotation", "user_annotation")
# (kind, pattern) of an event's name, any case, the first match wins; the
# hand-written MSDA kernels under their own names; cuDNN's Hopper
# convolutions (implicit-GEMM "fprop", "dgrad", "wgrad") ahead of "gemm",
# which their names also hold
OP_KINDS = (("msda", r"msda_\w+"),
            ("conv", r"conv|fprop|dgrad|wgrad|implicit_gemm|xmma_fprop"),
            ("gemm", r"gemm|matmul|mm\b|linear|nvjet|cutlass"),
            ("gather", r"gather"), ("scatter", r"scatter|index"),
            ("reduce", r"reduce|sum|mean|norm"), ("softmax", r"softmax"),
            ("sort", r"sort|topk"), ("copy", r"copy|memcpy|\bto\b"),
            ("fill", r"memset|fill|zero"),
            ("elementwise", r"elementwise|add|mul|sub|div|where|relu"))
OTHER = "other"
# the program's call-path spans, which are not layers
SPAN_PREFIX = "egtr."
# PyTorch's own ranges ("Optimizer.step#AdamW.step", "ProfilerStep#3"),
# which are not layers either
TORCH_RANGE = re.compile(r"#")
# the layer map's kinds each device event category may be: CUDA runs some
# memset and memcpy nodes of a graph as kernels ("memset32")
EVENT_KINDS = {"kernel": ("kernel", "memset", "memcpy"),
               "gpu_memcpy": ("memcpy",), "gpu_memset": ("memset",)}
# CUgraphNodeType (the CUDA driver API) of the work nodes
_WORK_NODES = {0: "kernel", 1: "memcpy", 2: "memset"}
_CAPTURE_ACTIVE = 1

_NOOP = contextlib.nullcontext()
_recorder: Optional["_LayerRecorder"] = None
_programs: List[weakref.ref] = []


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler runs;
    otherwise a no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NOOP


def scope(name: str):
    """``with scope("encoder"): ...``: a layer scope (module docstring)."""
    rec = _recorder
    if rec is None or rec.thread != threading.get_ident():
        return span(name)
    return _Scope(name, rec)


class _Scope:
    """A scope inside ``capture_layers``: its boundaries mark the capture's
    nodes, and it is a ``record_function`` range too while a profiler
    runs."""

    def __init__(self, name: str, rec: "_LayerRecorder"):
        self.name, self.rec = name, rec
        self.range = _NOOP

    def __enter__(self):
        self.range = span(self.name)
        self.range.__enter__()
        self.rec.push(self.name)
        return self

    def __exit__(self, *exc):
        self.rec.pop()
        return self.range.__exit__(*exc)


class _LayerRecorder:
    """The scope of every node of a graph under capture: at each boundary
    the nodes not seen before are given the scope path that was open."""

    def __init__(self, query):
        self.query = query
        self.thread = threading.get_ident()
        self.stack: List[str] = []
        self.scope_of: Dict[Any, str] = {}

    def _mark(self) -> None:
        path = "/".join(self.stack) or OTHER
        for node in self.query.nodes():
            if node not in self.scope_of:
                self.scope_of[node] = path

    def push(self, name: str) -> None:
        self._mark()
        self.stack.append(name)

    def pop(self) -> None:
        self._mark()
        self.stack.pop()

    def layer_map(self) -> List[List[str]]:
        self._mark()
        out = []
        for node in self.query.order():
            kind = self.query.kind(node)
            if kind is not None:
                out.append([kind, self.scope_of[node]])
        return out


@contextlib.contextmanager
def capture_layers(query=None):
    """``with capture_layers() as box: fn(...)`` inside a stream capture:
    afterwards ``box["nodes"]`` is the capture's layer map (module
    docstring). ``query`` reads the graph (``CaptureQuery`` on the current
    stream by default; the tests pass a stand-in)."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("capture_layers: a capture is already mapped")
    if query is None:
        query = CaptureQuery(torch.cuda.current_stream().cuda_stream)
    rec = _recorder = _LayerRecorder(query)
    box: Dict[str, List[List[str]]] = {}
    try:
        yield box
        box["nodes"] = rec.layer_map()
    finally:
        _recorder = None


def _driver():
    lib = ctypes.CDLL("libcuda.so.1")
    vp, sz = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    lib.cuStreamGetCaptureInfo_v2.argtypes = [
        vp, ctypes.POINTER(ctypes.c_int), vp, ctypes.POINTER(vp), vp, vp]
    lib.cuGraphGetNodes.argtypes = [vp, vp, sz]
    # with the edges' data (CUgraphEdgeData, 8 bytes each): without it CUDA
    # refuses to list edges that carry some (CUDA_ERROR_LOSSY_QUERY)
    lib.cuGraphGetEdges_v2.argtypes = [vp, vp, vp, vp, sz]
    lib.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    return lib


def _check(rc: int, call: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{call}: CUDA driver error {rc}")


class CaptureQuery:
    """The graph being captured on a CUDA stream (its handle, an int), read
    through the CUDA driver's API: its nodes, each node's kind, and their
    order along the graph's edges (ties in the order the API lists them)."""

    def __init__(self, stream: int):
        self.lib = _driver()
        status, graph = ctypes.c_int(), ctypes.c_void_p()
        _check(self.lib.cuStreamGetCaptureInfo_v2(
            stream, ctypes.byref(status), None, ctypes.byref(graph), None,
            None), "cuStreamGetCaptureInfo")
        if status.value != _CAPTURE_ACTIVE or not graph.value:
            raise RuntimeError("capture_layers: the current stream is not "
                               "capturing")
        self.graph = graph

    def nodes(self) -> List[int]:
        n = ctypes.c_size_t(0)
        _check(self.lib.cuGraphGetNodes(self.graph, None, ctypes.byref(n)),
               "cuGraphGetNodes")
        if n.value == 0:
            return []
        arr = (ctypes.c_void_p * n.value)()
        _check(self.lib.cuGraphGetNodes(self.graph, arr, ctypes.byref(n)),
               "cuGraphGetNodes")
        return list(arr[:n.value])

    def kind(self, node: int) -> Optional[str]:
        t = ctypes.c_int()
        _check(self.lib.cuGraphNodeGetType(node, ctypes.byref(t)),
               "cuGraphNodeGetType")
        return _WORK_NODES.get(t.value)

    def edges(self) -> List[tuple]:
        n = ctypes.c_size_t(0)
        _check(self.lib.cuGraphGetEdges_v2(self.graph, None, None, None,
                                           ctypes.byref(n)),
               "cuGraphGetEdges")
        if n.value == 0:
            return []
        src, dst = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
        data = (ctypes.c_uint64 * n.value)()
        _check(self.lib.cuGraphGetEdges_v2(self.graph, src, dst, data,
                                           ctypes.byref(n)),
               "cuGraphGetEdges")
        return list(zip(src[:n.value], dst[:n.value]))

    def order(self) -> List[int]:
        return topological_order(self.nodes(), self.edges())


def topological_order(nodes: List[Any], edges: List[tuple]) -> List[Any]:
    """``nodes`` along ``edges`` (from, to), each node after those it
    depends on, ties in the order of ``nodes``: a chain's only order."""
    index = {n: i for i, n in enumerate(nodes)}
    after: List[List[int]] = [[] for _ in nodes]
    waits = [0] * len(nodes)
    for a, b in edges:
        after[index[a]].append(index[b])
        waits[index[b]] += 1
    ready = [i for i, w in enumerate(waits) if w == 0]
    heapq.heapify(ready)
    out = []
    while ready:
        i = heapq.heappop(ready)
        out.append(nodes[i])
        for j in after[i]:
            waits[j] -= 1
            if waits[j] == 0:
                heapq.heappush(ready, j)
    return out


def track(program) -> None:
    """Keep ``program`` (an ``aot.Program``) among ``programs()`` while it
    lives."""
    _programs[:] = [r for r in _programs if r() is not None]
    _programs.append(weakref.ref(program))


def programs() -> List[dict]:
    """The live programs as plain data (module docstring)."""
    out = []
    for ref in _programs:
        p = ref()
        if p is not None:
            out.append({"tag": p.tag, "nodes": [list(n) for n in p.layer_map],
                        "warmup_s": p.warmup_s, "capture_s": p.capture_s})
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``with device_trace('trace_dir'): run_steps()`` — a torch.profiler
    run (CPU, and CUDA where a card is there) whose Chrome trace is written
    to ``log_dir/<time>.trace.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{time.time_ns()}.trace.json"))


def _load_trace(log_dir: str) -> dict:
    """The newest trace under ``log_dir``, as its JSON."""
    paths = glob.glob(os.path.join(log_dir, "*.trace.json")) + glob.glob(
        os.path.join(log_dir, "*.trace.json.gz"))
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _complete_events(trace: dict) -> List[dict]:
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e]


def load_trace_events(log_dir: str) -> List[dict]:
    """The complete ("X") events of the newest trace under ``log_dir``."""
    return _complete_events(_load_trace(log_dir))


def trace_device(trace: dict) -> str:
    """"cuda" where the profiler saw a card (``deviceProperties``, a device
    event or a runtime call), else "cpu"."""
    cats = {e.get("cat") for e in trace.get("traceEvents", [])}
    if trace.get("deviceProperties") or cats & set(
            DEVICE_CATEGORIES + RUNTIME_CATEGORIES):
        return "cuda"
    return "cpu"


def _outermost(events: List[dict]) -> List[dict]:
    """The events no other event of the same thread contains."""
    out = []
    ends: Dict[tuple, float] = {}
    for e in sorted(events, key=lambda e: (e.get("pid"), e.get("tid"),
                                           e["ts"], -e["dur"])):
        lane = (e.get("pid"), e.get("tid"))
        if e["ts"] >= ends.get(lane, float("-inf")):
            out.append(e)
            ends[lane] = e["ts"] + e["dur"]
    return out


def _scope_of(e: dict, scopes: List[dict]) -> Optional[str]:
    """The innermost scope of the same thread that holds ``e``'s start."""
    best = None
    for s in scopes:
        if (s.get("pid"), s.get("tid")) != (e.get("pid"), e.get("tid")):
            continue
        if s["ts"] <= e["ts"] < s["ts"] + s["dur"] and (
                best is None or s["dur"] <= best["dur"]):
            best = s
    return None if best is None else best["name"]


def _op_kind(name: str) -> str:
    for kind, pattern in OP_KINDS:
        m = re.search(pattern, name, re.IGNORECASE)
        if m:
            return m.group(0) if kind == "msda" else kind
    return "other"


def _correlation(e: dict):
    return e.get("args", {}).get("correlation")


def match_replay(events: List[dict], maps: List[List[List[str]]]
                 ) -> Optional[List[str]]:
    """The scope of each of one replay's device events, from the layer map
    whose work nodes the events are, in start order, by count and kind
    (``EVENT_KINDS``); None where no map matches, or maps that match
    disagree on a scope."""
    kinds = [EVENT_KINDS[e["cat"]] for e in events]
    found = None
    for nodes in maps:
        if len(nodes) == len(kinds) and all(
                n[0] in k for k, n in zip(kinds, nodes)):
            scopes = [n[1] for n in nodes]
            if found is not None and scopes != found:
                return None
            found = scopes
    return found


def summarize_trace(log_dir: str, iterations: int = 1,
                    maps: Optional[List[List[List[str]]]] = None
                    ) -> Dict[str, Any]:
    """Device time of the newest trace under ``log_dir`` by layer scope
    and op kind (module docstring); a trace of the card (``trace_device``)
    without a device event raises. ``maps``: the layer maps its replays
    are read with (default: every live program's).

    Returns {"by_module": {...ms...}, "by_op": {...ms...},
             "total_ms": float, "replays": {"launched": n,
             "attributed": n}}, times per iteration; ``by_module`` leaves
    out the events of replays no map matched.
    """
    trace = _load_trace(log_dir)
    events = _complete_events(trace)
    groups: Dict[Any, List[dict]] = collections.defaultdict(list)
    launched = 0
    if trace_device(trace) == "cuda":
        dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
        scopes = [e for e in events if e.get("cat") == SCOPE_CATEGORIES[0]]
        if not dev:
            raise RuntimeError(
                f"the trace under {log_dir} is of a card but holds no "
                f"kernel, copy or fill: the profiler recorded no device "
                f"activity (was CUDA among its activities?)")
        graph_launches = {_correlation(e) for e in events
                          if e.get("cat") in RUNTIME_CATEGORIES
                          and "GraphLaunch" in e["name"]}
        graph_launches.discard(None)
        launched = len(graph_launches)
        for e in dev:
            if _correlation(e) in graph_launches:
                groups[_correlation(e)].append(e)
    else:
        dev = _outermost([e for e in events if e.get("cat") == "cpu_op"])
        scopes = [e for e in events if e.get("cat") == SCOPE_CATEGORIES[1]]
    scopes = [s for s in scopes if not s["name"].startswith(SPAN_PREFIX)
              and not TORCH_RANGE.search(s["name"])]
    if maps is None:
        maps = [p["nodes"] for p in programs()]
    replayed: Dict[int, Optional[str]] = {}
    attributed = 0
    for group in groups.values():
        group.sort(key=lambda e: e["ts"])
        found = match_replay(group, maps)
        attributed += found is not None
        for i, e in enumerate(group):
            replayed[id(e)] = None if found is None else found[i]
    by_module: collections.Counter = collections.Counter()
    by_op: collections.Counter = collections.Counter()
    for e in dev:
        if id(e) in replayed:
            scope_name = replayed[id(e)]
        else:
            scope_name = _scope_of(e, scopes) or OTHER
        if scope_name is not None:
            key = re.sub(r"_(\d+)(?=/|$)", "_N", scope_name)
            by_module["/".join(key.split("/")[:3])] += e["dur"]
        by_op[_op_kind(e["name"])] += e["dur"]
    scale = 1e3 * iterations
    return {
        "total_ms": sum(e["dur"] for e in dev) / scale,
        "by_module": {k: v / scale for k, v in by_module.most_common()},
        "by_op": {k: v / scale for k, v in by_op.most_common()},
        "replays": {"launched": launched, "attributed": attributed},
    }


def summarize_profile(prof, iterations: int = 1) -> Dict[str, Any]:
    """``summarize_trace`` of a finished ``torch.profiler.profile``, its
    Chrome trace written to a temporary directory and removed."""
    tmp = tempfile.mkdtemp(prefix="egtr-trace-")
    try:
        prof.export_chrome_trace(os.path.join(tmp, "p.trace.json"))
        return summarize_trace(tmp, iterations)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
