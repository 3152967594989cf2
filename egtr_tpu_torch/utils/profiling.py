"""Profiling / tracing utilities (PyTorch port of
``egtr_tpu/utils/profiling.py``).

A trace context around ``torch.profiler`` that writes a Chrome trace, a
summarizer that adds up the device's time by module scope and by op kind,
and a wall-clock step timer.

What counts as the device's work: in a trace of the card, its kernels,
copies and fills (categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``); in
a trace of the CPU, the outermost ``cpu_op`` events of each thread (an op's
inner ops are part of its time). Which one a trace is, the trace says: the
profiler writes ``deviceProperties`` where it could see a card, and the
card's events and runtime calls carry their own categories. A trace of the
card without a device event (CUPTI recorded nothing, or the session traced
the CPU only) is refused rather than read as host time.

``by_module`` reads ``torch.profiler.record_function`` scopes: an event
counts under the innermost scope around it (``gpu_user_annotation`` ranges
on the card, ``user_annotation`` ranges on the CPU), digits after an
underscore folded (``encoder_layer_3`` -> ``encoder_layer_N``) and the name
cut to three "/"-separated parts. The port's models open no such scopes, so
a trace of them alone has an empty ``by_module``; a caller that wants one
wraps its calls in ``record_function``.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import re
import time
from typing import Dict, List, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the host's calls into the card's runtime: the card was in use
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
SCOPE_CATEGORIES = ("gpu_user_annotation", "user_annotation")
# (kind, pattern) of an event's name, any case, the first match wins; the
# hand-written MSDA kernels under their own names
OP_KINDS = (("msda", r"msda_\w+"), ("gemm", r"gemm|matmul|mm\b|linear"),
            ("conv", r"conv"), ("gather", r"gather"),
            ("scatter", r"scatter|index"),
            ("reduce", r"reduce|sum|mean|norm"), ("softmax", r"softmax"),
            ("sort", r"sort|topk"), ("copy", r"copy|memcpy|\bto\b"),
            ("fill", r"memset|fill|zero"),
            ("elementwise", r"elementwise|add|mul|sub|div|where|relu"))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``with device_trace('trace_dir'): run_steps()`` — a torch.profiler
    run (CPU, and CUDA where a card is there) whose Chrome trace is written
    to ``log_dir/<time>.trace.json`` when the block ends."""
    import torch
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


def summarize_trace(log_dir: str, iterations: int = 1
                    ) -> Dict[str, Dict[str, float]]:
    """Device time of the newest trace under ``log_dir`` by module scope
    and op kind (module docstring); a trace of the card
    (``trace_device``) without a device event raises.

    Returns {"by_module": {...ms...}, "by_op": {...ms...},
             "total_ms": float}, each per iteration.
    """
    trace = _load_trace(log_dir)
    events = _complete_events(trace)
    if trace_device(trace) == "cuda":
        dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
        scopes = [e for e in events if e.get("cat") == SCOPE_CATEGORIES[0]]
        if not dev:
            raise RuntimeError(
                f"the trace under {log_dir} is of a card but holds no "
                f"kernel, copy or fill: the profiler recorded no device "
                f"activity (was CUDA among its activities?)")
    else:
        dev = _outermost([e for e in events if e.get("cat") == "cpu_op"])
        scopes = [e for e in events if e.get("cat") == SCOPE_CATEGORIES[1]]
    by_module: collections.Counter = collections.Counter()
    by_op: collections.Counter = collections.Counter()
    for e in dev:
        scope = _scope_of(e, scopes)
        if scope is not None:
            key = re.sub(r"_(\d+)(?=/|$)", "_N", scope)
            by_module["/".join(key.split("/")[:3])] += e["dur"]
        by_op[_op_kind(e["name"])] += e["dur"]
    scale = 1e3 * iterations
    return {
        "total_ms": sum(e["dur"] for e in dev) / scale,
        "by_module": {k: v / scale for k, v in by_module.most_common()},
        "by_op": {k: v / scale for k, v in by_op.most_common()},
    }


class StepTimer:
    """Wall-clock step timing with warmup skip (MetricLogger.log_every
    analog, util/misc.py:199-270). Time on the card is asynchronous: the
    caller synchronizes inside the block for a step's full time."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times = []
        self._t0: Optional[float] = None
        self._n = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self._times.append(dt)

    @property
    def mean_ms(self) -> float:
        return 1e3 * sum(self._times) / max(len(self._times), 1)

    def summary(self) -> Dict[str, float]:
        import numpy as np

        if not self._times:
            return {}
        a = 1e3 * np.asarray(self._times)
        return {"mean_ms": float(a.mean()), "p50_ms": float(np.median(a)),
                "p95_ms": float(np.percentile(a, 95)),
                "steps": len(self._times)}
