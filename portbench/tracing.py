"""Reading a torch.profiler trace of the card: the device's events, its busy
time as the union of their intervals, the idle gaps labelled by the
harness's own host span, and kernel time by name or op kind.

The profiled slice is one ``record_function`` span (``SLICE``) around the
units it times; the harness opens one span per call into a layer of the
program (``input_copy``, ``replay``, ``output_copy``, ``metrics_readback``,
``wait``), so a gap in the card's work is labelled by the span the host was
in when the gap began.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "portbench.slice"
# op kinds by kernel name, the first match wins: a frozen copy of
# egtr_tpu_torch/utils/profiling.py:OP_KINDS, with the convolution names of
# cuDNN's Hopper kernels (implicit-GEMM "fprop", "dgrad", "wgrad") moved
# ahead of "gemm", which their names also hold
OP_KINDS = (("msda", r"msda_\w+"),
            ("conv", r"conv|fprop|dgrad|wgrad|implicit_gemm|xmma_fprop"),
            ("gemm", r"gemm|matmul|mm\b|linear|nvjet|cutlass"),
            ("gather", r"gather"), ("scatter", r"scatter|index"),
            ("reduce", r"reduce|sum|mean|norm"), ("softmax", r"softmax"),
            ("sort", r"sort|topk"), ("copy", r"copy|memcpy|\bto\b"),
            ("fill", r"memset|fill|zero"),
            ("elementwise", r"elementwise|add|mul|sub|div|where|relu"))


def op_kind(name: str) -> str:
    for kind, pattern in OP_KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return "other"


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or name)[:limit]


class Trace:
    """The events of one profiled slice."""

    def __init__(self, events: List[dict]):
        slices = [e for e in events if e.get("name") == SLICE
                  and e.get("cat") == "user_annotation"]
        if not slices:
            raise RuntimeError("the trace holds no profiled slice")
        s = slices[0]
        self.start, self.end = float(s["ts"]), float(s["ts"] + s["dur"])
        self.device = sorted(
            (e for e in events if e.get("cat") in DEVICE_CATEGORIES
             and self.start <= e["ts"] < self.end),
            key=lambda e: e["ts"])
        # the harness's spans follow one another, none inside another
        self.spans = sorted((e for e in events
                             if e.get("cat") == "user_annotation"
                             and e.get("name") != SLICE),
                            key=lambda e: e["ts"])
        self.span_starts = [e["ts"] for e in self.spans]
        if not self.device:
            raise RuntimeError("the trace of the card holds no kernel, copy "
                               "or fill in the profiled slice")

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for e in self.device:
            a, b = e["ts"], min(e["ts"] + e["dur"], self.end)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def gaps(self) -> List[Tuple[float, float]]:
        gaps, at = [], self.start
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.end > at:
            gaps.append((at, self.end))
        return gaps

    def span_at(self, t: float) -> str:
        i = bisect.bisect_right(self.span_starts, t) - 1
        if i >= 0 and t < self.spans[i]["ts"] + self.spans[i]["dur"]:
            return self.spans[i]["name"]
        return "host_between_spans"

    def kernel_us(self, pattern: str) -> Tuple[float, int]:
        """Device µs and launches of the kernels whose name matches."""
        us, n = 0.0, 0
        for e in self.device:
            if e.get("cat") == "kernel" and re.search(pattern, e["name"]):
                us += e["dur"]
                n += 1
        return us, n

    def kind_us(self, kind: str) -> float:
        return sum(e["dur"] for e in self.device
                   if e.get("cat") == "kernel" and op_kind(e["name"]) == kind)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops: Dict[str, float] = {}
        for e in self.device:
            key = short_name(e["name"])
            ops[key] = ops.get(key, 0.0) + e["dur"] / 1e6
        idle: Dict[str, float] = {}
        for a, b in self.gaps():
            key = self.span_at(a)
            idle[key] = idle.get(key, 0.0) + (b - a) / 1e6
        def best(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(idle)}


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        trace = json.load(f)
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e]


@contextlib.contextmanager
def profiled(device_type: str):
    """``with profiled("cuda") as box: ...`` profiles the block; afterwards
    ``box["trace"]`` is its :class:`Trace`. The Chrome trace goes to a
    temporary directory (``TMPDIR``) and is removed once read. The card's
    trace only: a CPU run has no device metrics to read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device_type != "cuda":
        raise RuntimeError("the per-layer metrics are read from the card's "
                           "trace; this run has no card")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    box: Dict[str, Optional[Trace]] = {"trace": None}
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(SLICE):
                yield box
                torch.cuda.synchronize()
        path = os.path.join(tmp, "slice.trace.json")
        prof.export_chrome_trace(path)
        box["trace"] = Trace(load_events(path))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
