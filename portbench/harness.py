"""One run of one cell: spec, set-up, measured window, traced slice, output
check and the result line.

The cell, its configuration and its traffic are found by name: the cell's
entry in ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``workloads/<name>.json``), whose ``mode`` names the
module under ``modes/`` that drives it; each per-layer metric is the
``read`` function of ``metrics/<name>.py``. Adding a cell, a configuration,
a traffic mix or a metric adds files and entries and edits none.

A mode module defines ``Runner(spec, seed, device, setup)`` with:

- ``setup()``: builds the program, its inputs and weights, and warms up
  every shape the traffic uses (timed by parts into ``setup``);
- ``unit() -> images``: one timed unit (a request, a batch, a step), the
  images whose results reached the host in it;
- ``drain() -> images``: the results still in flight when the window ends;
- ``end_to_end(window_s, images, units) -> {metric: value}``;
- ``slice_info() -> dict`` for the metric readers (images, steps, model
  FLOPs a unit);
- ``check() -> [(name, value, limit)]``: after the window, the program's
  state freed, the comparison with the plain reference.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "egtr_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Spec:
    """A cell as ``BENCHMARK.json`` and its files give it."""
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str] = field(default_factory=dict)


def benchmark_json(root: str = REPO) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts: str) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def load_spec(cell: str, bench: Optional[dict] = None) -> Spec:
    bench = benchmark_json() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell not in entries:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json "
                       f"({sorted(entries)})")
    w = entries[cell]
    e2e = [m["name"] for m in bench["end_to_end"]
           if m.get("workloads") is None or cell in m["workloads"]]
    reported = set(e2e)
    per_layer = [m["name"] for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    return Spec(cell, w["config"], w["traffic"], w["chips"],
                load_json("configs", w["config"] + ".json"),
                load_json("workloads", w["traffic"] + ".json"),
                e2e, per_layer, units)


def load_module(kind: str, name: str):
    """``modes/<name>.py`` or ``metrics/<name>.py`` by path (a metric's
    name may hold dots)."""
    path = os.path.join(ROOT, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, the
    whole name compared (``egtr_tpu_torch`` is not ``egtr_tpu``)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Setup:
    """Set-up time by part, printed as each part ends."""

    def __init__(self):
        self.parts: Dict[str, float] = {}
        self.excluded = 0.0

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.parts[name] = self.parts.get(name, 0.0) + dt
        log(f"[setup] {name}: {dt:.3f} s")

    @contextlib.contextmanager
    def exclude(self):
        """Time spent in set-up on the output check's snapshots, which is
        not the program's set-up."""
        t0 = time.perf_counter()
        yield
        self.excluded += time.perf_counter() - t0


@dataclass
class WindowStats:
    seconds: float = 0.0
    images: int = 0
    units: int = 0
    untraced_seconds: float = 0.0
    untraced_images: int = 0


def run_window(runner, seconds: float, trace: bool, device_type: str,
               slice_units: int):
    """Units back to back for ``seconds``; with ``trace`` the last
    ``slice_units`` run under the profiler. Returns (stats, trace or
    None)."""
    import torch

    from . import tracing

    stats = WindowStats()
    t0 = time.perf_counter()
    per_unit = None
    budget = seconds
    while True:
        now = time.perf_counter() - t0
        if trace and per_unit is not None:
            # stop the untraced part so that the slice ends near the window
            budget = max(seconds - 1.5 * slice_units * per_unit, 0.5 * seconds)
        if now >= budget and stats.units > 0:
            break
        stats.images += runner.unit()
        stats.units += 1
        per_unit = (time.perf_counter() - t0) / stats.units
    stats.images += runner.drain()
    untraced_end = time.perf_counter()
    stats.untraced_seconds = untraced_end - t0
    stats.untraced_images = stats.images
    box = None
    if trace:
        with tracing.profiled(device_type) as box:
            for _ in range(slice_units):
                stats.images += runner.unit()
                stats.units += 1
            stats.images += runner.drain()
    stats.seconds = time.perf_counter() - t0
    if device_type == "cuda":
        torch.cuda.synchronize()
    return stats, (box["trace"] if box else None)


@dataclass
class MetricContext:
    """What a per-layer metric's reader may read."""
    spec: Spec
    trace: object
    stats: WindowStats
    info: dict


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return json.dumps(out)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             spec: Optional[Spec] = None) -> int:
    """One run; prints the result line on stdout. ``device`` "cpu" and
    ``spec`` serve the CPU tests (a tiny configuration). Returns the exit
    code."""
    setup = Setup()
    setup.parts["interpreter"] = time.perf_counter() - t_start
    log(f"[setup] interpreter: {setup.parts['interpreter']:.3f} s (the "
        "process's start to the harness)")
    with setup.part("import"):
        import torch
    spec = load_spec(cell) if spec is None else spec
    if device == "cuda":
        if not torch.cuda.is_available():
            log("portbench: CUDA is not available; the benchmark runs on "
                "the card only")
            return 3
        if torch.cuda.device_count() < spec.chips:
            log(f"portbench: the cell asks for {spec.chips} cards, "
                f"{torch.cuda.device_count()} found")
            return 3
    with setup.part("import_mode"):
        mode = load_module("modes", spec.traffic["mode"])
    if device == "cuda":
        with setup.part("cuda_context"):
            torch.cuda.init()
            torch.zeros(1, device=device)
            torch.cuda.synchronize()
    runner = mode.Runner(spec, seed, torch.device(device), setup)
    runner.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start - setup.excluded
    log(f"[setup] total: {setup_s:.3f} s (the check's snapshots "
        f"{setup.excluded:.3f} s left out)")
    stats, tr = run_window(runner, seconds, trace, device,
                           int(spec.traffic.get("trace_units", 4)))
    log(f"[window] {stats.seconds:.3f} s, {stats.units} units, "
        f"{stats.images} images")
    if device == "cuda":
        peak = torch.cuda.max_memory_allocated()
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": spec.chips, "memory_peak_bytes": int(peak)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    found = forbidden_modules()
    if found:
        log(f"portbench: the process holds {found}: the benchmark may not "
            "load JAX or the JAX package")
        return 4
    breakdown = None
    if trace:
        metrics = {}
        info = runner.slice_info()
        units = int(spec.traffic.get("trace_units", 4))
        info["slice_images"] = stats.images - stats.untraced_images
        info["slice_steps"] = units if info["train"] else 0
        ctx = MetricContext(spec, tr, stats, info)
        for name in spec.per_layer:
            value = load_module("metrics", name).read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": spec.units[name]}
        dev["busy_s"] = tr.busy_us() / 1e6
        dev["window_s"] = tr.window_us / 1e6
        breakdown = tr.breakdown()
    else:
        e2e = runner.end_to_end(stats.seconds, stats.images, stats.units)
        metrics = {"setup_s": {"value": setup_s, "unit": spec.units["setup_s"]}}
        for name in spec.end_to_end:
            if name == "setup_s":
                continue
            metrics[name] = {"value": e2e[name], "unit": spec.units[name]}
    failed = runner.failed()
    del runner.program_state
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = runner.check()
    correct = failed == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)
    for name, value, limit in checks:
        log(f"check {name}: {value!r} limit {limit!r}")
    log(f"correct: {correct}")
    print(result_line(correct, stats.units, failed, metrics, dev, checks,
                      breakdown), flush=True)
    return 0
