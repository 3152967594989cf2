"""The program's own layer scopes and call-path spans, read from a traced
slice: the arithmetic of the per-layer metrics that look inside
``egtr_tpu_torch``'s captured programs.

What the program gives (``egtr_tpu_torch/utils/profiling.py``, its
contract):

- ``profiling.programs()``: one plain dict per live program (``tag``,
  ``nodes``: its layer map, the work nodes of its CUDA graph in execution
  order as ``[kind, scope]`` pairs, ``kind`` one of kernel, memcpy,
  memset; ``warmup_s``; ``capture_s``);
- while a profiler runs, the host spans ``egtr.dispatch/<tag>``,
  ``egtr.copy_in/<tag>``, ``egtr.launch/<tag>`` and ``egtr.copy_out/<tag>``
  around each call of a program (``record_function`` ranges, so on the
  clock of the card's events).

How it is read. The device events of one replay share the correlation id
of the graph launch that issued them; taken in start order, a replay's
events are a program's work nodes where their count and kinds match its
map (a memset or memcpy node may run as a kernel), and each event takes
its node's scope. A replay whose events match no
map (CUPTI dropped a row) or match maps of several tags is left out; each
tag's attributed time is scaled by its replays launched (its
``egtr.launch/<tag>`` spans in the slice) over its replays attributed. The
``egtr.`` prefix marks the program's spans; ``tracing.Trace`` lists them
among the harness's spans, so a gap that begins inside one is labelled by
it in the line's ``breakdown``. On a program without these (an older
checkout) every reader here returns None.
"""

from __future__ import annotations

import bisect
import collections
import sys
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import tracing

PREFIX = "egtr."
LAUNCH = PREFIX + "launch/"
OTHER = "other"
# the layer map's kinds each device event category may be: CUDA runs some
# memset and memcpy nodes of a graph as kernels ("memset32")
EVENT_KINDS = {"kernel": ("kernel", "memset", "memcpy"),
               "gpu_memcpy": ("memcpy",), "gpu_memset": ("memset",)}


def live_programs() -> Optional[List[dict]]:
    """``profiling.programs()`` of the program in this process, or None
    where the program has no such contract."""
    try:
        from egtr_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "programs", None)
    return read() if callable(read) else None


@dataclass
class Replays:
    """The slice's replays read by the programs' layer maps."""
    launched: Dict[str, int] = field(default_factory=dict)
    attributed: Dict[str, int] = field(default_factory=dict)
    # (tag, scope, op kind) -> device µs of the attributed replays
    us: Dict[tuple, float] = field(default_factory=dict)

    def scale(self, tag: str) -> float:
        return self.launched[tag] / self.attributed[tag]

    def scaled_us(self) -> Dict[tuple, float]:
        """Each (scope, op kind)'s µs, each tag's scaled to its launches (a
        tag with no replay attributed is left out)."""
        out: Dict[tuple, float] = collections.defaultdict(float)
        for (tag, scope, kind), us in self.us.items():
            out[(scope, kind)] += us * self.scale(tag)
        return dict(out)

    def scope_us(self, scope: str) -> Optional[float]:
        found = [us for (s, _), us in self.scaled_us().items() if s == scope]
        return sum(found) if found else None

    def share_attributed(self) -> float:
        return sum(self.attributed.values()) / sum(self.launched.values())


def _top_scope(path: str) -> str:
    return path.split("/")[0]


def read_replays(trace, programs: Optional[List[dict]]) -> Optional[Replays]:
    """The slice's replays (module docstring), None where the slice launched
    no program or the process has no programs to read them by."""
    launched = collections.Counter(
        s["name"][len(LAUNCH):] for s in trace.spans
        if s["name"].startswith(LAUNCH))
    if not launched or not programs:
        return None
    maps = [p for p in programs if p["tag"] in launched]
    groups: Dict[object, List[dict]] = collections.defaultdict(list)
    for e in trace.device:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            groups[corr].append(e)
    out = Replays(launched=dict(launched))
    for events in groups.values():
        events.sort(key=lambda e: e["ts"])
        kinds = [EVENT_KINDS[e["cat"]] for e in events]
        found = {}
        for p in maps:
            nodes = p["nodes"]
            if len(nodes) == len(kinds) and all(
                    n[0] in k for k, n in zip(kinds, nodes)):
                found[p["tag"]] = nodes
        if len(found) != 1:
            continue
        (tag, nodes), = found.items()
        out.attributed[tag] = out.attributed.get(tag, 0) + 1
        for e, (_, scope) in zip(events, nodes):
            key = (tag, _top_scope(scope), tracing.op_kind(e["name"]))
            out.us[key] = out.us.get(key, 0.0) + e["dur"]
    return out if out.attributed else None


_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def replays(ctx) -> Optional[Replays]:
    """``read_replays`` of the context's slice, read once a slice (the
    first read prints the table of layers on standard error)."""
    if ctx.trace not in _cache:
        found = read_replays(ctx.trace, live_programs())
        _cache[ctx.trace] = found
        if found is not None:
            print_table(found, ctx.info["slice_images"], call_idle(ctx.trace))
    return _cache[ctx.trace]


def scope_ms_per_image(ctx, scope: str) -> Optional[float]:
    """Device ms a slice image of the replays' work under ``scope``."""
    found = replays(ctx)
    images = ctx.info["slice_images"]
    if found is None or not images:
        return None
    us = found.scope_us(scope)
    return None if us is None else us / 1e3 / images


def layer_reader(scope: str):
    """A metric's ``read``: ``scope_ms_per_image`` of ``scope``."""
    def read(ctx) -> Optional[float]:
        return scope_ms_per_image(ctx, scope)
    return read


def call_idle(trace) -> Dict[str, float]:
    """Idle µs of the card while the host is in one of the program's
    spans, by span name: each gap's µs split over the spans it overlaps,
    the innermost (shortest) first."""
    spans = sorted((s for s in trace.spans if s["name"].startswith(PREFIX)),
                   key=lambda s: s["ts"])
    if not spans:
        return {}
    starts = [s["ts"] for s in spans]
    longest = max(s["dur"] for s in spans)
    out: Dict[str, float] = collections.defaultdict(float)
    for a, b in trace.gaps():
        i = bisect.bisect_left(starts, b)
        near = []
        while i > 0 and starts[i - 1] >= a - longest:
            i -= 1
            s = spans[i]
            if s["ts"] < b and s["ts"] + s["dur"] > a:
                near.append(s)
        if not near:
            continue
        cuts = sorted({a, b} | {min(max(t, a), b) for s in near
                                for t in (s["ts"], s["ts"] + s["dur"])})
        for lo, hi in zip(cuts, cuts[1:]):
            holding = [s for s in near
                       if s["ts"] <= lo and s["ts"] + s["dur"] >= hi]
            if holding and hi > lo:
                inner = min(holding, key=lambda s: s["dur"])
                out[inner["name"]] += hi - lo
    return dict(out)


def call_idle_share(ctx) -> Optional[float]:
    """% of the slice in which the card is idle while the host is in one
    of the program's spans."""
    spans = [s for s in ctx.trace.spans if s["name"].startswith(PREFIX)]
    window = ctx.trace.window_us
    if not spans or window <= 0:
        return None
    return 100.0 * sum(call_idle(ctx.trace).values()) / window


def graph_nodes_per_image(ctx) -> Optional[float]:
    """Work nodes of the programs the slice replayed, each tag's map
    times its launches, over the slice's images."""
    programs = live_programs()
    images = ctx.info["slice_images"]
    launched = collections.Counter(
        s["name"][len(LAUNCH):] for s in ctx.trace.spans
        if s["name"].startswith(LAUNCH))
    if not programs or not launched or not images:
        return None
    nodes = 0
    for tag, n in launched.items():
        sizes = {len(p["nodes"]) for p in programs if p["tag"] == tag}
        if len(sizes) != 1:
            return None
        nodes += n * sizes.pop()
    return nodes / images


def setup_seconds(key: str) -> Optional[float]:
    """``warmup_s`` or ``capture_s`` summed over the live programs."""
    programs = live_programs()
    if not programs:
        return None
    return sum(p[key] for p in programs)


def print_table(found: Replays, images: int, idle: Dict[str, float],
                out=None) -> None:
    """Device ms a slice image by layer scope and op kind, the attributed
    share of the replays, and the card's idle µs in the program's spans."""
    out = out or sys.stderr
    by = found.scaled_us()
    scopes = sorted({s for s, _ in by},
                    key=lambda s: -sum(v for (t, _), v in by.items()
                                       if t == s))
    kinds = sorted({k for _, k in by},
                   key=lambda k: -sum(v for (_, t), v in by.items() if t == k))
    total = sum(by.values())
    print(f"[layers] replays attributed: {sum(found.attributed.values())} "
          f"of {sum(found.launched.values())} "
          f"({100 * found.share_attributed():.1f}%); device ms an image "
          f"{total / 1e3 / images:.4f}", file=out)
    print("[layers] " + " ".join(["scope".ljust(14)] + [k[:11].rjust(11)
                                                        for k in kinds]
                                 + ["total".rjust(9)]), file=out)
    for s in scopes:
        cells = [by.get((s, k), 0.0) / 1e3 / images for k in kinds]
        print("[layers] " + " ".join([s[:14].ljust(14)]
                                     + [f"{c:11.4f}" for c in cells]
                                     + [f"{sum(cells):9.4f}"]), file=out)
    for name, us in sorted(idle.items(), key=lambda kv: -kv[1]):
        print(f"[layers] idle in {name}: {us / 1e3:.3f} ms", file=out)
