"""Time the exact MSDA kernels K1 (msda_fwd), K2 (msda_bwd_rows), K3
(msda_bwd_value) and K4 (msda_fwd_q, int8 stage 1), and the banded kernels
K5 (msda_fwd_win), K6 (msda_fwd_win_pp), K7 (msda_bwd_win_rows), K8
(msda_bwd_win_rows_pp), K9 (msda_bwd_win_value) and K10
(msda_bwd_win_value_pp), and the batched-P forward K11 (msda_fwd_bp), on
the card, at the calls that chip_smoke.py holds them to their plain
versions; and the trunk's frozen-BN epilogue (FBN, ``frozen_bn``) at each
of its sites.

    python egtr_tpu_torch/scripts/time_msda_kernels.py [--root DIR]
        [--label NAME] [--out FILE] [--ptxas] [--variant NAME]
        [--kernels K1,K2,K3,K4,K5,K6,K7,K8,K9,K10,K11,FBN]

Calls: chip_smoke.py's ``exact_calls()`` (encoder and decoder calls,
uniform and raster locations, the decoder call at batch 1 and 2, float32
and bfloat16) in the serving bucket 608x1008 (K1) and the training bucket
800x1344 (K1, K2 and K3); K3 also at the adaptation step's two calls
(608x1008, batch 4: the encoder call on its one exact level, the decoder
call); K4 at chip_smoke.py's ``Q_CALLS`` in the serving bucket (the served
encoder call on the one exact level, the int8 encoder call on every level,
both Q = S with raster locations, and the decoder call at batch 1 and 2),
with float32 and bfloat16 weights, as phase 5 makes them; for K7-K10 the
three banded levels of the adaptation's encoder call (608x1008, window 16,
raster locations, batch 4, float32 and bfloat16), as chip_smoke.py's phase
12 makes them (K7 and K9 with one band per tile); for K5 and K6 the three
banded levels of the served encoder call (608x1008, window 16, raster
locations, batch 1, in float32, bfloat16 and int8; bfloat16 also at batch
4), as phase 6 makes them (K5 with one band per tile); K11 in each form
at the calls of the kernel that computes the same function, beside that
kernel on the same inputs: float32 and bfloat16 at ``exact_calls()`` in
both buckets and at the encoder call at batch 2, int8 at ``q_calls()`` and
at the served encoder call at batch 2, and bfloat16 with float32 out on the
served encoder call's exact level (a windowed call's) at batch 1 and 2.
Per call and kernel it prints one JSON line:
- ``ms``: CUDA events around ITERS calls of the wrapper (what
  chip_smoke.py reports: at the decoder calls the host's wrapper time
  hides the kernel's);
- ``graph_ms``: the same calls captured in a CUDA graph and replayed, the
  wrapper's device time per call (with K3's zeroing and cast, K8's zeroed
  outputs);
- ``host_us``: the wrapper's host time per call (the time to queue ITERS
  calls, the card not waited for);
- ``output_sha256``: a digest of the output's bytes (K1-K4 and K11; K2 its
  two gradients; K3's varies run to run), so that two checkouts' runs on
  the same seeded inputs compare bit for bit;
- ``bit_equal``: two runs on the same inputs give the same bits; for K3,
  whose float32 atomics add in no fixed order, ``run_to_run_max_abs_diff``
  beside it;
- K3: ``zero_graph_ms`` and ``cast_graph_ms``, the device time of zeroing
  its float32 buffer and of the cast to the value dtype alone (the kernel's
  share is the rest of ``graph_ms``); where the checkout has
  ``msda_cuda.value_geometry``, ``private`` (the levels kept in shared
  memory) and ``graph_ms_by_private_bytes`` (the device time with at most
  0 or 200 KiB of them: every level through global memory, or the two
  coarsest) and ``graph_ms_by_private_threads`` (with blocks of 512 or
  1024 threads where a level is kept);
- K5-K10: one line per banded level and one that sums them (``level``
  "sum"), with the level's clamped share of the in-image samples;
- K5 and K7: where the checkout runs them through K6's and K8's kernels,
  ``bit_equal_to_k6_broadcast`` and ``bit_equal_to_k8_broadcast`` (against
  the per-point kernel given the tile bands broadcast over the points);
- K4: its bound; where the checkout has ``msda_cuda.q_geometry``, its
  ``geometry`` and ``graph_ms_by_vec_bytes`` (the device time with corner
  loads of at most 8 and 16 bytes a lane);
- K11: ``same_kernel`` (K1's ``msda_fwd`` or K4's ``msda_fwd_q``), its
  ``same_ms`` and ``same_graph_ms`` at the call, ``bit_equal_to_same``
  and ``max_abs_diff_to_same``, and the call's bound;
- K9 and K10: ``run_to_run_max_abs_diff``; ``zero_graph_ms`` and
  ``copy_graph_ms``, the device time of zeroing a float32 [B, h*w, H, D]
  buffer and of copying it into the level's slice of the layer's value
  gradient, which a wrapper that returns a fresh buffer costs the path
  (``msda._windowed_backward``) on top of its own ``graph_ms``;
  ``path_graph_ms``, the device time the path pays a level (the wrapper and,
  where it returns a fresh buffer, that buffer added into the slice, as
  ``msda_cuda.msda_bwd_win`` did for K9; where the wrapper takes ``out``, it
  adds into that slice and ``graph_ms`` is all); K9 also
  ``max_abs_diff_to_k10_broadcast`` (against K10 given K9's tile bands
  broadcast over the points);
- where the checkout has ``msda_cuda.launch_geometry``: ``geometry_us``
  (the host time per call of what the wrapper does for the launch
  geometry: the pointers' alignment, the cached geometry, its int array);
  for K1 also ``rows_per_warp`` (the rows a warp walks),
  ``graph_ms_by_rows_per_warp`` (the device time with a warp walking 1,
  2, 4 and 8 rows) and ``graph_ms_direct`` (the device time with each
  lane reading its sample's location and weight itself, no hand-out).

FBN: chip_smoke.py's ``frozen_bn_rows``, at each of the 49 epilogue sites
of a bfloat16 ResNet-50 forward (``models/epilogue_sites.py``: the
bfloat16 stem, float32 blocks, channels_last) in the serving bucket
(608x1008, batch 1) and the offline one (800x1344, batch 8), on seeded maps
and norm statistics, one line a site: ``graph_ms`` (the kernel into a map
of its own) and ``plain_ms`` (``backbone.frozen_bn_act_plain``, the chain
of PyTorch kernels it replaces), both in a CUDA graph under
``torch.inference_mode``; its bytes (each map read or written once, the
norms' vectors once) and their time at 3.35 TB/s (``bound_ms``),
``times_bound``, ``in_l2`` (the site's bytes fit the 50 MB L2, so that
repeated calls find them warm), and ``bit_equal`` (the kernel's output
against the chain's, bit for bit; ``bit_equal_in_place`` written into x);
then one line a bucket (``site`` "trunk") with the sums.

``--root DIR`` imports ``egtr_tpu_torch`` from DIR instead of this
checkout, so that another version of the kernels (a ``git archive`` of a
parent commit, unpacked under the git-ignored ``build/``) is timed by the
same code. Run the two in turns in one call on one card (parent, change,
change, parent) and compare only there. ``--ptxas`` first prints what
``nvcc -Xptxas -v`` says of the sources (registers, spills).
``--kernels`` times a subset (default all eleven). ``--variant NAME``
times the kernels of a copy of DIR's ``egtr_tpu_torch`` (under DIR's
``build/``) whose source is edited as ``VARIANTS[NAME]`` says: for K4
(``msda_fwd_q.cu``), ``no_gather_old`` and ``no_gather`` replace each
corner load (of the layout before the redesign, one warp a row with lanes
over D, or of this one) by a small integer from the corner's column or
token, so that the time left is the walk, the geometry and the arithmetic;
``index64`` does the row index math (batch, head, a sample's entries) in 64
bits; ``bounds_free`` leaves the registers a thread to the compiler,
``bounds_4`` asks for four blocks of 256 threads an SM (at most 64
registers a thread) where the kernel asks for three; for K1
(``msda_fwd.cu``), ``k1_bounds_4`` asks for four blocks an SM and
``k1_unroll_1`` issues one pass's loads at a time.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict, replace
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[2]
ITERS = 100  # wrapper calls per CUDA-event timing, as chip_smoke.py's K1
WALKS = (1, 2, 4, 8)
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10",
           "K11", "FBN")
# --variant: edits of one source, (text, replacement) pairs that must each
# match, by name: (source, edits). K4's no-gather variants replace each
# corner load by an integer the compiler cannot fold away.
VARIANTS = {
    "no_gather_old": ("msda_fwd_q.cu", (
        ("r[(long)x0 * row]", "(x0 & 7)"),
        ("r[(long)(x0 + 1) * row]", "((x0 + 1) & 7)"))),
    "no_gather": ("msda_fwd_q.cu", (
        ("q.a0.load(p0)", "q.a0.w[0] = (uint32_t)token"),
        ("q.a1.load(p0 + sa)", "q.a1.w[0] = (uint32_t)(token + 1)"),
        ("q.b0.load(p0 + sb)", "q.b0.w[0] = (uint32_t)(token + w)"),
        ("q.b1.load(p0 + sa + sb)", "q.b1.w[0] = (uint32_t)(token + w + 1)"))),
    "index64": ("msda_fwd_q.cu", (
        ("const int first = (int)first_l, rows = (int)n_rows;",
         "const long first = first_l, rows = n_rows;"),
        ("const int row = first + (slot", "const long row = first + (slot"),
        ("const int mine_row = first", "const long mine_row = first"),
        ("const int mine_bh = mine_row", "const long mine_bh = mine_row"),
        ("int row, int bh, int j, int L, int P)",
         "long row, long bh, int j, int L, int P)"),
        ("const int i = (row * L + lid) * P + p;",
         "const long i = (row * L + lid) * P + p;"))),
    "bounds_free": ("msda_fwd_q.cu", (
        ("__launch_bounds__(256, 3)\nmsda_fwd_q_kernel",
         "__launch_bounds__(256)\nmsda_fwd_q_kernel"),)),
    "bounds_4": ("msda_fwd_q.cu", (
        ("__launch_bounds__(256, 3)\nmsda_fwd_q_kernel",
         "__launch_bounds__(256, 4)\nmsda_fwd_q_kernel"),)),
    # K1: four blocks of 256 threads an SM (at most 64 registers a thread)
    # where the compiler takes 80, or one pass's loads at a time
    "k1_bounds_4": ("msda_fwd.cu", (
        ("__launch_bounds__(256)\nmsda_fwd_kernel",
         "__launch_bounds__(256, 4)\nmsda_fwd_kernel"),)),
    "k1_unroll_1": ("msda_fwd.cu", (
        ('#include "msda_geom.cuh"\n',
         '#include "msda_geom.cuh"\n#undef MSDA_UNROLL\n#define MSDA_UNROLL 1\n'),)),
}
# K4's widest corner loads timed by graph_ms_by_vec_bytes
K4_VEC_BYTES = (8, 16)
# K3's shared-memory caps timed beside the default (msda_cuda.PRIVATE_BYTES,
# the coarsest level): none, and the two coarsest (200 KiB)
PRIVATE_CAPS = (0, 200 * 1024)


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose egtr_tpu_torch is timed")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--out", default=None, help="append the JSON lines here")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ",".join(KERNELS))
    ap.add_argument("--variant", choices=sorted(VARIANTS),
                    help="time a copy whose source is edited so")
    return ap.parse_args(argv)


def variant_copy(root: Path, name: str) -> Path:
    """A copy of ``root``'s egtr_tpu_torch under ``root/build`` whose
    source is edited as VARIANTS[name] says; returns the copy's root."""
    import shutil
    source, edits = VARIANTS[name]
    out = root / "build" / f"variant_{name}"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(root / "egtr_tpu_torch", out / "egtr_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = out / "egtr_tpu_torch" / "csrc" / source
    text = src.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"--variant {name}: {src} does not hold {old!r}")
        text = text.replace(old, new)
    src.write_text(text)
    return out


def _chip_smoke():
    """This checkout's chip_smoke.py, for its calls, inputs and timers; the
    ``egtr_tpu_torch`` it imports is the one first on sys.path (--root)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ptxas_report(root: Path, nvcc: str) -> None:
    for name in ("msda_fwd.cu", "msda_bwd.cu", "msda_fwd_q.cu",
                 "msda_fwd_win.cu", "msda_bwd_win.cu", "msda_fwd_bp.cu",
                 "frozen_bn.cu"):
        src = root / "egtr_tpu_torch" / "csrc" / name
        if not src.exists():
            continue
        with tempfile.TemporaryDirectory() as tmp:
            out = subprocess.run(
                [nvcc, "-gencode",
                 "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xptxas", "-v", "-cubin", "-o", f"{tmp}/k.cubin", str(src)],
                capture_output=True, text=True)
        print(f"ptxas {name}:\n{out.stdout}{out.stderr}", flush=True)
        if out.returncode:
            raise SystemExit(f"nvcc failed on {src}")


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes: two checkouts' outputs on the same
    seeded inputs compare bit for bit across processes."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def host_us(fn, torch) -> float:
    """Microseconds of host time per wrapper call: ITERS calls queued."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(ITERS):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / ITERS * 1e6


def geometry_us(msda_cuda, rows, D, n_samples, tensors, walk,
                n=10000) -> float:
    """Microseconds per call of the wrapper's launch-geometry steps."""
    es = tensors[0].element_size()
    start = time.perf_counter()
    for _ in range(n):
        msda_cuda.launch_geometry(rows, D, n_samples, n_samples, es,
                                  msda_cuda.pointer_alignment(*tensors),
                                  walk).c_array
    return (time.perf_counter() - start) / n * 1e6


def by_rows_per_warp(msda_cuda, smoke, fn) -> dict:
    """The kernel's device time with a warp walking each of WALKS rows."""
    out = {}
    for walk in WALKS:
        msda_cuda.launch_geometry.cache_clear()
        with mock.patch.object(msda_cuda, "rows_per_warp_for",
                               lambda rows: walk):
            out[walk] = smoke.graph_ms(fn)
    msda_cuda.launch_geometry.cache_clear()
    return out


def direct_ms(msda_cuda, smoke, fn) -> float:
    """The kernel's device time with the hand-out off: each lane reads its
    sample's location and weight from memory."""
    real = msda_cuda.launch_geometry
    with mock.patch.object(msda_cuda, "launch_geometry",
                           lambda *a: replace(real(*a), handout=0)):
        return smoke.graph_ms(fn)


def patched_graph_ms(msda_cuda, smoke, fn, name, values) -> dict:
    """K3's device time with msda_cuda.<name> set to each of ``values``
    (its launch worked out anew each time)."""
    out = {}
    for v in values:
        msda_cuda.value_geometry.cache_clear()
        with mock.patch.object(msda_cuda, name, v):
            out[v] = smoke.graph_ms(fn)
    msda_cuda.value_geometry.cache_clear()
    return out


def value_split(msda_cuda, smoke, fn, first, second, value, shapes, Q,
                g) -> dict:
    """K3's run-to-run spread, its zeroing and cast alone in a CUDA graph,
    and with value_geometry (this design) the levels it keeps in shared
    memory and the device time at other caps and block sizes."""
    import torch
    B, S, H, D = value.shape
    buf = torch.zeros((B, S, H, D), dtype=torch.float32, device=value.device)
    out = {"run_to_run_max_abs_diff":
           (first.float() - second.float()).abs().max().item(),
           "zero_graph_ms": smoke.graph_ms(lambda: torch.zeros(
               (B, S, H, D), dtype=torch.float32, device=value.device)),
           "cast_graph_ms": smoke.graph_ms(lambda: buf.to(value.dtype))}
    if hasattr(msda_cuda, "value_geometry"):
        geom = msda_cuda.value_geometry(
            B, Q, H, D, tuple(shapes), smoke.P, value.element_size(),
            msda_cuda.pointer_alignment(g))
        out["private"] = [k for k in range(len(shapes))
                          if geom.private >> k & 1]
        out["query_chunks"] = geom.query_chunks
        out["graph_ms_by_private_bytes"] = patched_graph_ms(
            msda_cuda, smoke, fn, "PRIVATE_BYTES", PRIVATE_CAPS)
        out["graph_ms_by_private_threads"] = patched_graph_ms(
            msda_cuda, smoke, fn, "PRIVATE_THREADS", (512, 1024))
    return out


def adaptation_value_rows(msda_cuda, smoke, torch) -> list:
    """K3 at the adaptation step's two calls (608x1008, batch 4): the
    encoder call on its one exact level (raster locations, float32 out, as
    ``msda._windowed_backward`` calls it) and the decoder call (Q = 200,
    every level), in float32 and bfloat16."""
    from egtr_tpu_torch.models.detr import level_shapes
    from egtr_tpu_torch.scripts import perf_train_step
    shapes = level_shapes(perf_train_step.ADAPT_HW, smoke.L)
    batch = perf_train_step.ADAPT_BATCH
    exact = tuple(l for l, (h, _) in enumerate(shapes) if h <= smoke.WINDOW)
    out = []
    for n, dtype in enumerate((torch.float32, torch.bfloat16)):
        for call in ("encoder_raster", "decoder"):
            Q, value, loc, aw = smoke.exact_call_inputs(shapes, call, batch,
                                                        dtype, 720 + n)
            g = smoke.grad_output(batch, Q, dtype, 730 + n)
            kw = (dict(levels=exact, out_dtype=torch.float32)
                  if call == "encoder_raster" else {})
            fn = lambda: (msda_cuda.msda_bwd_value(value, shapes, loc, aw, g,
                                                   **kw),)
            first, second = fn(), fn()
            row = {"kernel": "msda_bwd_value", "bucket": "adaptation",
                   "call": call, "Q": Q, "batch": batch,
                   "levels": list(kw.get("levels", range(len(shapes)))),
                   "dtype": str(dtype)[6:], "ms": smoke.cuda_ms(fn, ITERS),
                   "graph_ms": smoke.graph_ms(fn),
                   "host_us": host_us(fn, torch),
                   "run_to_run_max_abs_diff": (first[0].float()
                                               - second[0].float()).abs()
                   .max().item()}
            if hasattr(msda_cuda, "value_geometry"):
                row["graph_ms_by_private_bytes"] = patched_graph_ms(
                    msda_cuda, smoke, fn, "PRIVATE_BYTES", PRIVATE_CAPS)
            out.append(row)
    return out


def _level_rows(smoke, kernel, call, batch, dtype, shapes, make,
                time_level):
    """One line per banded level of ``shapes`` and one summing them:
    ``make(lid)`` gives the level's (args, clamped share), ``time_level``
    the line's timings."""
    total = {"kernel": kernel, "call": call, "level": "sum", "batch": batch,
             "dtype": dtype}
    out = []
    for lid, (h, _) in enumerate(shapes):
        if h <= smoke.WINDOW:
            continue
        args, clamped = make(lid)
        row = {"kernel": kernel, "call": call, "level": lid, "batch": batch,
               "dtype": dtype, "clamped_share": clamped, **time_level(args)}
        out.append(row)
        for key, v in row.items():
            if key in ("level", "batch", "clamped_share"):
                continue
            if isinstance(v, bool):
                total[key] = total.get(key, True) and v
            elif isinstance(v, float):
                if "max_abs_diff" in key:
                    total[key] = max(total.get(key, 0.0), v)
                else:
                    total[key] = total.get(key, 0.0) + v
    return out + [total]


def banded_rows(msda_cuda, smoke, torch, per_point=True) -> list:
    """K8 (``per_point``) or K7 on the three banded levels of the
    adaptation's encoder call, per level and summed, in float32 and
    bfloat16. K7 also against K8 given its tile bands broadcast over the
    points, where the checkout runs K7 through K8's kernel (its wrapper
    passes a band-table stride)."""
    from egtr_tpu_torch.models.detr import level_shapes
    from egtr_tpu_torch.scripts import perf_train_step
    shapes = level_shapes(perf_train_step.ADAPT_HW, smoke.L)
    batch = perf_train_step.ADAPT_BATCH
    name = "msda_bwd_win_rows_pp" if per_point else "msda_bwd_win_rows"
    kernel = getattr(msda_cuda, name)
    through_k8 = (msda_cuda._FUNCTIONS["msda_bwd_win_rows"]
                  == msda_cuda._FUNCTIONS["msda_bwd_win_rows_pp"])
    out = []
    for n, dtype in enumerate((torch.float32, torch.bfloat16)):
        value, loc, aw = smoke.raster_inputs(shapes, dtype, seed=700 + n,
                                             batch=batch)
        g = smoke.grad_output(batch, value.shape[1], dtype, 710 + n)

        def time_level(args):
            fn = lambda: kernel(*args)
            first, second = fn(), fn()
            row = {"ms": smoke.cuda_ms(fn, ITERS),
                   "graph_ms": smoke.graph_ms(fn),
                   "host_us": host_us(fn, torch),
                   "bit_equal": all(torch.equal(x, y)
                                    for x, y in zip(first, second))}
            if not per_point and through_k8:
                wide = smoke.broadcast_bands(args[1], args[2].shape[2])
                row["bit_equal_to_k8_broadcast"] = all(
                    torch.equal(x, y) for x, y in zip(
                        first, msda_cuda.msda_bwd_win_rows_pp(
                            args[0], wide, *args[2:])))
            return row

        out += _level_rows(
            smoke, name, "adaptation", batch, str(dtype)[6:],
            shapes, lambda lid: smoke._banded_bwd_args(
                value, loc, aw, g, shapes, lid, per_point), time_level)
    return out


def q_rows(msda_cuda, smoke, torch) -> list:
    """K4 at every call of chip_smoke's Q_CALLS in the serving bucket, with
    float32 and bfloat16 weights: one line per call, with the call's bound;
    where the checkout has ``q_geometry``, the device time at each of
    K4_VEC_BYTES."""
    from egtr_tpu_torch import infer
    from egtr_tpu_torch.models.detr import level_shapes
    from egtr_tpu_torch.ops import msda
    shapes = level_shapes(infer.BUCKET_HW, smoke.L)
    starts = [0]
    for h, w in shapes:
        starts.append(starts[-1] + h * w)
    out = []
    for n, (call, batch, dtype) in enumerate(smoke.q_calls()):
        Q, levels, value, loc, aw = smoke.q_call_inputs(shapes, call, batch,
                                                        dtype, n)
        vq, scale = msda.quantize_levels(value, shapes)
        args = (vq, scale, shapes, loc, aw)
        fn = lambda: msda_cuda.msda_fwd_q(*args, levels=levels)
        first, second = fn(), fn()
        moved = [t for l in levels for t in (
            vq[:, starts[l]:starts[l + 1]], scale[..., l], loc[:, :, :, l],
            aw[:, :, :, l])]
        bound_ms, bound_by = smoke.bound((*moved, first),
                                         aw[:, :, :, :len(levels)])
        row = {"kernel": "msda_fwd_q", "bucket": "serving", "call": call,
               "Q": Q, "batch": batch, "levels": list(levels),
               "dtype": str(dtype)[6:], "ms": smoke.cuda_ms(fn, ITERS),
               "graph_ms": smoke.graph_ms(fn),
               "host_us": host_us(fn, torch),
               "bit_equal": torch.equal(first, second),
               "output_sha256": digest(first),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if hasattr(msda_cuda, "q_geometry"):
            geom = msda_cuda.q_geometry(
                batch * Q * smoke.H, smoke.D, len(levels) * smoke.P,
                msda_cuda.pointer_alignment(vq))
            row["geometry"] = asdict(geom)
            by = {}
            for cap in K4_VEC_BYTES:
                msda_cuda.q_geometry.cache_clear()
                with mock.patch.object(msda_cuda, "Q_VEC_BYTES", cap):
                    by[cap] = smoke.graph_ms(fn)
                    # bit-equal at every width: one warp, one order
                    row["bit_equal"] &= torch.equal(first, fn())
            msda_cuda.q_geometry.cache_clear()
            row["graph_ms_by_vec_bytes"] = by
        out.append(row)
    return out


def banded_value_rows(msda_cuda, smoke, torch, per_point=True) -> list:
    """K10 (``per_point``) or K9 on the three banded levels of the
    adaptation's encoder call, per level and summed, in float32 and
    bfloat16: into the level's slice of a zeroed [B, S, H, D] gradient
    where the wrapper takes ``out``, else into the fresh buffer it returns.
    K9 also against K10 given its tile bands broadcast over the points."""
    import inspect
    from egtr_tpu_torch.models.detr import level_shapes
    from egtr_tpu_torch.scripts import perf_train_step
    shapes = level_shapes(perf_train_step.ADAPT_HW, smoke.L)
    starts = [0]
    for h, w in shapes:
        starts.append(starts[-1] + h * w)
    batch = perf_train_step.ADAPT_BATCH
    name = "msda_bwd_win_value_pp" if per_point else "msda_bwd_win_value"
    kernel = getattr(msda_cuda, name)
    takes_out = "out" in inspect.signature(kernel).parameters
    out = []
    for n, dtype in enumerate((torch.float32, torch.bfloat16)):
        value, loc, aw = smoke.raster_inputs(shapes, dtype, seed=740 + n,
                                             batch=batch)
        g = smoke.grad_output(batch, value.shape[1], dtype, 750 + n)
        dvalue = torch.zeros(value.shape, dtype=torch.float32,
                             device=value.device)

        def time_level(args):
            h, w = args[6], args[7]
            lid = next(l for l, hw in enumerate(shapes) if hw == (h, w))
            sl = dvalue[:, starts[lid]:starts[lid + 1]]
            if takes_out:
                fn = lambda: kernel(*args, out=sl)
                path = fn
            else:
                fn = lambda: kernel(*args)
                path = lambda: sl.add_(kernel(*args))
            runs = []
            for _ in range(2):
                sl.zero_()
                runs.append(fn().clone())
            buf = torch.zeros_like(runs[0])
            row = {"ms": smoke.cuda_ms(fn, ITERS),
                   "graph_ms": smoke.graph_ms(fn),
                   "path_graph_ms": smoke.graph_ms(path),
                   "zero_graph_ms": smoke.graph_ms(
                       lambda: torch.zeros_like(buf)),
                   "copy_graph_ms": smoke.graph_ms(lambda: sl.copy_(buf)),
                   "host_us": host_us(fn, torch),
                   "takes_out": takes_out,
                   "run_to_run_max_abs_diff":
                       (runs[0] - runs[1]).abs().max().item()}
            if not per_point:
                wide = smoke.broadcast_bands(args[1], args[2].shape[2])
                as_k10 = msda_cuda.msda_bwd_win_value_pp(args[0], wide,
                                                         *args[2:])
                row["max_abs_diff_to_k10_broadcast"] = (
                    runs[0] - as_k10).abs().max().item()
            return row

        out += _level_rows(
            smoke, name, "adaptation", batch, str(dtype)[6:],
            shapes, lambda lid: smoke._banded_bwd_args(
                value, loc, aw, g, shapes, lid, per_point), time_level)
    return out


def banded_fwd_rows(msda_cuda, smoke, torch, per_point=True) -> list:
    """K6 (``per_point``) or K5 on the three banded levels of the served
    encoder call (batch 1, raster locations, float32, bfloat16 and int8
    values; bfloat16 also at batch 4), per level and summed. K5 also
    against K6 given its tile bands broadcast over the points, where the
    checkout runs K5 through K6's kernel (one C signature for both)."""
    from egtr_tpu_torch import infer
    from egtr_tpu_torch.models.detr import level_shapes
    shapes = level_shapes(infer.BUCKET_HW, smoke.L)
    name = "msda_fwd_win_pp" if per_point else "msda_fwd_win"
    kernel = getattr(msda_cuda, name)
    through_k6 = (msda_cuda._FUNCTIONS["msda_fwd_win"]
                  == msda_cuda._FUNCTIONS["msda_fwd_win_pp"])
    out = []
    for n, (form, dtype, int8, batch) in enumerate((
            ("float32", torch.float32, False, 1),
            ("bfloat16", torch.bfloat16, False, 1),
            ("int8", torch.bfloat16, True, 1),
            ("bfloat16", torch.bfloat16, False, 4))):
        value, loc, aw = smoke.raster_inputs(shapes, dtype, seed=760 + n,
                                             batch=batch)

        def time_level(args):
            fn = lambda: kernel(*args)
            first, second = fn(), fn()
            row = {"ms": smoke.cuda_ms(fn, ITERS),
                   "graph_ms": smoke.graph_ms(fn),
                   "host_us": host_us(fn, torch),
                   "bit_equal": torch.equal(first, second)}
            if not per_point and through_k6:
                wide = smoke.broadcast_bands(args[1], args[2].shape[2])
                row["bit_equal_to_k6_broadcast"] = torch.equal(
                    first, msda_cuda.msda_fwd_win_pp(args[0], wide,
                                                     *args[2:]))
            return row

        out += _level_rows(
            smoke, name, "serving", batch, form, shapes,
            lambda lid: smoke._banded_level_args(value, loc, aw, shapes, lid,
                                                 per_point, int8), time_level)
    return out


def bp_rows(msda_cuda, smoke, torch) -> list:
    """K11 in each form beside the kernel that computes the same function,
    on the same inputs: float32 and bfloat16 beside K1 at ``exact_calls()``
    in both buckets and at the encoder call at batch 2; int8 beside K4 at
    ``q_calls()`` and at the served encoder call at batch 2; bfloat16 with
    float32 out beside K1 on the served encoder call's exact level, at batch
    1 and 2."""
    from egtr_tpu_torch import infer
    from egtr_tpu_torch.models.detr import level_shapes
    from egtr_tpu_torch.ops import msda
    from egtr_tpu_torch.scripts import perf_train_step
    out = []

    def row(fields, fn, same_name, same, moved, aw):
        first, second, other = fn(), fn(), same()
        bound_ms, bound_by = smoke.bound((*moved, first), aw)
        return {"kernel": "msda_fwd_bp", **fields,
                "ms": smoke.cuda_ms(fn, ITERS), "graph_ms": smoke.graph_ms(fn),
                "host_us": host_us(fn, torch),
                "bit_equal": torch.equal(first, second),
                "output_sha256": digest(first),
                "same_kernel": same_name,
                "same_ms": smoke.cuda_ms(same, ITERS),
                "same_graph_ms": smoke.graph_ms(same),
                "bit_equal_to_same": torch.equal(first, other),
                "max_abs_diff_to_same": (first.float() - other.float()).abs()
                .max().item(),
                "bound_ms": bound_ms, "bound_by": bound_by}

    for bucket, hw in (("serving", infer.BUCKET_HW),
                       ("training", perf_train_step.BUCKET_HW)):
        shapes = level_shapes(hw, smoke.L)
        calls = smoke.exact_calls() + [("encoder", 2, torch.float32),
                                       ("encoder", 2, torch.bfloat16)]
        for n, (call, batch, dtype) in enumerate(calls):
            Q, value, loc, aw = smoke.exact_call_inputs(shapes, call, batch,
                                                        dtype, 1100 + n)
            args = (value, shapes, loc, aw)
            out.append(row(
                {"bucket": bucket, "call": call, "Q": Q, "batch": batch,
                 "form": str(dtype)[6:]},
                lambda: msda_cuda.msda_fwd_bp(*args), "msda_fwd",
                lambda: msda_cuda.msda_fwd(*args), (value, loc, aw), aw))
    shapes = level_shapes(infer.BUCKET_HW, smoke.L)
    starts = msda.level_starts(shapes)
    exact = tuple(l for l, (h, _) in enumerate(shapes) if h <= smoke.WINDOW)

    def level_part(t, levels):
        return [t[:, starts[l]:starts[l] + shapes[l][0] * shapes[l][1]]
                for l in levels]

    for batch in (1, 2):
        value, loc, aw = smoke.raster_inputs(shapes, torch.bfloat16,
                                             1200 + batch, batch)
        args = (value, shapes, loc, aw)
        kw = dict(levels=exact, out_dtype=torch.float32)
        out.append(row(
            {"bucket": "serving", "call": "encoder_windowed",
             "Q": value.shape[1], "batch": batch, "levels": list(exact),
             "form": "bfloat16_f32_out"},
            lambda: msda_cuda.msda_fwd_bp(*args, **kw), "msda_fwd",
            lambda: msda_cuda.msda_fwd(*args, **kw),
            level_part(value, exact)
            + [t[:, :, :, l] for l in exact for t in (loc, aw)],
            aw[:, :, :, :len(exact)]))
    calls = smoke.q_calls() + [("encoder_served", 2, torch.float32),
                               ("encoder_served", 2, torch.bfloat16)]
    for n, (call, batch, dtype) in enumerate(calls):
        Q, levels, value, loc, aw = smoke.q_call_inputs(shapes, call, batch,
                                                        dtype, 1300 + n)
        vq, scale = msda.quantize_levels(value, shapes)
        out.append(row(
            {"bucket": "serving", "call": call, "Q": Q, "batch": batch,
             "levels": list(levels), "form": "int8",
             "weights": str(dtype)[6:]},
            lambda: msda_cuda.msda_fwd_bp(vq, shapes, loc, aw, levels=levels,
                                          scale=scale), "msda_fwd_q",
            lambda: msda_cuda.msda_fwd_q(vq, scale, shapes, loc, aw,
                                         levels=levels),
            level_part(vq, levels) + [scale[..., list(levels)]]
            + [t[:, :, :, l] for l in levels for t in (loc, aw)],
            aw[:, :, :, :len(levels)]))
    return out


def frozen_bn_rows(msda_cuda, smoke, torch) -> list:
    """FBN at every site of the serving and the offline trunk
    (chip_smoke.py's ``frozen_bn_rows``), and each trunk's sums."""
    rows, trunks = smoke.frozen_bn_rows()
    return ([{"kernel": "frozen_bn", **row} for row in rows]
            + [{"kernel": "frozen_bn", "bucket": bucket, "site": "trunk",
                **trunk} for bucket, trunk in trunks.items()])


def main(argv=None) -> int:
    args = _args(argv)
    root = Path(args.root).resolve()
    if args.variant:
        root = variant_copy(root, args.variant)
    sys.path.insert(0, str(root))
    import torch
    from egtr_tpu_torch import infer
    from egtr_tpu_torch.models.detr import level_shapes
    from egtr_tpu_torch.ops import msda_cuda
    from egtr_tpu_torch.scripts import perf_train_step
    smoke = _chip_smoke()

    if not torch.cuda.is_available():
        print("time_msda_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    assert Path(msda_cuda.__file__).resolve().is_relative_to(root)
    card = smoke.card_line()
    print(f"{args.label}: {root} on {card}", flush=True)
    if args.ptxas:
        ptxas_report(root, msda_cuda._nvcc())
    msda_cuda.build()
    has_geometry = hasattr(msda_cuda, "launch_geometry")
    wanted = set(args.kernels.split(","))
    buckets = {"serving": level_shapes(infer.BUCKET_HW, smoke.L),
               "training": level_shapes(perf_train_step.BUCKET_HW, smoke.L)}
    lines = []

    def emit(row):
        row["label"], row["card"] = args.label, card
        print(json.dumps(row), flush=True)
        lines.append(row)

    for bucket, shapes in buckets.items():
        if not wanted & {"K1", "K2", "K3"}:
            break
        for n, (call, batch, dtype) in enumerate(smoke.exact_calls()):
            Q, value, loc, aw = smoke.exact_call_inputs(shapes, call, batch,
                                                        dtype, n)
            g = smoke.grad_output(batch, Q, dtype, 1000 + n)
            # per kernel: the call, the tensors whose alignment counts, and
            # whether its warps walk rows with the hand-out (K1) or not (K2)
            kernels = {}
            if "K1" in wanted:
                kernels["msda_fwd"] = (lambda: (msda_cuda.msda_fwd(
                    value, shapes, loc, aw),), (value,), True)
            if bucket == "training" and "K2" in wanted:
                kernels["msda_bwd_rows"] = (lambda: msda_cuda.msda_bwd_rows(
                    value, shapes, loc, aw, g), (value, g), False)
            if bucket == "training" and "K3" in wanted:
                kernels["msda_bwd_value"] = (lambda: (msda_cuda.msda_bwd_value(
                    value, shapes, loc, aw, g),), (g,), False)
            rows = batch * Q * smoke.H
            for name, (fn, aligned, walk) in kernels.items():
                first, second = fn(), fn()
                row = {"kernel": name, "bucket": bucket,
                       "call": call, "Q": Q, "batch": batch,
                       "dtype": str(dtype)[6:],
                       "ms": smoke.cuda_ms(fn, ITERS),
                       "graph_ms": smoke.graph_ms(fn),
                       "host_us": host_us(fn, torch),
                       "bit_equal": all(torch.equal(x, y)
                                        for x, y in zip(first, second)),
                       "output_sha256": digest(*first)}
                if name == "msda_bwd_value":
                    row.update(value_split(msda_cuda, smoke, fn, first[0],
                                           second[0], value, shapes, Q, g))
                elif has_geometry:
                    row["geometry_us"] = geometry_us(
                        msda_cuda, rows, smoke.D, smoke.L * smoke.P, aligned,
                        walk)
                if has_geometry and walk:
                    row["rows_per_warp"] = msda_cuda.rows_per_warp_for(rows)
                    row["graph_ms_by_rows_per_warp"] = by_rows_per_warp(
                        msda_cuda, smoke, fn)
                    row["graph_ms_direct"] = direct_ms(msda_cuda, smoke, fn)
                emit(row)
    if "K3" in wanted:
        for row in adaptation_value_rows(msda_cuda, smoke, torch):
            emit(row)
    for name, table in (
            ("K4", q_rows),
            ("K5", lambda *a: banded_fwd_rows(*a, per_point=False)),
            ("K6", banded_fwd_rows),
            ("K7", lambda *a: banded_rows(*a, per_point=False)),
            ("K8", banded_rows),
            ("K9", lambda *a: banded_value_rows(*a, per_point=False)),
            ("K10", banded_value_rows),
            ("K11", bp_rows),
            ("FBN", frozen_bn_rows)):
        if name == "FBN" and not hasattr(msda_cuda, "frozen_bn"):
            print(f"{args.label}: no frozen_bn kernel", flush=True)
            continue
        if name in wanted:
            for row in table(msda_cuda, smoke, torch):
                emit(row)
    if args.out:
        with open(args.out, "a") as f:
            for row in lines:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
