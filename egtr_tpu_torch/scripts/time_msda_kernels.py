"""Time the exact MSDA kernels K1 (msda_fwd) and K2 (msda_bwd_rows) on the
card, at the calls that chip_smoke.py holds them to their plain versions.

    python egtr_tpu_torch/scripts/time_msda_kernels.py [--root DIR]
        [--label NAME] [--out FILE] [--ptxas]

Calls: chip_smoke.py's ``exact_calls()`` (encoder and decoder calls,
uniform and raster locations, the decoder call at batch 1 and 2, float32
and bfloat16) in the serving bucket 608x1008 (K1) and the training bucket
800x1344 (K1 and K2). Per call and kernel it prints one JSON line:

- ``ms``: CUDA events around ITERS calls of the wrapper (what
  chip_smoke.py reports: at the decoder calls the host's wrapper time
  hides the kernel's);
- ``graph_ms``: the same calls captured in a CUDA graph and replayed, the
  kernel's own device time per call;
- ``host_us``: the wrapper's host time per call (the time to queue ITERS
  calls, the card not waited for);
- ``bit_equal``: two runs on the same inputs give the same bits;
- where the checkout has ``msda_cuda.launch_geometry``: ``geometry_us``
  (the host time per call of what the wrapper does for the launch
  geometry: the pointers' alignment, the cached geometry, its int array);
  for K1 also ``rows_per_warp`` (the rows a warp walks),
  ``graph_ms_by_rows_per_warp`` (the device time with a warp walking 1,
  2, 4 and 8 rows) and ``graph_ms_direct`` (the device time with each
  lane reading its sample's location and weight itself, no hand-out).

``--root DIR`` imports ``egtr_tpu_torch`` from DIR instead of this
checkout, so that another version of the kernels (a ``git archive`` of a
parent commit, unpacked under the git-ignored ``build/``) is timed by the
same code. Run the two in turns in one call on one card (parent, change,
change, parent) and compare only there. ``--ptxas`` first prints what
``nvcc -Xptxas -v`` says of the two sources (registers, spills).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parents[2]
ITERS = 100  # wrapper calls per CUDA-event timing, as chip_smoke.py's K1
WALKS = (1, 2, 4, 8)


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose egtr_tpu_torch is timed")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--out", default=None, help="append the JSON lines here")
    ap.add_argument("--ptxas", action="store_true")
    return ap.parse_args(argv)


def _chip_smoke():
    """This checkout's chip_smoke.py, for its calls, inputs and timers; the
    ``egtr_tpu_torch`` it imports is the one first on sys.path (--root)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ptxas_report(root: Path, nvcc: str) -> None:
    for name in ("msda_fwd.cu", "msda_bwd.cu"):
        src = root / "egtr_tpu_torch" / "csrc" / name
        with tempfile.TemporaryDirectory() as tmp:
            out = subprocess.run(
                [nvcc, "-gencode",
                 "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xptxas", "-v", "-cubin", "-o", f"{tmp}/k.cubin", str(src)],
                capture_output=True, text=True)
        print(f"ptxas {name}:\n{out.stdout}{out.stderr}", flush=True)
        if out.returncode:
            raise SystemExit(f"nvcc failed on {src}")


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


def main(argv=None) -> int:
    args = _args(argv)
    root = Path(args.root).resolve()
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
    buckets = {"serving": level_shapes(infer.BUCKET_HW, smoke.L),
               "training": level_shapes(perf_train_step.BUCKET_HW, smoke.L)}
    lines = []
    for bucket, shapes in buckets.items():
        for n, (call, batch, dtype) in enumerate(smoke.exact_calls()):
            Q, value, loc, aw = smoke.exact_call_inputs(shapes, call, batch,
                                                        dtype, n)
            g = smoke.grad_output(batch, Q, dtype, 1000 + n)
            # per kernel: the call, the tensors whose alignment counts, and
            # whether its warps walk rows with the hand-out (K1) or not (K2)
            kernels = {"msda_fwd": (lambda: (msda_cuda.msda_fwd(
                value, shapes, loc, aw),), (value,), True)}
            if bucket == "training":
                kernels["msda_bwd_rows"] = (lambda: msda_cuda.msda_bwd_rows(
                    value, shapes, loc, aw, g), (value, g), False)
            rows = batch * Q * smoke.H
            for name, (fn, aligned, walk) in kernels.items():
                first, second = fn(), fn()
                row = {"label": args.label, "kernel": name, "bucket": bucket,
                       "call": call, "Q": Q, "batch": batch,
                       "dtype": str(dtype)[6:],
                       "ms": smoke.cuda_ms(fn, ITERS),
                       "graph_ms": smoke.graph_ms(fn),
                       "host_us": host_us(fn, torch),
                       "bit_equal": all(torch.equal(x, y)
                                        for x, y in zip(first, second)),
                       "card": card}
                if has_geometry:
                    row["geometry_us"] = geometry_us(
                        msda_cuda, rows, smoke.D, smoke.L * smoke.P, aligned,
                        walk)
                if has_geometry and walk:
                    row["rows_per_warp"] = msda_cuda.rows_per_warp_for(rows)
                    row["graph_ms_by_rows_per_warp"] = by_rows_per_warp(
                        msda_cuda, smoke, fn)
                    row["graph_ms_direct"] = direct_ms(msda_cuda, smoke, fn)
                print(json.dumps(row), flush=True)
                lines.append(row)
    if args.out:
        with open(args.out, "a") as f:
            for row in lines:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
