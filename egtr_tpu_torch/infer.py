"""Serving entry point: single-image EGTR inference.

PyTorch port of ``bench.py:_build``/``infer``: random weights made from a
seed, the model forward plus ``sgg_postprocess`` top-k, with every array a
serving consumer needs packed into one tensor.

    python -m egtr_tpu_torch.infer --iters 20 [--profile 5]
    python -m egtr_tpu_torch.infer --msda-window 16 --msda-band point \
        --msda-int8 --iters 20 [--profile 5]

answers N requests (batch 1, 608x1008, after 3 warm-up requests) on the GPU
and prints the per-request latency from CUDA events; ``--profile K`` adds a
torch.profiler breakdown of K more requests (device time per request by
kernel, and the device's busy share). Without flags it runs the exact path
(``msda_window=0``); the second line is the JAX package's serving default
(``serving_config``: banded window 16, one band per point, int8 stage 1). It
defines no benchmark metric.

Entry points run on the GPU: ``device=None`` means "cuda" and raises where
CUDA is absent; pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import re
from typing import Optional, Tuple

import numpy as np
import torch

from .config import EgtrConfig
from .evaluation.postprocess import sgg_postprocess
from .models.egtr import EgtrModel
from .models.layers import init_params

# the FPS-protocol bucket: 600x1000 padded to a multiple of 16
BUCKET_HW = (608, 1008)


def bench_config(**kw) -> EgtrConfig:
    """The serving configuration of ``bench.py:_build`` at its exact path."""
    base = dict(num_queries=200, num_labels=150, num_rel_labels=50,
                dropout=0.0, compute_dtype="bfloat16")
    base.update(kw)
    return EgtrConfig(**base)


def serving_config(**kw) -> EgtrConfig:
    """The configuration ``bench.py`` serves by default (``bench.py:154-160``):
    banded MSDA with a window of 16 rows, one band per sampling point, int8
    stage 1."""
    base = dict(msda_window=16, msda_band="point", msda_int8=True)
    base.update(kw)
    return bench_config(**base)


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        device = "cuda"
    return torch.device(device)


def build(cfg: EgtrConfig, batch: int, H: int, W: int, device=None,
          seed: int = 0) -> Tuple[EgtrModel, torch.Tensor]:
    """A seeded random-weight model in eval mode and a [batch,H,W,3] input
    drawn from numpy's generator with the same seed, both on ``device``."""
    device = resolve_device(device)
    model = EgtrModel(cfg)
    init_params(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        rng.standard_normal((batch, H, W, 3)).astype(np.float32)).to(device)
    return model, x


def infer(model: EgtrModel, pixel_values: torch.Tensor,
          pixel_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward + top-k postprocessing, packed into one float32 vector
    (``bench.py:63-68``): mult_inds, mult_trip_scores, single_inds,
    single_rel_vec, obj_scores, pred_classes, pred_boxes."""
    with torch.inference_mode():
        out = model(pixel_values, pixel_mask)
        post = sgg_postprocess(
            out["logits"], out["pred_boxes"], out["pred_rel"],
            out["pred_connectivity"], num_labels=model.config.num_labels,
            top_k=100)
        parts = [post["mult_inds"], post["mult_trip_scores"],
                 post["single_inds"], post["single_rel_vec"],
                 post["obj_scores"], post["pred_classes"],
                 post["pred_boxes"]]
        return torch.cat([p.float().reshape(-1) for p in parts])


def time_requests(model: EgtrModel, x: torch.Tensor, iters: int,
                  warmup: int):
    """Per-request milliseconds from CUDA events, after ``warmup`` requests."""
    for _ in range(warmup):
        infer(model, x)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        packed = infer(model, x)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times, packed


def device_rows(prof, n: int):
    """From a finished torch.profiler run over ``n`` repetitions: the device
    rows ``(kernel name, ms per repetition, calls per repetition)``, longest
    first, and their sum (the device's busy time per repetition)."""
    # annotation ranges on the device (e.g. the optimizer's step) span the
    # kernels inside them and would count their time twice
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[1])
    return rows, sum(ms for _, ms, _ in rows)


def msda_rows(rows) -> dict:
    """The hand-written MSDA kernels among ``device_rows``' rows, whatever
    their rank: kernel -> ms and calls per repetition, its template forms
    summed."""
    out = {}
    for key, ms, calls in rows:
        found = re.search(r"\bmsda_\w+_kernel\b", key)
        if found:
            entry = out.setdefault(found.group(0), {"ms": 0.0, "calls": 0.0})
            entry["ms"] += ms
            entry["calls"] += calls
    return out


def profile_requests(model: EgtrModel, x: torch.Tensor, n: int, top: int = 25):
    """Device time per request by kernel over ``n`` requests, from
    torch.profiler, and the share of the wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n):
            infer(model, x)
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end) / n
    rows, busy_ms = device_rows(prof, n)
    return {
        "requests": n, "wall_ms_per_request": wall_ms,
        "device_busy_ms_per_request": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernels": [{"name": k[:120], "ms_per_request": ms,
                     "calls_per_request": c, "share_of_busy": ms / busy_ms}
                    for k, ms, c in rows[:top]],
        "msda_kernels": msda_rows(rows),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile", type=int, default=0, metavar="K",
                    help="also profile K requests with torch.profiler")
    ap.add_argument("--msda-window", type=int, default=0,
                    help="banded-MSDA window height (0 = exact)")
    ap.add_argument("--msda-band", default="tile", choices=["tile", "point"],
                    help="band selection granularity for windowed MSDA")
    ap.add_argument("--msda-int8", action="store_true",
                    help="int8 stage-1 MSDA")
    args = ap.parse_args(argv)
    cfg = bench_config(msda_window=args.msda_window,
                       msda_band=args.msda_band, msda_int8=args.msda_int8)
    model, x = build(cfg, 1, *BUCKET_HW)
    times, packed = time_requests(model, x, args.iters, warmup=3)
    result = {
        "device": torch.cuda.get_device_name(0),
        "batch": 1, "image_hw": list(BUCKET_HW),
        "msda_window": cfg.msda_window, "msda_band": cfg.msda_band,
        "msda_int8": cfg.msda_int8,
        "ms_per_request": times,
        "mean_ms": sum(times) / len(times),
        "outputs_finite": bool(torch.isfinite(packed).all()),
    }
    if args.profile:
        result["profile"] = profile_requests(model, x, args.profile)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
