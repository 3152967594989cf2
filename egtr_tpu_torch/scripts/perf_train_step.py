"""Probe: the full-resolution EGTR training step on a synthetic batch.

PyTorch port of the repo's ``scripts/perf_train_step.py``. It runs the real
train step (forward -> criterion -> backward -> clip -> AdamW) at the
reference recipe's shape: 800/1333 images (bucket 800x1344), ResNet-50,
d_model 256, 6+6 layers, 200 queries, 150/50 labels, bfloat16 compute,
auxiliary losses, dropout 0.1, 12 boxes and 2 relations per image, seeded
random weights, and prints the time per step as one JSON line.

    python -m egtr_tpu_torch.scripts.perf_train_step [--batch 2] [--iters 5]
        [--accum 1] [--msda-impl auto] [--profile K] [--device cpu]
        [--config PATH] [--window N] [--band tile|point] [--int8]

``--config PATH`` takes the configuration of a ``config.json`` instead of
the recipe's, e.g. the band-adaptation fine-tune's
(``experiments/trained_offsets/adapt_w16p/artifact/config.json``, which
``adapt_config`` presets: window 16, one band per point, no auxiliary
losses; its run took batch 4 at 608x1008). ``--window``, ``--band`` and
``--int8`` override the banded-MSDA settings (``--window 0``: the exact
op).

It runs on the GPU unless ``--device cpu`` is given (and raises where CUDA
is absent). ``--profile K`` adds a torch.profiler breakdown of K more steps:
device time per step by kernel, the device's idle share, and the host time
of the Hungarian matcher (scipy). ``--tiny`` swaps in a 2+2-layer narrow
model for a rehearsal on the CPU. It defines no benchmark metric.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import EgtrConfig
from ..infer import device_rows, msda_rows, resolve_device
from ..models.egtr import EgtrModel
from ..models.layers import init_params
from ..ops import criterion, matcher
from ..train.optim import Optimizer, make_optimizer
from ..train.train_step import make_train_step

# the recipe's bucket: 800/1333 padded to a multiple of 16
BUCKET_HW = (800, 1344)
BOXES_PER_IMAGE = 12
LRS = dict(lr=2e-6, lr_backbone=2e-7, lr_initialized=2e-4)
# the band-adaptation fine-tune (egtr_tpu's scripts/exp_trained_offsets.py
# train --window 16 --band point) that made the weights behind the JAX
# package's serving default: experiments/trained_offsets/adapt_w16p, its
# artifact/config.json (the fields that differ from the defaults) and the
# batch, size 600/1000 and learning rates of its train_log.jsonl header
ADAPT_CONFIG = dict(num_queries=200, num_labels=6, num_rel_labels=4,
                    compute_dtype="bfloat16", max_gt_boxes=16, max_gt_rels=64,
                    msda_window=16, msda_band="point")
ADAPT_BATCH = 4
ADAPT_HW = (608, 1008)
ADAPT_LRS = dict(lr=3e-5, lr_backbone=2e-5, lr_initialized=None)
TINY = dict(d_model=64, encoder_layers=2, decoder_layers=2,
            encoder_ffn_dim=128, decoder_ffn_dim=128, num_queries=20,
            num_labels=7, num_rel_labels=8, max_gt_boxes=16, max_gt_rels=8)


def train_config(**kw) -> EgtrConfig:
    """The probe's configuration (dropout stays at the default 0.1)."""
    base = dict(num_queries=200, num_labels=150, num_rel_labels=50,
                compute_dtype="bfloat16", auxiliary_loss=True)
    base.update(kw)
    return EgtrConfig(**base)


def adapt_config(**kw) -> EgtrConfig:
    """The adaptation fine-tune's configuration (``ADAPT_CONFIG``; dropout
    0.1 and no auxiliary losses are the defaults)."""
    return EgtrConfig(**{**ADAPT_CONFIG, **kw})


def synthetic_batch(cfg: EgtrConfig, B: int, H: int, W: int, device,
                    seed: int = 0) -> dict:
    """The JAX probe's batch from numpy's generator: normal pixels, a full
    mask, ``BOXES_PER_IMAGE`` boxes and two relations per image, of the
    predicates 1 and 7 (modulo the number of predicates)."""
    rng = np.random.default_rng(seed)
    G, R = cfg.max_gt_boxes, cfg.num_rel_labels
    rel = np.zeros((B, G, G, R), np.float32)
    rel[:, 0, 1, 1 % R] = 1.0
    rel[:, 2, 3, 7 % R] = 1.0
    batch = {
        "pixel_values": rng.standard_normal((B, H, W, 3)).astype(np.float32),
        "pixel_mask": np.ones((B, H, W), bool),
        "labels": {
            "class_labels": rng.integers(0, cfg.num_labels, (B, G)),
            "boxes": rng.uniform(0.2, 0.7, (B, G, 4)).astype(np.float32),
            "num_boxes": np.full((B,), BOXES_PER_IMAGE, np.int64),
            "rel": rel,
        },
    }

    def put(tree):
        if isinstance(tree, dict):
            return {k: put(v) for k, v in tree.items()}
        return torch.from_numpy(tree).to(device)

    return put(batch)


def build(cfg: EgtrConfig, device=None, seed: int = 0, lrs: dict = LRS
          ) -> Tuple[EgtrModel, Optimizer, torch.Generator]:
    """A seeded random-weight model, its optimizer at the learning rates
    ``lrs`` (the recipe's by default), and the step's generator, all on
    ``device``."""
    device = resolve_device(device)
    model = init_params(EgtrModel(cfg), torch.Generator().manual_seed(seed))
    model = model.to(device)
    optimizer = make_optimizer(model, **lrs)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    return model, optimizer, generator


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_steps(step, batch, generator, iters: int, device
               ) -> Tuple[List[float], Dict[str, float]]:
    """Milliseconds per step on the host clock, each step ending in a
    device synchronize, and the last step's metrics as floats."""
    times, metrics = [], {}
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        metrics = step(batch, generator)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return times, {k: float(v) for k, v in metrics.items()}


# device kernels by what they do, first match wins (substrings of the
# kernel names torch.profiler reports)
KERNEL_KINDS = (
    ("msda", ("msda_",)),
    ("convolution", ("conv", "wgrad", "dgrad", "fprop", "cudnn", "nchw",
                     "nhwc")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas")),
    ("index_scatter_sort", ("index", "scatter", "gather", "sort", "topk",
                            "radix")),
    ("normalization", ("layer_norm", "GammaBeta", "group_norm", "RowwiseMoments")),
    ("optimizer_foreach", ("multi_tensor", "foreach", "adam")),
    ("reduction", ("reduce_kernel", "softmax")),
    ("elementwise_copy", ("elementwise", "copy", "fill", "Memcpy", "Memset")),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, marks in KERNEL_KINDS:
        if any(m.lower() in low for m in marks):
            return kind
    return "other"


def profile_steps(step, batch, generator, n: int, top: int = 30) -> dict:
    """Device time per step by kernel over ``n`` steps (torch.profiler), the
    device's idle share, and the matcher's host time: the whole of
    ``hungarian_match`` (it waits for the device to deliver the cost matrix)
    and the scipy solver alone."""
    from torch.profiler import ProfilerActivity, profile

    spent = {"hungarian_match": 0.0, "linear_sum_assignment": 0.0,
             "matches": 0}
    match_fn, solve_fn = criterion.hungarian_match, matcher.linear_sum_assignment

    def timed(fn, key, count=False):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
                spent["matches"] += int(count)
        return wrapper

    criterion.hungarian_match = timed(match_fn, "hungarian_match", True)
    matcher.linear_sum_assignment = timed(solve_fn, "linear_sum_assignment")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step(batch, generator)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    finally:
        criterion.hungarian_match = match_fn
        matcher.linear_sum_assignment = solve_fn
    rows, busy_ms = device_rows(prof, n)
    by_kind: Dict[str, float] = {}
    for name, ms, _ in rows:
        by_kind[kernel_kind(name)] = by_kind.get(kernel_kind(name), 0.0) + ms
    return {
        "steps": n, "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        # under the profiler, whose own host cost stretches the wall time
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches_per_step": sum(c for _, _, c in rows),
        "device_ms_by_kind": dict(sorted(by_kind.items(),
                                         key=lambda kv: -kv[1])),
        "matches_per_step": spent["matches"] / n,
        "hungarian_match_host_ms_per_step":
            spent["hungarian_match"] * 1e3 / n,
        "scipy_solver_host_ms_per_step":
            spent["linear_sum_assignment"] * 1e3 / n,
        "kernels": [{"name": k[:120], "ms_per_step": ms,
                     "calls_per_step": c, "share_of_busy": ms / busy_ms}
                    for k, ms, c in rows[:top]],
        "msda_kernels": msda_rows(rows),
    }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2,
                    help="rows per step (all microbatches together)")
    ap.add_argument("--height", type=int, default=BUCKET_HW[0])
    ap.add_argument("--width", type=int, default=BUCKET_HW[1])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--msda-impl", default=None,
                    help="default: the configuration's (auto)")
    ap.add_argument("--config", default=None, metavar="PATH",
                    help="the configuration of a config.json")
    ap.add_argument("--window", type=int, default=None,
                    help="banded-MSDA window height (0 = exact)")
    ap.add_argument("--band", default=None, choices=["tile", "point"],
                    help="band selection granularity for windowed MSDA")
    ap.add_argument("--int8", action="store_true", help="int8 stage-1 MSDA")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises where CUDA is absent)")
    ap.add_argument("--profile", type=int, default=0, metavar="K",
                    help="also profile K steps with torch.profiler")
    ap.add_argument("--tiny", action="store_true",
                    help="2+2-layer narrow float32 model, for a rehearsal")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    kw = dict(TINY, compute_dtype="float32") if args.tiny else {}
    for key, value in (("msda_impl", args.msda_impl),
                       ("msda_window", args.window),
                       ("msda_band", args.band),
                       ("msda_int8", args.int8 or None)):
        if value is not None:
            kw[key] = value
    if args.config:
        cfg = EgtrConfig.load(args.config).replace(**kw)
    else:
        cfg = train_config(**kw)
    model, optimizer, generator = build(cfg, device)
    batch = synthetic_batch(cfg, args.batch, args.height, args.width, device)
    step = make_train_step(model, cfg, optimizer, task="sgg",
                           accum_steps=args.accum)
    first, _ = time_steps(step, batch, generator, 1, device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times, metrics = time_steps(step, batch, generator, args.iters, device)
    result = {
        "device": (torch.cuda.get_device_name(0) if device.type == "cuda"
                   else "cpu"),
        "batch": args.batch, "accum": args.accum,
        "image_hw": [args.height, args.width],
        "config": args.config or "recipe",
        "msda_impl": cfg.msda_impl, "msda_window": cfg.msda_window,
        "msda_band": cfg.msda_band, "msda_int8": cfg.msda_int8,
        "compute_dtype": cfg.compute_dtype,
        "params_m": sum(p.numel() for p in model.parameters()) / 1e6,
        "first_step_ms": first[0], "ms_per_step": times,
        "mean_ms": sum(times) / len(times),
        "images_per_s": args.batch / (sum(times) / len(times)) * 1e3,
        "total_loss": metrics["total_loss"],
        "grad_norm": metrics["grad_norm"],
    }
    if device.type == "cuda":
        result["max_memory_allocated_gb"] = (
            torch.cuda.max_memory_allocated() / 1e9)
    if args.profile:
        profile = profile_steps(step, batch, generator, args.profile)
        # against the unprofiled step time
        profile["device_idle_share_unprofiled"] = (
            1.0 - profile["device_busy_ms_per_step"] / result["mean_ms"])
        result["profile"] = profile
    print(json.dumps(result))


if __name__ == "__main__":
    main()
