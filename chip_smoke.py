"""Drive the PyTorch port (egtr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Every phase runs unguarded; any failure ends the script with a nonzero exit
and no result line. In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written MSDA kernels (exact forward; backward rows and
   value; int8 forward; banded forward; banded backward rows and value;
   batched-P forward) from egtr_tpu_torch/csrc and the native evaluation
   kernels from egtr_tpu_torch/native, the compilers started together;
3. holds the forward kernel against its plain PyTorch version at the two
   main paths' shapes (serving bucket 608x1008: levels (76,126),(38,63),
   (19,32),(10,16), S = 12738; training bucket 800x1344: levels (100,168),
   (50,84),(25,42),(13,21), S = 22323, where level 0 rounds the y weights in
   bfloat16; encoder call Q = S, decoder call Q = 200; 8 heads of 32) in
   float32 and bfloat16, at the encoder call with raster (encoder-like)
   locations beside the uniform ones, and at the decoder call at batch 2
   (the training step's) beside batch 1 (the serving request's); the list
   is ``EXACT_CALLS``; checks that two runs are bit-equal, times the
   kernel (CUDA events around the wrapper, and its own device time in a
   CUDA graph), the plain version and the ``F.grid_sample`` composite (a
   yardstick of several PyTorch calls that the port never calls), prints
   the corner-gather bytes and their rate as L2 gather traffic, and checks
   the kernel's batch addressing on a batch of 2;
4. holds the two backward kernels against the plain backward at the
   training bucket's shapes the same way (the row kernel bit-equal over two
   runs, the composite's autograd backward as the yardstick of both), times
   the value kernel (K3) at every call by CUDA events and in a CUDA graph
   beside its bound, and prints the largest difference between two runs of
   it (its float32 atomics add in an order that changes);
5. holds the int8 forward kernel (K4) against its plain version at the
   serving bucket's calls (``Q_CALLS``): the served encoder call (the one
   exact level, Q = S, raster queries), the int8 encoder call without a
   window (all levels) and the decoder call (Q = 200) at batch 1 and 2, with
   float32 and bfloat16 weights, and a batch of 2 of mirrored images; checks
   that two runs are bit-equal and the quantized values made on the card
   equal those made on the CPU, bit for bit, and times the kernel by CUDA
   events and in a CUDA graph beside its bound;
6. holds the banded forward kernels (K5 one band per tile, K6 one band per
   point) against their plain version on the three banded levels of the
   served encoder call (window 16, raster queries with offsets of a few
   pixels; prints the share of samples that clamp), with float32, bfloat16
   and int8 values, and a batch of 2; checks that two runs are bit-equal
   and that K5 is bit-equal to K6 given K5's tile bands broadcast over the
   points, and times both kernels by CUDA events and in a CUDA graph;
7. serves a few requests through ``infer.infer`` at full width (ResNet-50,
   d_model 256, 6+6 layers, 200 queries, 150/50 labels, bfloat16, seeded
   random weights) in three configurations and checks the outputs and each
   kernel's launches per forward: the exact bench configuration (K1 12), the
   JAX package's serving default ``infer.serving_config()`` (window 16, one
   band per point, int8: K6 18, K4 12, K1 0) and ``msda_band="tile"`` without
   int8 (K5 18, K1 12); then times the three in turns, side by side;
8. runs the exact and the served model in float32 (TF32 off) through the
   kernels and through the plain versions and compares logits, boxes and
   relation scores, counting the band indices on which the two runs differ;
9. runs one forward + backward of the int8 op without a window: K4, K2 and
   K3 one launch each, gradients equal to the exact op's;
10. trains: the train probe's step (``scripts/perf_train_step``) at full
   width, bfloat16, batch 2 at 800x1344, dropout 0.1: three steps and one
   accumulated step (accum 2 over a batch of 4). Checks that every metric
   is finite, the gradient norm positive, the trainable parameters moved,
   the frozen ones bit-identical, and that each microbatch launched each of
   the three kernels 12 times;
11. runs one float32 (TF32 off) forward + backward of the same model through
   the kernels and through the plain op and compares the total loss and
   every parameter's gradient, beside the plain path's own change when the
   pixels move by about one float32 step;
12. holds the banded backward kernels (K7 rows and K9 value, one band per
   tile; K8 rows and K10 value, one band per point) against their plain
   version on the three banded levels of the adaptation's encoder call
   (608x1008, window 16, raster queries with offsets of a few pixels; prints
   the clamped share and the value kernels' run-to-run difference; the row
   kernels bit-equal over two runs, and K7 bit-equal to K8 given K7's tile
   bands broadcast over the points; K9's largest difference to K10 on those
   broadcast bands; all four timed by CUDA events and in a CUDA graph, K9
   and K10 adding into the level's slice of a layer's gradient as the path
   calls them) in float32 and bfloat16 at the adaptation's microbatch of 4,
   and checks the batch addressing on a batch of 2;
13. trains the windowed path: the band-adaptation fine-tune's step
   (``perf_train_step.adapt_config``: window 16, one band per point, bf16,
   dropout 0.1, no auxiliary losses) at full width, batch 4 at 608x1008, its
   learning rates, three steps, and one step each of its siblings
   ``msda_band="tile"`` and one band per point with int8. Checks the metrics,
   the parameters, and each microbatch's launches: K6 18, K1 12, K8 18, K10
   18, K2 12, K3 12 (tile: K5 18, K1 12, K7 18, K9 18, K2 12, K3 12; int8:
   K6 18, K4 12, K8 18, K10 18, K2 12, K3 12);
14. runs one float32 (TF32 off, dropout 0) forward + backward of the
   adaptation model through the kernels and through their plain versions
   and compares them in the same way, and the band indices;
15. holds the batched-P forward K11 (``EGTR_MSDA_BATCH_P=1``) against its
   plain version and beside K1 on the same inputs, at the serving and
   training buckets' encoder and decoder calls in float32 and bfloat16 at a
   batch of 2, its int8 form beside K4 on the served encoder call's exact
   level and the decoder call, a windowed call's exact level (float32
   out), and the bfloat16 and int8 forms at three points a level and on
   values one element off their allocation; the bfloat16 and int8 forms
   run K1's and K4's kernels (``msda_cuda.BP_ROUTES``) and must give their
   bits at every call; times both kernels at each call (this runs before
   phase 7);
16. serves one request of each of phase 7's configurations with the flag on
   (``msda.FWD_BATCH_P``, what the environment variable sets at import):
   K11 takes every K1 / K4 launch (exact: K11 12; served: K6 18, K11 12;
   tile: K5 18, K11 12); the outputs bit-equal to the flag-off forward of
   the same model; phase 8 adds a float32 run with the flag on against the
   plain path;
17. runs the training driver ``scripts.train_egtr.main`` in-process with
   the flag on, at full width on its defaults: a synthetic VG set (8/2/2
   images at 600x1000, seed 0), batch 2 x accum 2, one epoch per phase.
   Checks the launches (K11 12 per forward: 2 x (2 steps x 2 microbatches
   + 1 validation batch) + 2 test images = 144; K2, K3 12 per microbatch =
   96; nothing else), the metrics.jsonl records of both phases, finite
   losses, the artifact, metrics_test.json's R@K, mR@K and COCO entries,
   the reloaded artifact's forward bit-equal to the trained model's, and a
   relaunch on the same output path that resumes and takes no step (only
   the test evaluation's 24 K11 launches); prints seconds per phase and
   ms per optimizer step from metrics.jsonl;
18. holds K4, K5 and K6 against their plain versions at the test bucket's
   levels (800x1344), as phases 5 and 6 do at the serving bucket's; then
   runs the evaluation driver ``scripts.evaluate_egtr.main`` in-process,
   with the flag off, on phase 17's artifact and test split (800/1333,
   bf16, batch 1): R@K and mR@K equal to phase 17's ``metrics_test.json``
   (its test evaluation ran K11's bf16 form, bit-equal to K1, on the model
   the artifact reloads bit-equal), K1 12 per forward and nothing else; the
   SGG evaluator's calls of that run replayed with the native matcher and
   with the numpy loop, host ms of each and the same recalls; the same
   split with ``--msda_window 16 --msda_band point --msda_int8 true`` (K6
   18, K4 12, K1 0 per forward), its R@K beside the exact run's; and
   ``--infer_only`` (K1 12 per forward: the warm-up, the timed loop and the
   three decomposition loops), whose fps, strict-sync fps, chained and
   device-busy ms per image and host round trip must be finite and
   positive; prints each run's seconds;
19. runs the pretraining driver ``scripts.pretrain_detr.main`` in-process
   on the same synthetic VG set at full width (ResNet-50, d_model 256, 6+6
   layers, 200 queries, bf16, auxiliary losses, the crop augmentor), batch
   2 x accum 2, one epoch per phase: K1, K2 and K3 12 per microbatch and K1
   12 per evaluation forward, nothing else; finite losses in both phases'
   metrics.jsonl; the COCO entries of metrics_test.json; and
   ``merge_pretrained`` of the exported artifact into a fresh ``EgtrModel``
   init takes every detector leaf from the artifact and keeps the relation
   head's leaves and the frequency-bias tables fresh; prints its seconds;
20. prints a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` last.

It exits nonzero without a result where CUDA is absent.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import numpy as np

from egtr_tpu_torch import infer, native
from egtr_tpu_torch.evaluation import sg_eval
from egtr_tpu_torch.evaluation.sg_eval import SceneGraphEvaluator
from egtr_tpu_torch.models.detr import level_shapes
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.models.layers import MSDeformableAttention
from egtr_tpu_torch.ops import criterion, msda, msda_cuda
from egtr_tpu_torch.ops.msda_window import segment_bounds
from egtr_tpu_torch.scripts import perf_train_step
from egtr_tpu_torch.train.train_step import make_train_step

# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores, where the kernel does its arithmetic
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# flops per sampled (query, head, level, point) and channel. Forward: two
# 2-corner dot products (3 each) and their weighted sum into the accumulator
# (4). Backward rows: dT (2), the two column sums times the hat derivatives
# (10), T and T*g (8), the daw and diy sums (8). Backward value: dT (2), four
# products and four additions (8).
FLOPS_PER_SAMPLE_CHANNEL = 10
FLOPS_ROWS, FLOPS_VALUE = 28, 10

# kernel vs plain: float32 differs only in the order of summation; bf16
# outputs may differ by one rounding of the float32 sum (2**-8), allow two
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 2 * 2.0 ** -8)}
# float32 model, kernel vs plain MSDA: summation order in 12 MSDA calls,
# carried through the decoder and the heads
MODEL_ATOL = 1e-3
# the same for the served model (window 16, one band per point, int8): a
# value whose two float32 versions straddle a rounding tie lands on the
# neighbouring int8 step (1/127 of its level's largest value), and a band
# index whose weighted mean straddles a tie moves a whole tile's clamp
SERVED_MODEL_ATOL = 2e-2
# backward kernels vs plain backward. float32: summation order only (warp
# shuffles and atomics against torch sums), relative to each output's largest
# entry. bfloat16: dvalue and daw are rounded once to bf16 from float32 sums
# in another order (one bf16 step, 2**-8; allow two); dloc stays float32 and
# sums bf16-exact products.
BWD_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-3, 2 * 2.0 ** -8)}
# float32 train step, kernels vs plain op: the loss, and each parameter's
# gradient relative to that gradient's largest entry (summation order in 12
# forward and 24 backward MSDA calls, carried through the whole backward)
GRAD_RTOL = 2e-3
# the same at the adaptation's configuration (608x1008, no auxiliary
# losses), whose gradients are more sensitive to round-off: the pixels times
# (1 + 1.2e-7 noise) move the plain path's own gradients by 3.6e-3 of the
# largest entry there, kernels vs plain 2.8e-3 (an H100; compare_train_f32
# prints both)
ADAPT_GRAD_RTOL = 1e-2
# and where a band index differs between the two runs: its tile's samples
# clamp to other rows in the forward and the backward
FLIPPED_BAND_GRAD_RTOL = 5e-2

# what library_composite_ms times: no one PyTorch call computes MSDA, so
# library_ms stays null
COMPOSITE_NOTE = ("a composite of several PyTorch calls, not one: "
                  "F.grid_sample per level plus the weighted sum")

H, D, L, P = 8, 32, 4, 4
WINDOW = 16         # the served window
MAX_OFFSET_PX = 4.0  # raster inputs: offsets of a few pixels, some clamp
N_REQUESTS = 4
N_TILE_REQUESTS = 2
SIDE_BY_SIDE_ROUNDS = 10
TRAIN_STEPS = 3
ADAPT_STEPS = 3
DEVICE = "cuda"
# the training driver's run: a synthetic VG set (scripts/make_synth_vg) and
# the driver's own defaults at full width (ResNet-50, d_model 256, 6+6
# layers, 200 queries, bf16), one epoch per phase
SYNTH_VG = dict(n_train=8, n_val=2, n_test=2, height=600, width=1000)
DRIVER_ARGS = ["--from_scratch", "true", "--batch_size", "2", "--accumulate",
               "2", "--max_epochs", "1", "--max_epochs_finetune", "1",
               "--num_workers", "2", "--seed", "0", "--log_every", "1"]
# the pretraining driver's run on the same set, on its own defaults at full
# width (ResNet-50, d_model 256, 6+6 layers, 200 queries, bf16)
PRETRAIN_ARGS = ["--batch_size", "2", "--accumulate", "2", "--max_epochs",
                 "1", "--max_epochs_finetune", "1", "--num_workers", "2",
                 "--seed", "0", "--log_every", "1"]
# the served configuration's overrides for the evaluation driver
SERVED_EVAL_ARGS = ["--msda_window", str(WINDOW), "--msda_band", "point",
                    "--msda_int8", "true"]
RECALL_KEYS = [f"single/{m}@{k}" for m in ("R", "mR") for k in (20, 50, 100)]
# replays of the exact evaluation's SGG-evaluator work, per matching path
SG_EVAL_ROUNDS = 20
# the ranks of each image's own top-k that a planted ground truth holds:
# six triplets
PLANTED_RANKS = (0, 10, 20, 30, 40, 50)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def msda_inputs(Q, S, dtype, seed, batch=1, points=P):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    value = torch.randn((batch, S, H, D), generator=g, device=DEVICE).to(dtype)
    # locations roam slightly outside [0, 1] so the zero padding is hit
    loc = torch.rand((batch, Q, H, L, points, 2), generator=g,
                     device=DEVICE) * 1.2 - 0.1
    aw = torch.randn((batch, Q, H, L * points), generator=g,
                     device=DEVICE).softmax(-1)
    return value, loc, aw.reshape(batch, Q, H, L, points).to(dtype)


def raster_inputs(shapes, dtype, seed, batch=1):
    """Encoder-like inputs: the queries are the raster tokens of ``shapes``,
    reference points on their own pixel centres, offsets of up to
    MAX_OFFSET_PX pixels on every level."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    S = sum(h * w for h, w in shapes)
    value = torch.randn((batch, S, H, D), generator=g, device=DEVICE).to(dtype)
    refs = []
    for h, w in shapes:
        yy, xx = torch.meshgrid(torch.arange(h, device=DEVICE),
                                torch.arange(w, device=DEVICE), indexing="ij")
        refs.append(torch.stack([(xx.reshape(-1) + 0.5) / w,
                                 (yy.reshape(-1) + 0.5) / h], -1))
    ref = torch.cat(refs)                                     # [S, 2]
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                      device=DEVICE)
    off = (torch.rand((batch, S, H, len(shapes), P, 2), generator=g,
                      device=DEVICE) * 2 - 1) * MAX_OFFSET_PX
    loc = ref[None, :, None, None, None, :] + off / wh[None, None, None, :,
                                                       None, :]
    aw = torch.randn((batch, S, H, len(shapes) * P), generator=g,
                     device=DEVICE).softmax(-1)
    return value, loc.contiguous(), aw.reshape(batch, S, H, len(shapes),
                                               P).to(dtype)


# The calls at which K1 and K2 are held to their plain versions and timed,
# in each bucket and in float32 and bfloat16 (scripts/time_msda_kernels.py
# times the same list): (call, batch). The encoder call has Q = S, uniform
# or raster locations; the decoder call Q = 200: at batch 1 the serving
# request's (B*Q*H = 1,600 rows), at batch 2 the training step's (3,200).
EXACT_CALLS = (("encoder", 1), ("decoder", 1), ("encoder_raster", 1),
               ("decoder", 2))
DECODER_Q = 200


def exact_calls():
    """(call, batch, dtype) of every call of EXACT_CALLS, in its order."""
    return [(call, batch, dtype) for call, batch in EXACT_CALLS
            for dtype in (torch.float32, torch.bfloat16)]


def exact_call_inputs(shapes, call, batch, dtype, seed):
    """(Q, value, loc, aw) at one call of EXACT_CALLS."""
    S = sum(h * w for h, w in shapes)
    if call == "encoder_raster":
        return (S, *raster_inputs(shapes, dtype, seed, batch))
    Q = S if call == "encoder" else DECODER_Q
    return (Q, *msda_inputs(Q, S, dtype, seed, batch))


def grad_output(batch, Q, dtype, seed):
    """A seeded output gradient for the backward kernels."""
    return torch.randn((batch, Q, H * D), device=DEVICE,
                       generator=torch.Generator(device=DEVICE)
                       .manual_seed(seed)).to(dtype)


def bound(tensors, aw, flops_per_sample_channel=FLOPS_PER_SAMPLE_CHANNEL):
    """Least time for a call on the card: ``tensors`` (each input read once,
    each output written once) over the HBM rate, against the flops over the
    float32 rate (``aw`` has one entry per sample). Returns (ms, "bytes" |
    "operations")."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    flops = aw.numel() * D * flops_per_sample_channel
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / FP32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """The kernel's own device time per call: ``per_graph`` calls captured
    in one CUDA graph, replayed ``replays`` times after a warm replay (at
    the decoder calls ``cuda_ms`` times the host's wrapper instead)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def composite_msda(value, shapes, loc, aw):
    """A yardstick the port never calls: MSDA as PyTorch's own calls write
    it, ``F.grid_sample`` (bilinear, zero padding, align_corners=False) per
    level and the weighted sum over points and levels. A composite of
    several calls, not one PyTorch call; it rounds nothing as the kernels
    do, and takes the grid in the value dtype."""
    B, _, Hh, Dh = value.shape
    Q, Pp = loc.shape[1], loc.shape[4]
    starts = msda.level_starts(shapes)
    out = 0
    for lid, (h, w) in enumerate(shapes):
        v = value[:, starts[lid]:starts[lid] + h * w].permute(0, 2, 3, 1)
        grid = (2 * loc[:, :, :, lid] - 1).transpose(1, 2)
        sampled = torch.nn.functional.grid_sample(
            v.reshape(B * Hh, Dh, h, w),
            grid.reshape(B * Hh, Q, Pp, 2).to(value.dtype), mode="bilinear",
            padding_mode="zeros", align_corners=False)      # [B*H, D, Q, P]
        a = aw[:, :, :, lid].transpose(1, 2).reshape(B * Hh, 1, Q, Pp)
        out = out + (sampled * a).sum(-1)
    return out.view(B, Hh, Dh, Q).permute(0, 3, 1, 2).reshape(B, Q, Hh * Dh)


def gather_bytes(aw, value):
    """Corner-gather bytes of a call, from the shapes: every sample reads
    four corner rows of D values (L2 gather traffic where the value tensor
    stays in L2, as at these calls; not device-memory bytes)."""
    return aw.numel() * 4 * value.shape[3] * value.element_size()


def _fwd_row(bucket, call, Q, value, shapes, loc, aw):
    """K1 at one call: held to the plain version, bit-equal over two runs,
    timed beside the plain version and the grid_sample composite."""
    kern = msda_cuda.msda_fwd(value, shapes, loc, aw)
    again = msda_cuda.msda_fwd(value, shapes, loc, aw)
    plain = msda.ms_deform_attn_plain(value, shapes, loc, aw)
    composite = composite_msda(value, shapes, loc, aw)
    torch.cuda.synchronize()
    dtype = value.dtype
    err = (kern.float() - plain.float()).abs()
    atol, rtol = TOL[dtype]
    limit = atol + rtol * plain.float().abs()
    row = {
        "bucket": bucket, "call": call, "Q": Q, "batch": value.shape[0],
        "dtype": str(dtype).split(".")[-1],
        "max_abs_err": err.max().item(),
        "max_err_over_limit": (err / limit).max().item(),
        "bit_equal_run_to_run": torch.equal(kern, again),
        "ms": cuda_ms(lambda: msda_cuda.msda_fwd(value, shapes, loc, aw),
                      100),
        "graph_ms": graph_ms(lambda: msda_cuda.msda_fwd(value, shapes, loc,
                                                        aw)),
        "plain_ms": cuda_ms(lambda: msda.ms_deform_attn_plain(
            value, shapes, loc, aw), 5),
        "library_composite_ms": cuda_ms(lambda: composite_msda(
            value, shapes, loc, aw), 10),
        "composite_max_abs_diff": (composite.float()
                                   - plain.float()).abs().max().item(),
    }
    row["bound_ms"], row["bound_by"] = bound((value, loc, aw, kern), aw)
    row["gather_bytes"] = gather_bytes(aw, value)
    row["gather_GBps_L2"] = row["gather_bytes"] / row["ms"] / 1e6
    print(f"msda_fwd {bucket} {call} Q={Q} B={row['batch']} {row['dtype']}: "
          f"max abs err "
          f"{row['max_abs_err']:.3e} (err/limit "
          f"{row['max_err_over_limit']:.3f}, atol {atol} rtol {rtol}), "
          f"bit-equal run to run {row['bit_equal_run_to_run']}; kernel "
          f"{row['ms']:.4f} ms (device {row['graph_ms']:.4f} ms in a CUDA "
          f"graph), plain {row['plain_ms']:.4f} ms, grid_sample composite "
          f"{row['library_composite_ms']:.4f} ms (max abs diff to plain "
          f"{row['composite_max_abs_diff']:.2e}), bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); corner gathers "
          f"{row['gather_bytes'] / 1e6:.1f} MB, {row['gather_GBps_L2']:.0f} "
          "GB/s of L2 gather traffic (not a roofline share)", flush=True)
    if not torch.isfinite(kern.float()).all():
        raise SystemExit(f"msda_fwd {call} {dtype}: non-finite output")
    if row["max_err_over_limit"] > 1.0:
        raise SystemExit(f"msda_fwd {call} {dtype}: kernel disagrees "
                         "with the plain version")
    if not row["bit_equal_run_to_run"]:
        raise SystemExit(f"msda_fwd {call} {dtype}: two runs differ")
    return row


def check_kernel(shapes, bucket):
    """K1 against the plain version at every call of EXACT_CALLS."""
    S = sum(h * w for h, w in shapes)
    rows = []
    for n, (call, batch, dtype) in enumerate(exact_calls()):
        seed = (50 if call == "encoder_raster" else 0) + n
        Q, value, loc, aw = exact_call_inputs(shapes, call, batch, dtype,
                                              seed)
        rows.append(_fwd_row(bucket, call, Q, value, shapes, loc, aw))
    # the batch index of the kernel's addressing, on two mirrored images
    value, loc, aw = msda_inputs(200, S, torch.float32, seed=4)
    value, loc, aw = (torch.cat([t, t.flip(1)]) for t in (value, loc, aw))
    plain = msda.ms_deform_attn_plain(value, shapes, loc, aw)
    err = (msda_cuda.msda_fwd(value, shapes, loc, aw) - plain).abs()
    atol, rtol = TOL[torch.float32]
    print(f"msda_fwd {bucket} decoder batch 2 float32: max abs err "
          f"{err.max().item():.3e}", flush=True)
    if (err > atol + rtol * plain.abs()).any():
        raise SystemExit("msda_fwd batch 2: kernel disagrees with plain")
    return rows


def _f32_err(kern, plain):
    """(max abs err, err over the float32 limit): the new forward kernels
    and their plain versions both return float32 sums of the same rounded
    products, so they differ in the order of summation only."""
    atol, rtol = TOL[torch.float32]
    err = (kern - plain).abs()
    return err.max().item(), (err / (atol + rtol * plain.abs())).max().item()


# The calls at which K4 is held to its plain version and timed, in the
# serving bucket (scripts/time_msda_kernels.py times the same list): (call,
# batch). The served encoder call sums the one exact level of a window of
# 16 (Q = S, raster queries), the int8 encoder call without a window every
# level (Q = S, raster), the decoder call every level (Q = 200) at batch 1
# (a served request's) and 2.
Q_CALLS = (("encoder_served", 1), ("encoder", 1), ("decoder", 1),
           ("decoder", 2))


def q_calls():
    """(call, batch, weights dtype) of every call of Q_CALLS, in order."""
    return [(call, batch, dtype) for call, batch in Q_CALLS
            for dtype in (torch.float32, torch.bfloat16)]


def q_call_inputs(shapes, call, batch, dtype, seed):
    """(Q, levels, value, loc, aw) at one call of Q_CALLS: the values for
    ``msda.quantize_levels``, the weights in ``dtype``."""
    S = sum(h * w for h, w in shapes)
    levels = tuple(range(len(shapes)))
    if call == "encoder_served":
        levels = tuple(l for l, (h, _) in enumerate(shapes) if h <= WINDOW)
    if call.startswith("encoder"):
        Q = S
        value, loc, aw = raster_inputs(shapes, dtype, seed, batch)
    else:
        Q = DECODER_Q
        value, loc, aw = msda_inputs(Q, S, dtype, seed, batch)
    return Q, levels, value, loc, aw


def check_q_kernel(shapes, bucket="serving"):
    """K4 against its plain version at every call of Q_CALLS on ``bucket``'s
    levels: within the float32 tolerance, bit-equal over two runs, timed by
    CUDA events and in a CUDA graph beside its bound."""
    S = sum(h * w for h, w in shapes)
    starts = msda.level_starts(shapes)
    rows = []
    for n, (call, batch, dtype) in enumerate(q_calls()):
        Q, levels, value, loc, aw = q_call_inputs(shapes, call, batch,
                                                  dtype, n)
        vq, scale = msda.quantize_levels(value, shapes)
        vq_cpu, scale_cpu = msda.quantize_levels(value.cpu(), shapes)
        if not (torch.equal(vq.cpu(), vq_cpu)
                and torch.equal(scale.cpu(), scale_cpu)):
            raise SystemExit(f"msda_fwd_q {call} {dtype}: the values "
                             "quantized on the card differ from those "
                             "quantized on the CPU")
        args = (vq, scale, shapes, loc, aw)
        fn = lambda: msda_cuda.msda_fwd_q(*args, levels=levels)
        kern, again = fn(), fn()
        plain = msda.msda_fwd_q_plain(*args, levels=levels)
        torch.cuda.synchronize()
        row = {"bucket": bucket, "call": call, "Q": Q, "batch": batch,
               "levels": list(levels), "dtype": str(dtype).split(".")[-1]}
        row["max_abs_err"], row["max_err_over_limit"] = _f32_err(kern, plain)
        row["bit_equal_run_to_run"] = torch.equal(kern, again)
        row["ms"] = cuda_ms(fn, 100)
        row["graph_ms"] = graph_ms(fn)
        row["plain_ms"] = cuda_ms(lambda: msda.msda_fwd_q_plain(
            *args, levels=levels), 5)
        # what the call must move: the summed levels' values, scales,
        # locations and weights, and the float32 output
        moved = [t for l in levels for t in (
            vq[:, starts[l]:starts[l] + shapes[l][0] * shapes[l][1]],
            scale[..., l], loc[:, :, :, l], aw[:, :, :, l])]
        row["bound_ms"], row["bound_by"] = bound(
            (*moved, kern), aw[:, :, :, :len(levels)])
        atol, rtol = TOL[torch.float32]
        print(f"msda_fwd_q {bucket} {call} Q={Q} B={batch} levels "
              f"{list(levels)} {row['dtype']} weights: max abs err "
              f"{row['max_abs_err']:.3e} (err/limit "
              f"{row['max_err_over_limit']:.3f}, atol {atol} rtol {rtol}), "
              f"bit-equal run to run {row['bit_equal_run_to_run']}; kernel "
              f"{row['ms']:.4f} ms (device {row['graph_ms']:.4f} ms in a CUDA "
              f"graph), plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); quantized "
              "values equal to the CPU's", flush=True)
        if not torch.isfinite(kern).all():
            raise SystemExit(f"msda_fwd_q {bucket} {call} {dtype}: "
                             "non-finite")
        if row["max_err_over_limit"] > 1.0:
            raise SystemExit(f"msda_fwd_q {bucket} {call} {dtype}: kernel "
                             "disagrees with the plain version")
        if not row["bit_equal_run_to_run"]:
            raise SystemExit(f"msda_fwd_q {bucket} {call} {dtype}: two runs "
                             "differ")
        rows.append(row)
    # the batch index of the kernel's addressing, on two mirrored images
    value, loc, aw = msda_inputs(200, S, torch.float32, seed=len(rows))
    value, loc, aw = (torch.cat([t, t.flip(1)]) for t in (value, loc, aw))
    vq, scale = msda.quantize_levels(value, shapes)
    _, over = _f32_err(msda_cuda.msda_fwd_q(vq, scale, shapes, loc, aw),
                       msda.msda_fwd_q_plain(vq, scale, shapes, loc, aw))
    print(f"msda_fwd_q {bucket} decoder batch 2: err/limit {over:.3f}",
          flush=True)
    if over > 1.0:
        raise SystemExit(f"msda_fwd_q {bucket} batch 2: kernel disagrees "
                         "with plain")
    return rows


BANDED = {"tile": ("msda_fwd_win", False), "point": ("msda_fwd_win_pp", True)}


def _banded_level_args(value, loc, aw, shapes, lid, per_point, int8):
    """The banded kernels' inputs for one level of an encoder call, as
    ``msda._windowed_forward`` makes them, and the clamped share."""
    S = loc.shape[1]
    h, w = shapes[lid]
    segs = segment_bounds(S, shapes)
    locT, awT = msda.rows_t(loc, aw)
    bidx, ix, iy_band, _, aw_eff, inband, in_img = msda.win_level_rows(
        locT, awT, lid, h, w, WINDOW, segs, D, per_point)
    source = value
    if int8:
        source, scale = msda.quantize_levels(value, shapes)
        aw_eff = aw_eff * scale[:, :, lid, None, None]
    start = msda.level_starts(shapes)[lid]
    clamped = 1.0 - inband.sum().item() / max(in_img.sum().item(), 1)
    return (source[:, start:start + h * w], bidx, ix, iy_band, aw_eff, h, w,
            WINDOW, segs, S), clamped


def broadcast_bands(bidx, P):
    """A tile band table [B, H, T] broadcast over P points, [B, H, P, T]:
    the per-point kernels' table for the same bands."""
    B, H_, T = bidx.shape
    return bidx[:, :, None, :].expand(B, H_, P, T).contiguous()


def check_win_kernels(shapes, bucket="serving"):
    """K5 and K6 against their plain version on the banded levels of the
    served encoder call on ``bucket``'s levels, K5 also against K6 on its
    tile bands broadcast over the points; one row per (band, value type),
    times summed over the levels (one launch each)."""
    banded = [l for l, (h, _) in enumerate(shapes) if h > WINDOW]
    rows = []
    for band, (name, per_point) in BANDED.items():
        kernel = getattr(msda_cuda, name)
        for form, dtype, int8 in (("float32", torch.float32, False),
                                  ("bfloat16", torch.bfloat16, False),
                                  ("int8", torch.bfloat16, True)):
            value, loc, aw = raster_inputs(shapes, dtype, seed=len(rows))
            row = {"bucket": bucket, "kernel": name, "band": band,
                   "dtype": form,
                   "levels": banded, "max_abs_err": 0.0,
                   "max_err_over_limit": 0.0, "ms": 0.0, "graph_ms": 0.0,
                   "plain_ms": 0.0, "bound_ms": 0.0, "ms_per_level": [],
                   "graph_ms_per_level": [], "clamped_share": [],
                   "bit_equal_run_to_run": True}
            if not per_point:
                row["bit_equal_to_k6_broadcast"] = True
            for lid in banded:
                args, clamped = _banded_level_args(value, loc, aw, shapes,
                                                   lid, per_point, int8)
                kern = kernel(*args)
                row["bit_equal_run_to_run"] &= torch.equal(kern,
                                                           kernel(*args))
                if not per_point:
                    # K5 is K6 with a band table whose point stride is 0
                    wide = broadcast_bands(args[1], args[2].shape[2])
                    row["bit_equal_to_k6_broadcast"] &= torch.equal(
                        kern, msda_cuda.msda_fwd_win_pp(args[0], wide,
                                                        *args[2:]))
                plain = msda.msda_fwd_win_plain(*args)
                torch.cuda.synchronize()
                if not torch.isfinite(kern).all():
                    raise SystemExit(f"{name} {bucket} {form} level {lid}: "
                                     "non-finite")
                err, over = _f32_err(kern, plain)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["max_err_over_limit"] = max(row["max_err_over_limit"],
                                                over)
                ms = cuda_ms(lambda: kernel(*args), 100)
                row["ms"] += ms
                row["ms_per_level"].append(ms)
                ms = graph_ms(lambda: kernel(*args))
                row["graph_ms"] += ms
                row["graph_ms_per_level"].append(ms)
                row["plain_ms"] += cuda_ms(
                    lambda: msda.msda_fwd_win_plain(*args), 5)
                row["clamped_share"].append(clamped)
                level_ms, by = bound((*args[:5], kern), args[4])
                row["bound_ms"] += level_ms
                row["bound_by"] = by
            atol, rtol = TOL[torch.float32]
            print(f"{name} {bucket} encoder window {WINDOW} levels {banded} "
                  f"{form}: max abs err {row['max_abs_err']:.3e} (err/limit "
                  f"{row['max_err_over_limit']:.3f}, atol {atol} rtol {rtol}); "
                  f"kernel {row['ms']:.4f} ms "
                  f"({[round(m, 4) for m in row['ms_per_level']]} per level; "
                  f"device {row['graph_ms']:.4f} ms in a CUDA graph, "
                  f"{[round(m, 4) for m in row['graph_ms_per_level']]}), "
                  f"plain {row['plain_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); bit-equal "
                  f"run to run {row['bit_equal_run_to_run']}"
                  + ("" if per_point else
                     "; bit-equal to msda_fwd_win_pp on the bands broadcast "
                     f"over the points {row['bit_equal_to_k6_broadcast']}")
                  + "; clamped share of the in-image samples per level "
                  f"{[round(c, 4) for c in row['clamped_share']]}", flush=True)
            if row["max_err_over_limit"] > 1.0:
                raise SystemExit(f"{name} {bucket} {form}: kernel disagrees "
                                 "with the plain version")
            if not row["bit_equal_run_to_run"]:
                raise SystemExit(f"{name} {bucket} {form}: two runs differ")
            if not row.get("bit_equal_to_k6_broadcast", True):
                raise SystemExit(f"{name} {bucket} {form}: differs from "
                                 "msda_fwd_win_pp on the tile bands "
                                 "broadcast over the points")
            rows.append(row)
        # the batch index of the kernel's addressing, on the middle level
        value, loc, aw = raster_inputs(shapes, torch.float32, seed=50)
        value, loc, aw = (torch.cat([t, t.flip(1)]) for t in (value, loc, aw))
        args, _ = _banded_level_args(value, loc.contiguous(), aw, shapes,
                                     banded[len(banded) // 2], per_point,
                                     False)
        _, over = _f32_err(kernel(*args), msda.msda_fwd_win_plain(*args))
        print(f"{name} {bucket} encoder batch 2 float32: err/limit "
              f"{over:.3f}", flush=True)
        if over > 1.0:
            raise SystemExit(f"{name} {bucket} batch 2: kernel disagrees "
                             "with plain")
    return rows


def _banded_bwd_args(value, loc, aw, g, shapes, lid, per_point):
    """The banded backward kernels' inputs for one level of an encoder
    call, as ``msda._windowed_backward`` makes them, and the clamped share
    of the in-image samples."""
    args, clamped = _banded_level_args(value, loc, aw, shapes, lid,
                                       per_point, False)
    return (*args[:5], g, *args[5:]), clamped


def check_bwd_win_kernels(shapes, batch):
    """K7 + K9 and K8 + K10 against their plain version on the banded
    levels of the adaptation's encoder call, K7 and K9 also against K8 and
    K10 on their tile bands broadcast over the points; one row per (band,
    dtype), times summed over the levels (one launch of each kernel per
    level)."""
    banded = [l for l, (h, _) in enumerate(shapes) if h > WINDOW]
    rows = []
    for band, (rows_name, value_name) in BANDED_BWD.items():
        per_point = band == "point"
        rows_kernel = getattr(msda_cuda, rows_name)
        value_kernel = getattr(msda_cuda, value_name)
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, aw = raster_inputs(shapes, dtype, seed=400 + len(rows),
                                           batch=batch)
            g = torch.randn(value.shape[:2] + (H * D,), device=DEVICE,
                            generator=torch.Generator(device=DEVICE)
                            .manual_seed(len(rows))).to(dtype)
            # the layer's float32 value gradient, whose level slices the
            # value kernels add into (msda._windowed_backward)
            dvalue_layer = torch.zeros(value.shape, dtype=torch.float32,
                                       device=DEVICE)
            starts = msda.level_starts(shapes)
            row = {"rows_kernel": rows_name, "value_kernel": value_name,
                   "band": band, "dtype": str(dtype).split(".")[-1],
                   "batch": batch, "levels": banded,
                   "max_abs_err": {}, "max_err_over_limit": {},
                   "rows_ms": 0.0, "rows_graph_ms": 0.0, "value_ms": 0.0,
                   "value_graph_ms": 0.0,
                   "plain_ms": 0.0, "rows_bit_equal_run_to_run": True,
                   "rows_bound_ms": 0.0, "value_bound_ms": 0.0,
                   "value_run_to_run_max_abs_diff": 0.0,
                   "clamped_share": []}
            for lid in banded:
                args, clamped = _banded_bwd_args(value, loc, aw, g, shapes,
                                                 lid, per_point)
                dix, diy, daw = rows_kernel(*args)
                rows_again = rows_kernel(*args)
                dvalue = value_kernel(*args)
                again = value_kernel(*args)
                plain = msda.msda_bwd_win_plain(*args)
                torch.cuda.synchronize()
                for name, k, p in zip(("dvalue", "dix", "diy", "daw"),
                                      (dvalue, dix, diy, daw), plain):
                    if not torch.isfinite(k).all():
                        raise SystemExit(f"{rows_name}/{value_name} {dtype} "
                                         f"level {lid}: non-finite {name}")
                    err, over = _scaled_err(k, p, dtype)
                    row["max_abs_err"][name] = max(
                        row["max_abs_err"].get(name, 0.0), err)
                    row["max_err_over_limit"][name] = max(
                        row["max_err_over_limit"].get(name, 0.0), over)
                row["value_run_to_run_max_abs_diff"] = max(
                    row["value_run_to_run_max_abs_diff"],
                    (dvalue - again).abs().max().item())
                row["rows_bit_equal_run_to_run"] &= all(
                    torch.equal(a, b) for a, b in zip((dix, diy, daw),
                                                      rows_again))
                if not per_point:
                    # K7 and K9 are K8 and K10 with a band table whose point
                    # stride is 0: K7 bit-equal to K8 given the tile bands
                    # for every point, K9 up to the order of its adds
                    wide = broadcast_bands(args[1], args[2].shape[2])
                    wide_args = (args[0], wide, *args[2:])
                    as_k8 = msda_cuda.msda_bwd_win_rows_pp(*wide_args)
                    row["rows_bit_equal_to_k8_broadcast"] = row.get(
                        "rows_bit_equal_to_k8_broadcast", True) and all(
                        torch.equal(a, b)
                        for a, b in zip((dix, diy, daw), as_k8))
                    row["value_max_abs_diff_to_k10_broadcast"] = max(
                        row.get("value_max_abs_diff_to_k10_broadcast", 0.0),
                        (dvalue - msda_cuda.msda_bwd_win_value_pp(
                            *wide_args)).abs().max().item())
                row["rows_ms"] += cuda_ms(lambda: rows_kernel(*args), 50)
                row["rows_graph_ms"] += graph_ms(lambda: rows_kernel(*args))
                h, w = shapes[lid]
                into = dvalue_layer[:, starts[lid]:starts[lid] + h * w]
                row["value_ms"] += cuda_ms(
                    lambda: value_kernel(*args, out=into), 50)
                row["value_graph_ms"] += graph_ms(
                    lambda: value_kernel(*args, out=into))
                row["plain_ms"] += cuda_ms(
                    lambda: msda.msda_bwd_win_plain(*args), 3, warmup=1)
                row["clamped_share"].append(clamped)
                inputs = (*args[:5], g)
                ms, row["rows_bound_by"] = bound(
                    (*inputs, dix, diy, daw), args[4], FLOPS_ROWS)
                row["rows_bound_ms"] += ms
                ms, row["value_bound_by"] = bound(
                    (*inputs[1:], dvalue), args[4], FLOPS_VALUE)
                row["value_bound_ms"] += ms
            atol, rtol = BWD_TOL[dtype]
            print(f"{rows_name} + {value_name} adaptation encoder window "
                  f"{WINDOW} levels {banded} batch {batch} {row['dtype']}: "
                  f"max abs err {row['max_abs_err']} (err/limit "
                  f"{row['max_err_over_limit']}, atol {atol}*max|ref| rtol "
                  f"{rtol}); rows {row['rows_ms']:.4f} ms (device "
                  f"{row['rows_graph_ms']:.4f} ms in a CUDA graph, zeroed "
                  f"outputs included; bound {row['rows_bound_ms']:.4f} ms, "
                  f"{row['rows_bound_by']}; bit-equal run to run "
                  f"{row['rows_bit_equal_run_to_run']}"
                  + ("" if per_point else
                     "; bit-equal to msda_bwd_win_rows_pp on the bands "
                     "broadcast over the points "
                     f"{row['rows_bit_equal_to_k8_broadcast']}") + "), "
                  f"value {row['value_ms']:.4f} ms (device "
                  f"{row['value_graph_ms']:.4f} ms in a CUDA graph, into the "
                  f"layer gradient's slice; bound {row['value_bound_ms']:.4f} "
                  f"ms, {row['value_bound_by']}), "
                  f"plain {row['plain_ms']:.4f} ms; value run-to-run max abs "
                  f"diff {row['value_run_to_run_max_abs_diff']:.3e}"
                  + ("" if per_point else
                     "; value max abs diff to msda_bwd_win_value_pp on the "
                     "bands broadcast over the points "
                     f"{row['value_max_abs_diff_to_k10_broadcast']:.3e}")
                  + "; clamped "
                  f"share per level "
                  f"{[round(c, 4) for c in row['clamped_share']]}", flush=True)
            if max(row["max_err_over_limit"].values()) > 1.0:
                raise SystemExit(f"{rows_name}/{value_name} {dtype}: kernels "
                                 "disagree with the plain version")
            if not row["rows_bit_equal_run_to_run"]:
                raise SystemExit(f"{rows_name} {dtype}: two runs differ")
            if not row.get("rows_bit_equal_to_k8_broadcast", True):
                raise SystemExit(f"{rows_name} {dtype}: differs from "
                                 "msda_bwd_win_rows_pp on the tile bands "
                                 "broadcast over the points")
            rows.append(row)
        # the batch index of the kernels' addressing, on the middle level
        value, loc, aw = raster_inputs(shapes, torch.float32, seed=450)
        g = torch.randn(value.shape[:2] + (H * D,), device=DEVICE)
        value, loc, aw, g = (torch.cat([t, t.flip(1)])
                             for t in (value, loc, aw, g))
        args, _ = _banded_bwd_args(value, loc.contiguous(), aw, g, shapes,
                                   banded[len(banded) // 2], per_point)
        got = (value_kernel(*args), *rows_kernel(*args))
        over = max(_scaled_err(k, p, torch.float32)[1]
                   for k, p in zip(got, msda.msda_bwd_win_plain(*args)))
        print(f"{rows_name} + {value_name} adaptation encoder batch 2 "
              f"float32: err/limit {over:.3f}", flush=True)
        if over > 1.0:
            raise SystemExit(f"{rows_name}/{value_name} batch 2: kernels "
                             "disagree with plain")
    return rows


def _bp_row(label, kern, plain, same, same_name, timed, same_timed, bound_of,
            routed):
    """One K11 call held to its plain version (float32 sums on both sides
    for the float32 and int8 forms; one bf16 rounding of the output for the
    bf16 form) and beside K1 / K4 on the same inputs: bit for bit where the
    form runs that kernel (``routed``: ``msda_cuda.BP_ROUTES``), else the
    same products folded over the points in another order, within the same
    limit."""
    torch.cuda.synchronize()
    if not torch.isfinite(kern.float()).all():
        raise SystemExit(f"msda_fwd_bp {label}: non-finite output")
    dtype = kern.dtype if kern.dtype == torch.bfloat16 else torch.float32
    atol, rtol = TOL[dtype]
    err = (kern.float() - plain.float()).abs()
    over = (err / (atol + rtol * plain.float().abs())).max().item()
    diff = (kern.float() - same.float()).abs()
    same_over = (diff / (atol + rtol * same.float().abs())).max().item()
    row = {"call": label, "max_abs_err": err.max().item(),
           "max_err_over_limit": over, "routed_to": same_name if routed
           else "msda_fwd_bp",
           f"{same_name}_max_abs_diff": diff.max().item(),
           f"{same_name}_diff_over_limit": same_over,
           f"bit_equal_to_{same_name}": torch.equal(kern, same),
           "ms": cuda_ms(timed, 100), f"ms_{same_name}_same_call":
               cuda_ms(same_timed, 100)}
    row["bound_ms"], row["bound_by"] = bound_of(kern)
    print(f"msda_fwd_bp {label}: runs {row['routed_to']}; max abs err "
          f"{row['max_abs_err']:.3e} (err/limit {over:.3f}, atol {atol} rtol "
          f"{rtol}); against {same_name} on the same inputs max abs diff "
          f"{row[f'{same_name}_max_abs_diff']:.3e} (over the same limit "
          f"{same_over:.3f}), bit-equal "
          f"{row[f'bit_equal_to_{same_name}']}; kernel {row['ms']:.4f} ms, "
          f"{same_name} {row[f'ms_{same_name}_same_call']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    if over > 1.0 or same_over > 1.0:
        raise SystemExit(f"msda_fwd_bp {label}: kernel disagrees with the "
                         f"plain version or with {same_name}")
    if routed and not row[f"bit_equal_to_{same_name}"]:
        raise SystemExit(f"msda_fwd_bp {label}: runs {same_name}'s kernel "
                         f"but is not bit-equal to {same_name}")
    return row


def _unaligned(t):
    """``t``'s values in a tensor whose storage starts one element past an
    allocation: a pointer that takes only the narrowest loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_bp_kernel(shapes, train_shapes, batch=2):
    """K11 against its plain version and beside K1 (K4 for the int8 form)
    at the serving and training calls (encoder Q = S, decoder Q = 200) in
    float32 and bfloat16, at a batch of 2; the int8 form on the served
    encoder call's exact level 3 and on the decoder call; the float form on
    a windowed call's exact level (float32 out); the bfloat16 and int8 forms
    on the serving decoder call at three points a level and on values one
    element off their allocation. The bfloat16 and int8 forms run K1's and
    K4's kernels and must give their bits."""
    rows = []

    def float_row(label, value, shp, loc, aw, moved, samples, **kw):
        """``moved``: what the call reads; ``samples``: one weight a summed
        sample."""
        args = (value, shp, loc, aw)
        return _bp_row(
            label, msda_cuda.msda_fwd_bp(*args, **kw),
            msda.msda_fwd_bp_plain(*args, **kw),
            msda_cuda.msda_fwd(*args, **kw), "msda_fwd",
            lambda: msda_cuda.msda_fwd_bp(*args, **kw),
            lambda: msda_cuda.msda_fwd(*args, **kw),
            lambda out: bound((*moved, out), samples),
            msda_cuda.BP_ROUTES[value.dtype] == "msda_fwd") | {
                "plain_ms": cuda_ms(
                    lambda: msda.msda_fwd_bp_plain(*args, **kw), 5)}

    def int8_row(label, vq, scale, loc, aw, levels, moved, samples):
        args = (vq, shapes, loc, aw)
        kw = dict(levels=levels, scale=scale)
        return _bp_row(
            label, msda_cuda.msda_fwd_bp(*args, **kw),
            msda.msda_fwd_bp_plain(*args, **kw),
            msda_cuda.msda_fwd_q(vq, scale, shapes, loc, aw, levels=levels),
            "msda_fwd_q", lambda: msda_cuda.msda_fwd_bp(*args, **kw),
            lambda: msda_cuda.msda_fwd_q(vq, scale, shapes, loc, aw,
                                         levels=levels),
            lambda out: bound((*moved, out), samples),
            msda_cuda.BP_ROUTES[vq.dtype] == "msda_fwd_q") | {
                "plain_ms": cuda_ms(
                    lambda: msda.msda_fwd_bp_plain(*args, **kw), 5)}

    for bucket, shp in (("serving", shapes), ("training", train_shapes)):
        S = sum(h * w for h, w in shp)
        for call, Q in (("encoder", S), ("decoder", DECODER_Q)):
            for dtype in (torch.float32, torch.bfloat16):
                value, loc, aw = msda_inputs(Q, S, dtype, seed=500 + len(rows),
                                             batch=batch)
                row = float_row(
                    f"{bucket} {call} Q={Q} {str(dtype)[6:]} batch {batch}",
                    value, shp, loc, aw, (value, loc, aw), aw)
                row.update(bucket=bucket, Q=Q, form=str(dtype)[6:])
                rows.append(row)
    S = sum(h * w for h, w in shapes)
    exact = tuple(l for l, (h, _) in enumerate(shapes) if h <= WINDOW)
    starts = msda.level_starts(shapes)

    def moved_levels(values, levels, *per_level):
        """What a call on ``levels`` reads: those levels' values and the
        level slices of ``per_level`` (scales, locations, weights)."""
        return [t for l in levels for t in (
            values[:, starts[l]:starts[l] + shapes[l][0] * shapes[l][1]],
            *(x[..., l] if x.dim() == 3 else x[:, :, :, l]
              for x in per_level))]

    for call, Q, levels in (("encoder_served", S, exact),
                            ("decoder", DECODER_Q,
                             tuple(range(len(shapes))))):
        if Q == S:
            value, loc, aw = raster_inputs(shapes, torch.bfloat16,
                                           seed=600 + len(rows), batch=batch)
        else:
            value, loc, aw = msda_inputs(Q, S, torch.bfloat16,
                                         seed=600 + len(rows), batch=batch)
        vq, scale = msda.quantize_levels(value, shapes)
        row = int8_row(
            f"serving {call} Q={Q} levels {list(levels)} int8 batch {batch}",
            vq, scale, loc, aw, levels,
            moved_levels(vq, levels, scale, loc, aw),
            aw[:, :, :, :len(levels)])
        row.update(bucket="serving", Q=Q, form="int8", levels=list(levels))
        rows.append(row)
    # a windowed call's exact level (band="tile"), float32 out
    value, loc, aw = raster_inputs(shapes, torch.bfloat16, seed=700,
                                   batch=batch)
    row = float_row(
        f"serving encoder_windowed Q={S} levels {list(exact)} bfloat16, "
        f"float32 out, batch {batch}", value, shapes, loc, aw,
        moved_levels(value, exact, loc, aw), aw[:, :, :, :len(exact)],
        levels=exact, out_dtype=torch.float32)
    row.update(bucket="serving", Q=S, form="bfloat16_f32_out",
               levels=list(exact))
    rows.append(row)
    # the routed forms where K11's own lane split took no call: three
    # points a level, and values one element off their allocation
    for label, points, shift in (("P=3", 3, False), ("unaligned", P, True)):
        value, loc, aw = msda_inputs(DECODER_Q, S, torch.bfloat16,
                                     seed=710 + len(rows), batch=batch,
                                     points=points)
        vq, scale = msda.quantize_levels(value, shapes)
        if shift:
            value, vq = _unaligned(value), _unaligned(vq)
        row = float_row(f"serving decoder Q={DECODER_Q} {label} bfloat16 "
                        f"batch {batch}", value, shapes, loc, aw,
                        (value, loc, aw), aw)
        row.update(bucket="serving", Q=DECODER_Q, form=f"bfloat16 {label}")
        rows.append(row)
        row = int8_row(f"serving decoder Q={DECODER_Q} {label} int8 batch "
                       f"{batch}", vq, scale, loc, aw, None,
                       (vq, scale, loc, aw), aw)
        row.update(bucket="serving", Q=DECODER_Q, form=f"int8 {label}")
        rows.append(row)
    return rows


# the banded backward kernels (rows, value) per band
BANDED_BWD = {"tile": ("msda_bwd_win_rows", "msda_bwd_win_value"),
              "point": ("msda_bwd_win_rows_pp", "msda_bwd_win_value_pp")}


def kernel_counts():
    return dict(msda_cuda.launches)


def reset_kernel_counts():
    msda_cuda.reset_launches()


def forward_counts(cfg, shapes, batch_p=False):
    """Launches per model forward, from how ``msda.ms_deform_attn`` splits a
    call: per encoder layer one launch per banded level and one for the
    exact levels together; per decoder layer one launch over all levels.
    With ``batch_p`` K11 takes every launch of K1 or K4."""
    n_banded = sum(h > cfg.msda_window for h, _ in shapes) if (
        cfg.msda_window) else 0
    counts = dict.fromkeys(msda_cuda.KERNELS, 0)
    exact = ("msda_fwd_bp" if batch_p else
             "msda_fwd_q" if cfg.msda_int8 else "msda_fwd")
    counts[exact] = (cfg.encoder_layers * int(n_banded < len(shapes))
                     + cfg.decoder_layers)
    counts[BANDED[cfg.msda_band][0]] += cfg.encoder_layers * n_banded
    return counts


def step_counts(cfg, shapes, batch_p=False):
    """Launches per microbatch of a train step: the forward's and the
    backward's, which ``msda._windowed_backward`` splits the same way (per
    encoder layer one launch each of the banded rows and value kernels per
    banded level and one each of K2 and K3 for the exact levels together;
    per decoder layer one each of K2 and K3). The backward does not read
    ``batch_p``."""
    counts = forward_counts(cfg, shapes, batch_p)
    n_banded = sum(h > cfg.msda_window for h, _ in shapes) if (
        cfg.msda_window) else 0
    exact_calls = (cfg.encoder_layers * int(n_banded < len(shapes))
                   + cfg.decoder_layers)
    counts["msda_bwd_rows"] += exact_calls
    counts["msda_bwd_value"] += exact_calls
    for name in BANDED_BWD[cfg.msda_band]:
        counts[name] += cfg.encoder_layers * n_banded
    return counts


def serve(cfg, label, n_requests):
    """The main path: requests through infer.infer at full width."""
    model, x = infer.build(cfg, 1, *infer.BUCKET_HW, seed=0)
    reset_kernel_counts()
    times, packed = infer.time_requests(model, x, n_requests, warmup=2)
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    counts = kernel_counts()
    forwards = n_requests + 2 + 1
    per_forward = forward_counts(
        cfg, level_shapes(infer.BUCKET_HW, cfg.num_feature_levels))
    Q, C, R = cfg.num_queries, cfg.num_labels, cfg.num_rel_labels
    k = min(100, Q * Q)
    expect = {"logits": (1, Q, C), "pred_boxes": (1, Q, 4),
              "pred_rel": (1, Q, Q, R), "pred_connectivity": (1, Q, Q, 1)}
    for key, shape in expect.items():
        if tuple(out[key].shape) != shape:
            raise SystemExit(f"{key}: shape {tuple(out[key].shape)} != {shape}")
        if not torch.isfinite(out[key]).all():
            raise SystemExit(f"{key}: non-finite values")
    n_packed = 3 * k + k + 2 * k + k * R + Q + Q + 4 * Q
    if packed.shape != (n_packed,) or not torch.isfinite(packed).all():
        raise SystemExit(f"packed output: shape {tuple(packed.shape)} "
                         f"(expected {n_packed}) or non-finite values")
    hw = "x".join(map(str, infer.BUCKET_HW))
    launched = {k: v for k, v in counts.items() if v}
    print(f"serve {label} (window {cfg.msda_window}, band {cfg.msda_band}, "
          f"int8 {cfg.msda_int8}) {cfg.compute_dtype} {hw} b1: {n_requests} "
          f"requests, ms/request mean "
          f"{sum(times) / len(times):.3f} min {min(times):.3f} max "
          f"{max(times):.3f}; launches {launched} over {forwards} forwards",
          flush=True)
    for name, n in counts.items():
        if n != per_forward[name] * forwards:
            raise SystemExit(f"serve {label}: {name} launched {n} times, "
                             f"expected {per_forward[name] * forwards} "
                             f"({per_forward[name]} per forward)")
    return counts, times, model, x


def time_side_by_side(models, x, rounds):
    """Requests of several configurations in turns (one request each per
    round), so that a slow spell of the host falls on all of them: ms per
    request from CUDA events, per label."""
    times = {label: [] for label in models}
    for _ in range(rounds):
        for label, model in models.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            infer.infer(model, x)
            end.record()
            end.synchronize()
            times[label].append(start.elapsed_time(end))
    return times


def plain_copy(model, cfg, device):
    """The same weights in a model whose MSDA takes the kernels' plain
    versions on any device."""
    copy = EgtrModel(cfg)
    copy.load_state_dict(model.state_dict(), strict=True)
    for module in copy.modules():
        if isinstance(module, MSDeformableAttention):
            module.msda_impl = "plain"
    return copy.to(device)


def compare_f32(cfg, label, limit):
    """Same float32 weights, kernel path against the plain-MSDA path, and
    the kernel path again with ``batch_p`` (K11 for K1 / K4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.replace(compute_dtype="float32")
    model_k, x = infer.build(cfg, 1, *infer.BUCKET_HW, seed=0)
    _noise_msda_heads(model_k, x.device)
    model_p = plain_copy(model_k, cfg, x.device).eval()
    shapes = level_shapes(infer.BUCKET_HW, cfg.num_feature_levels)
    per_forward = forward_counts(cfg, shapes)
    outs, bands = [], []
    for model, expect, batch_p in (
            (model_k, per_forward, False),
            (model_p, dict.fromkeys(per_forward, 0), False),
            (model_k, forward_counts(cfg, shapes, batch_p=True), True)):
        reset_kernel_counts()
        msda.band_index_log = []
        old_flag, msda.FWD_BATCH_P = msda.FWD_BATCH_P, batch_p
        try:
            with torch.inference_mode():
                outs.append(model(x))
        finally:
            msda.FWD_BATCH_P = old_flag
            bands.append(msda.band_index_log)
            msda.band_index_log = None
        if kernel_counts() != expect:
            raise SystemExit(f"f32 {label} (batch_p {batch_p}) launches "
                             f"{kernel_counts()}, expected {expect}")
    out_k, out_p, out_bp = outs
    differing = sum(int((a != b).sum()) for (_, a), (_, b) in zip(*bands[:2]))
    total = sum(a.numel() for _, a in bands[0])
    errs, errs_bp = {}, {}
    for key in ("logits", "pred_boxes", "pred_rel"):
        errs[key] = (out_k[key] - out_p[key]).abs().max().item()
        errs_bp[key] = (out_bp[key] - out_p[key]).abs().max().item()
    print(f"model f32 {label} kernels vs plain MSDA: max abs err {errs} "
          f"(atol {limit}); {differing} of {total} band indices differ; "
          f"with batch_p (K11) vs plain: {errs_bp}", flush=True)
    if max(errs.values()) > limit or max(errs_bp.values()) > limit or not all(
            torch.isfinite(o[k]).all() for o in (out_k, out_bp)
            for k in errs):
        raise SystemExit(f"float32 {label} model: kernel path disagrees with "
                         "plain")
    errs["band_indices_differing"] = differing
    errs["band_indices"] = total
    errs["batch_p"] = errs_bp
    return errs


def serve_batch_p(models, x):
    """The served forward with the flag on (what EGTR_MSDA_BATCH_P=1 sets
    at import): one request of each configuration through ``infer.infer``
    and one forward, K11 in place of every K1 / K4 launch; the outputs bit
    for bit those of the same model's flag-off forward on the same input,
    since K11's bfloat16 and int8 forms run K1's and K4's kernels."""
    results = {}
    shapes = level_shapes(infer.BUCKET_HW, 4)
    for label, model in models.items():
        cfg = model.config
        with torch.inference_mode():
            off = model(x)
        reset_kernel_counts()
        old_flag, msda.FWD_BATCH_P = msda.FWD_BATCH_P, True
        try:
            packed = infer.infer(model, x)
            with torch.inference_mode():
                on = model(x)
            torch.cuda.synchronize()
        finally:
            msda.FWD_BATCH_P = old_flag
        counts = kernel_counts()
        per_forward = forward_counts(cfg, shapes, batch_p=True)
        keys = ("logits", "pred_boxes", "pred_rel")
        errs = {k: (on[k].float() - off[k].float()).abs().max().item()
                for k in keys}
        equal = all(torch.equal(on[k], off[k]) for k in keys)
        print(f"serve {label} with batch_p: launches per forward "
              f"{ {k: v // 2 for k, v in counts.items() if v} }; outputs "
              f"bit-equal to the flag-off forward {equal} (max abs diff "
              f"{errs})", flush=True)
        for name, n in counts.items():
            if n != 2 * per_forward[name]:
                raise SystemExit(f"serve {label} with batch_p: {name} "
                                 f"launched {n} times in 2 forwards, "
                                 f"expected {2 * per_forward[name]}")
        if not torch.isfinite(packed).all() or not equal:
            raise SystemExit(f"serve {label} with batch_p: outputs differ "
                             "from the flag-off forward")
        results[label] = {"counts": counts, "max_abs_diff": errs,
                          "bit_equal_flag_off": equal}
    return results


def _scaled_err(got, ref, dtype):
    """Largest |got - ref| over the limit atol*max|ref| + rtol*|ref|."""
    atol, rtol = BWD_TOL[dtype]
    ref = ref.float()
    err = (got.float() - ref).abs()
    limit = atol * max(1.0, ref.abs().max().item()) + rtol * ref.abs()
    return err.max().item(), (err / limit).max().item()


def _bwd_row(bucket, call, Q, value, shapes, loc, aw, g):
    """K2 and K3 at one call: held to the plain backward, K2 bit-equal over
    two runs, both timed beside the plain backward and the autograd
    backward of the grid_sample composite."""
    args = (value, shapes, loc, aw, g)
    dtype = value.dtype
    dloc, daw = msda_cuda.msda_bwd_rows(*args)
    dloc2, daw2 = msda_cuda.msda_bwd_rows(*args)
    dvalue = msda_cuda.msda_bwd_value(*args)
    again = msda_cuda.msda_bwd_value(*args)
    pv, pl, pa = msda.ms_deform_attn_plain_bwd(*args)
    leaves = [t.detach().clone().requires_grad_() for t in (value, loc, aw)]
    composite = composite_msda(leaves[0], shapes, leaves[1], leaves[2])
    torch.cuda.synchronize()
    errs = {n: _scaled_err(k, p, dtype) for n, k, p in (
        ("dvalue", dvalue, pv), ("dloc", dloc, pl), ("daw", daw, pa))}
    row = {
        "bucket": bucket, "call": call, "Q": Q, "batch": value.shape[0],
        "dtype": str(dtype).split(".")[-1],
        "max_abs_err": {n: e[0] for n, e in errs.items()},
        "max_err_over_limit": {n: e[1] for n, e in errs.items()},
        "rows_bit_equal_run_to_run": torch.equal(dloc, dloc2)
        and torch.equal(daw, daw2),
        "value_run_to_run_max_abs_diff":
            (dvalue.float() - again.float()).abs().max().item(),
        "rows_ms": cuda_ms(lambda: msda_cuda.msda_bwd_rows(*args), 50),
        "rows_graph_ms": graph_ms(lambda: msda_cuda.msda_bwd_rows(*args)),
        "value_ms": cuda_ms(lambda: msda_cuda.msda_bwd_value(*args), 50),
        "value_graph_ms": graph_ms(lambda: msda_cuda.msda_bwd_value(*args)),
        # the plain backward computes all three gradients in one call
        "plain_ms": cuda_ms(lambda: msda.ms_deform_attn_plain_bwd(*args), 3,
                            warmup=1),
        # the composite's autograd backward computes all three too (K2 + K3)
        "library_composite_ms": cuda_ms(lambda: torch.autograd.grad(
            composite, leaves, g, retain_graph=True), 5, warmup=1),
    }
    row["rows_bound_ms"], row["rows_bound_by"] = bound(
        (value, loc, aw, g, dloc, daw), aw, FLOPS_ROWS)
    row["value_bound_ms"], row["value_bound_by"] = bound(
        (loc, aw, g, dvalue), aw, FLOPS_VALUE)
    row["rows_gather_bytes"] = gather_bytes(aw, value)
    row["rows_gather_GBps_L2"] = row["rows_gather_bytes"] / row["rows_ms"] / 1e6
    atol, rtol = BWD_TOL[dtype]
    print(f"msda_bwd {bucket} {call} Q={Q} B={row['batch']} {row['dtype']}: "
          f"max abs "
          f"err {row['max_abs_err']} (err/limit "
          f"{row['max_err_over_limit']}, atol {atol}*max|ref| rtol "
          f"{rtol}); rows {row['rows_ms']:.4f} ms (device "
          f"{row['rows_graph_ms']:.4f} ms in a CUDA graph; bound "
          f"{row['rows_bound_ms']:.4f} ms, {row['rows_bound_by']}; corner "
          f"gathers {row['rows_gather_bytes'] / 1e6:.1f} MB, "
          f"{row['rows_gather_GBps_L2']:.0f} GB/s of L2 gather traffic, not a "
          f"roofline share; bit-equal run to run "
          f"{row['rows_bit_equal_run_to_run']}), value "
          f"{row['value_ms']:.4f} ms (device {row['value_graph_ms']:.4f} ms "
          f"in a CUDA graph, zeroing and cast included; bound "
          f"{row['value_bound_ms']:.4f} ms, {row['value_bound_by']}), plain "
          f"backward {row['plain_ms']:.4f} "
          f"ms, grid_sample composite's backward "
          f"{row['library_composite_ms']:.4f} ms; value kernel run-to-run "
          f"max abs diff {row['value_run_to_run_max_abs_diff']:.3e}",
          flush=True)
    for t in (dvalue, dloc, daw):
        if not torch.isfinite(t.float()).all():
            raise SystemExit(f"msda_bwd {call} {dtype}: non-finite")
    if max(row["max_err_over_limit"].values()) > 1.0:
        raise SystemExit(f"msda_bwd {call} {dtype}: kernels disagree "
                         "with the plain backward")
    if not row["rows_bit_equal_run_to_run"]:
        raise SystemExit(f"msda_bwd_rows {call} {dtype}: two runs differ")
    return row


def check_bwd_kernels(shapes, bucket):
    """K2 and K3 against the plain backward at every call of EXACT_CALLS in
    the training bucket."""
    S = sum(h * w for h, w in shapes)
    rows = []
    for n, (call, batch, dtype) in enumerate(exact_calls()):
        seed = (150 if call == "encoder_raster" else 100) + n
        Q, value, loc, aw = exact_call_inputs(shapes, call, batch, dtype,
                                              seed)
        g = grad_output(batch, Q, dtype, n)
        rows.append(_bwd_row(bucket, call, Q, value, shapes, loc, aw, g))
    # the batch index of the kernels' addressing, on two mirrored images
    value, loc, aw = msda_inputs(200, S, torch.float32, seed=200)
    g = torch.randn((1, 200, H * D), device=DEVICE)
    value, loc, aw, g = (torch.cat([t, t.flip(1)]) for t in (value, loc, aw, g))
    got = msda_cuda.msda_bwd(value, shapes, loc, aw, g)
    ref = msda.ms_deform_attn_plain_bwd(value, shapes, loc, aw, g)
    over = max(_scaled_err(k, p, torch.float32)[1] for k, p in zip(got, ref))
    print(f"msda_bwd {bucket} decoder batch 2 float32: err/limit {over:.3f}",
          flush=True)
    if over > 1.0:
        raise SystemExit("msda_bwd batch 2: kernels disagree with plain")
    return rows


def check_int8_grad(shapes):
    """One forward + backward of the int8 op without a window (bfloat16,
    encoder call): K4 forward, K2 and K3 backward, one launch each, and the
    exact op's gradients (straight-through)."""
    S = sum(h * w for h, w in shapes)
    value, loc, aw = msda_inputs(S, S, torch.bfloat16, seed=300)
    g = torch.randn((1, S, H * D), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(301)
                    ).bfloat16()
    grads, counts = {}, {}
    for int8 in (True, False):
        leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
        reset_kernel_counts()
        out = msda.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2],
                                  int8=int8)
        grads[int8] = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        counts[int8] = {k: v for k, v in kernel_counts().items() if v}
    expect = {"msda_fwd_q": 1, "msda_bwd_rows": 1, "msda_bwd_value": 1}
    if counts[True] != expect:
        raise SystemExit(f"int8 forward + backward launched {counts[True]}, "
                         f"expected {expect}")
    # the row kernel is deterministic; the value kernel's atomics are not
    (dv_q, dl_q, da_q), (dv, dl, da) = grads[True], grads[False]
    err, over = _scaled_err(dv_q, dv, torch.bfloat16)
    print(f"int8 op without a window, forward + backward: launches "
          f"{counts[True]} (exact op: {counts[False]}); dloc and daw equal "
          f"to the exact op's: {torch.equal(dl_q, dl) and torch.equal(da_q, da)}"
          f"; dvalue max abs diff {err:.3e} (err/limit {over:.3f}, the value "
          "kernel's float32 atomics)", flush=True)
    if not (torch.equal(dl_q, dl) and torch.equal(da_q, da)) or over > 1.0:
        raise SystemExit("int8 op: gradients differ from the exact op's")
    return counts[True]


def _noise_msda_heads(model, device, seed=1):
    """Random init zeroes the offset and weight kernels, so sampling would
    not depend on the image; give them seeded noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("sampling_offsets.weight",
                              "attention_weights.weight")):
                p.normal_(0.0, 0.1, generator=g)


def train(cfg, label, hw, batch_size, steps, lrs=perf_train_step.LRS,
          accum=False):
    """A training main path: the train probe's step at full width, ``steps``
    steps on a batch of ``batch_size`` at ``hw`` and, with ``accum``, one
    accumulated step (accum 2 over twice the batch). Checks the metrics, the
    parameters and each microbatch's launches (``step_counts``)."""
    model, optimizer, generator = perf_train_step.build(cfg, DEVICE, seed=0,
                                                        lrs=lrs)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = perf_train_step.synthetic_batch(cfg, batch_size, *hw, DEVICE,
                                            seed=0)
    step = make_train_step(model, cfg, optimizer, task="sgg")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    times, metrics = perf_train_step.time_steps(step, batch, generator,
                                                steps, DEVICE)
    results = {"step": metrics}
    microbatches = steps
    accum_times = []
    if accum:
        step_accum = make_train_step(model, cfg, optimizer, task="sgg",
                                     accum_steps=2)
        batch2 = perf_train_step.synthetic_batch(cfg, 2 * batch_size, *hw,
                                                 DEVICE, seed=1)
        accum_times, results["accumulated step"] = perf_train_step.time_steps(
            step_accum, batch2, generator, 1, DEVICE)
        microbatches += 2
    counts = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_microbatch = step_counts(cfg, level_shapes(hw, cfg.num_feature_levels))
    launched = {k: v for k, v in counts.items() if v}
    print(f"train {label} (window {cfg.msda_window}, band {cfg.msda_band}, "
          f"int8 {cfg.msda_int8}) {cfg.compute_dtype} {hw[0]}x{hw[1]} "
          f"b{batch_size}: {steps} steps, ms/step "
          f"{[round(t, 1) for t in times]} (the first builds cuDNN's plans)"
          + (f"; accumulated step (accum 2, batch {2 * batch_size}) "
             f"{accum_times[0]:.1f} ms" if accum else "")
          + f"; max memory allocated {peak_gb:.2f} GB; launches {launched} "
          f"over {microbatches} microbatches; "
          + "; ".join(f"{name} total_loss {m['total_loss']:.4f} grad_norm "
                      f"{m['grad_norm']:.4f}" for name, m in results.items()),
          flush=True)
    for name, m in results.items():
        bad = [k for k, v in m.items() if v != v or v in (float("inf"),
                                                         float("-inf"))]
        if bad:
            raise SystemExit(f"train {label} {name}: non-finite metrics {bad}")
        if not m["grad_norm"] > 0:
            raise SystemExit(f"train {label} {name}: grad_norm "
                             f"{m['grad_norm']}")
        expect = {"total_loss", "grad_norm", "loss_rel", "loss_connectivity",
                  f"rel_gate_{cfg.decoder_layers}"}
        if cfg.auxiliary_loss:
            expect.add(f"loss_ce_{cfg.decoder_layers - 2}")
        if not expect <= set(m):
            raise SystemExit(f"train {label} {name}: metrics lack "
                             f"{sorted(expect - set(m))}")
    for kernel, n in counts.items():
        if n != per_microbatch[kernel] * microbatches:
            raise SystemExit(
                f"train {label}: {kernel} launched {n} times, expected "
                f"{per_microbatch[kernel] * microbatches} "
                f"({per_microbatch[kernel]} per microbatch)")
    moved = {group: [0, 0] for group in ("main", "backbone", "initialized")}
    for name, p in model.named_parameters():
        group = optimizer.labels[name]
        if group == "frozen":
            if not torch.equal(p, old[name]):
                raise SystemExit(f"train {label}: frozen parameter {name} "
                                 "changed")
        else:
            moved[group][0] += int(not torch.equal(p, old[name]))
            moved[group][1] += 1
        if not torch.isfinite(p).all():
            raise SystemExit(f"train {label}: parameter {name} is not finite")
    print(f"train {label}: parameters moved per group (moved, all) {moved}; "
          f"frozen leaves bit-identical", flush=True)
    for group, (n_moved, n_all) in moved.items():
        # a leaf whose gradient is exactly zero gets no Adam step
        if n_moved < 0.9 * n_all:
            raise SystemExit(f"train {label}: only {n_moved} of {n_all} "
                             f"{group} parameters moved")
    return {"counts": counts, "per_microbatch": per_microbatch,
            "ms_per_step": times, "accumulated_step_ms": accum_times,
            "max_memory_allocated_gb": peak_gb}


def _largest_grad_err(grads, ref, label):
    """(largest |grad - ref| over ref's largest entry, over all parameters;
    that parameter's name)."""
    worst, worst_name = 0.0, ""
    for name, gp in ref.items():
        gk = grads[name]
        if gk is None or gp is None:
            if gk is not gp:
                raise SystemExit(f"f32 train {label}: gradient of {name} "
                                 "missing on one path")
            continue
        if not torch.isfinite(gk).all():
            raise SystemExit(f"f32 train {label}: non-finite gradient of "
                             f"{name}")
        err = (gk - gp).abs().max().item() / max(gp.abs().max().item(), 1e-12)
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name


def compare_train_f32(cfg, label, hw, batch_size, limit):
    """One float32 forward + backward (TF32 off, dropout 0) of a training
    model through the kernels and through their plain versions: total loss,
    every parameter's gradient (relative to its largest entry, within
    ``limit``), and the band indices of a windowed model. Beside it, the
    model's own sensitivity: the plain path again with the pixels times
    (1 + 1.2e-7 noise), about one float32 step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.replace(compute_dtype="float32", dropout=0.0)
    model_k, _, _ = perf_train_step.build(cfg, DEVICE, seed=0)
    _noise_msda_heads(model_k, DEVICE)
    model_p = plain_copy(model_k, cfg, DEVICE)
    batch = perf_train_step.synthetic_batch(cfg, batch_size, *hw, DEVICE,
                                            seed=0)
    pixels = batch["pixel_values"]
    nudged = pixels * (1.0 + 1.2e-7 * torch.randn(
        pixels.shape, device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(2)))
    per_pass = step_counts(cfg, level_shapes(hw, cfg.num_feature_levels))
    zero = dict.fromkeys(per_pass, 0)
    results, bands = [], []
    for model, x, expect in ((model_k, pixels, per_pass),
                             (model_p, pixels, zero), (model_p, nudged, zero)):
        model.train()
        model.zero_grad(set_to_none=True)
        reset_kernel_counts()
        msda.band_index_log = []
        try:
            out = model(x, batch["pixel_mask"])
            total, _ = criterion.sgg_criterion(out, batch["labels"], cfg,
                                               train=True)
            total.backward()
            torch.cuda.synchronize()
        finally:
            bands.append(msda.band_index_log)
            msda.band_index_log = None
        if kernel_counts() != expect:
            raise SystemExit(f"f32 train {label} launches {kernel_counts()}, "
                             f"expected {expect}")
        results.append((total.item(), {n: p.grad for n, p in
                                       model.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p), (_, grads_n) = results
    differing = sum(int((a != b).sum()) for (_, a), (_, b) in zip(*bands[:2]))
    n_bands = sum(a.numel() for _, a in bands[0])
    worst, worst_name = _largest_grad_err(grads_k, grads_p, label)
    nudge, nudge_name = _largest_grad_err(grads_n, grads_p, label)
    limit = max(limit, FLIPPED_BAND_GRAD_RTOL) if differing else limit
    print(f"train f32 {label} kernels vs plain ({cfg.encoder_layers}+"
          f"{cfg.decoder_layers} layers, window {cfg.msda_window}, band "
          f"{cfg.msda_band}, {hw[0]}x{hw[1]} b{batch_size}): total loss "
          f"{loss_k:.6f} vs {loss_p:.6f}; largest gradient error relative to "
          f"the gradient's largest entry {worst:.3e} ({worst_name}), over "
          f"{len(grads_p)} parameters (rtol {limit}); {differing} of "
          f"{n_bands} band indices differ; the plain path with the pixels "
          f"times (1 + 1.2e-7 noise) moves by {nudge:.3e} ({nudge_name})",
          flush=True)
    if abs(loss_k - loss_p) > 1e-4 * abs(loss_p) or worst > limit:
        raise SystemExit(f"float32 train step {label}: kernel path disagrees "
                         "with the plain versions")
    return {"loss_kernels": loss_k, "loss_plain": loss_p,
            "max_grad_rel_err": worst, "band_indices_differing": differing,
            "band_indices": n_bands, "nudged_pixels_max_grad_rel_change": nudge}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _driver_forwards(args):
    """Forwards of one driver run: per phase, every microbatch of every
    optimizer step and every validation batch; then the test images, one
    per batch."""
    batch, accum = (int(args[args.index(k) + 1])
                    for k in ("--batch_size", "--accumulate"))
    steps = SYNTH_VG["n_train"] // (batch * accum)
    val_batches = -(-SYNTH_VG["n_val"] // batch)
    microbatches = 2 * steps * accum
    return microbatches + 2 * val_batches + SYNTH_VG["n_test"], microbatches


@contextlib.contextmanager
def recorded_entries(cls=SceneGraphEvaluator, calls=None):
    """Each image's prediction entry (top-k pairs, their predicate scores,
    boxes, classes) as an SGG evaluator class ``cls`` receives it, once per
    image (the per-predicate evaluators see the same entry again); with a
    list ``calls``, also every call, as (evaluator, gt entry, prediction
    entry, keywords)."""
    log = []
    real = cls.evaluate_entry

    def evaluate_entry(self, gt_entry, pred_entry, *args, **kw):
        if not log or log[-1] is not pred_entry:
            log.append(pred_entry)
        if calls is not None:
            calls.append((self, gt_entry, pred_entry, kw))
        return real(self, gt_entry, pred_entry, *args, **kw)

    cls.evaluate_entry = evaluate_entry
    try:
        yield log
    finally:
        cls.evaluate_entry = real


def planted_gt(pred_entry):
    """A ground truth of the triplets at PLANTED_RANKS of an image's own
    ranking, under its top predicate: the traffic of a model that finds
    them, where every gt triplet has predictions with its labels to match
    boxes against."""
    ranks = [r for r in PLANTED_RANKS if r < len(pred_entry["pred_rel_inds"])]
    pairs = np.asarray(pred_entry["pred_rel_inds"])[ranks]
    predicates = np.asarray(pred_entry["rel_scores"])[ranks].argmax(1)
    objects = sorted(set(pairs.ravel().tolist()))
    index = {q: i for i, q in enumerate(objects)}
    return {"gt_relations": np.array([[index[s], index[o], p] for (s, o), p
                                      in zip(pairs.tolist(), predicates)]),
            "gt_boxes": np.asarray(pred_entry["pred_boxes"], float)[objects],
            "gt_classes": np.asarray(pred_entry["pred_classes"])[objects]}


def time_sg_eval(calls, rounds=SG_EVAL_ROUNDS):
    """The SGG evaluators' work of one evaluation run (``calls`` from
    ``recorded_entries``, replayed on fresh evaluators), as recorded and
    with each call's ground truth planted from its predictions
    (``planted_gt``), its triplets matched by the native kernel and by the
    numpy loop, its plain version: host ms per replay (the least of
    ``rounds``), whether both give the same recalls, and the largest
    recall."""
    paths = {"native": sg_eval._compute_pred_matches,
             "numpy": sg_eval._compute_pred_matches_plain}
    traffic = {"recorded": calls,
               "planted": [(evaluator, planted_gt(pred_entry), pred_entry, kw)
                           for evaluator, _, pred_entry, kw in calls]}
    out = {"calls": len(calls)}
    for name, replay in traffic.items():
        ms, recalls = {}, {}
        for label, match in paths.items():
            sg_eval._compute_pred_matches = match
            try:
                for _ in range(rounds):
                    fresh = {}
                    t0 = time.perf_counter()
                    for evaluator, gt_entry, pred_entry, kw in replay:
                        fresh.setdefault(id(evaluator), SceneGraphEvaluator(
                            evaluator.multiple_preds,
                            tuple(evaluator.recalls))
                        ).evaluate_entry(gt_entry, pred_entry, **kw)
                    t = 1e3 * (time.perf_counter() - t0)
                    ms[label] = min(ms.get(label, t), t)
            finally:
                sg_eval._compute_pred_matches = paths["native"]
            recalls[label] = [e.recalls for e in fresh.values()]
        out[name] = {
            "native_ms": ms["native"], "numpy_ms": ms["numpy"],
            "same_recalls": recalls["native"] == recalls["numpy"],
            "max_recall": max(r for e in recalls["native"]
                              for v in e.values() for r in v)}
    return out


def same_entries(a, b) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def driver_paths(workdir):
    """The synthetic VG set and the training driver's output path."""
    return f"{workdir}/vg", f"{workdir}/run"


def _phase_records(out, phase):
    """A phase's train and val records from its metrics.jsonl, and whether
    both kinds are there with every loss finite."""
    records = _records(f"{out}/{phase}/metrics.jsonl")
    train = [r for r in records if r["phase"] == "train"]
    val = [r for r in records if r["phase"] == "val"]
    losses = [v for r in train + val for k, v in r.items() if "loss" in k]
    return train, val, bool(train and val and all(
        math.isfinite(v) for v in losses))


def drive_trainer(workdir):
    """The training driver's main path, in-process, with the flag on: a
    synthetic VG set, ``train_egtr.main`` (two phases, checkpoints, the
    artifact, the SGG + COCO test evaluation), the artifact reloaded, and
    a relaunch on the same output path that resumes and takes no step."""
    from egtr_tpu_torch.scripts import train_egtr
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg
    from egtr_tpu_torch.train.checkpoint import load_pretrained

    data, out = driver_paths(workdir)
    t0 = time.perf_counter()
    make_synth_vg(data, seed=0, **SYNTH_VG)
    t_data = time.perf_counter() - t0
    argv = ["--data_path", data, "--output_path", out, "--device", DEVICE,
            *DRIVER_ARGS]
    old_flag, msda.FWD_BATCH_P = msda.FWD_BATCH_P, True
    try:
        reset_kernel_counts()
        t0 = time.perf_counter()
        with recorded_entries() as entries:
            model = train_egtr.main(argv)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = kernel_counts()
        # the artifact reloads into the same forward, bit for bit
        cfg, sd = load_pretrained(f"{out}/artifact", map_location=DEVICE)
        reloaded = EgtrModel(cfg)
        reloaded.load_state_dict(sd, strict=True)
        reloaded = reloaded.to(DEVICE).eval()
        x = torch.randn((1, 800, 1344, 3), device=DEVICE,
                        generator=torch.Generator(device=DEVICE).manual_seed(3))
        with torch.inference_mode():
            a, b = model.eval()(x), reloaded(x)
        bit_equal = all(torch.equal(a[k], b[k]) for k in (
            "logits", "pred_boxes", "pred_rel", "pred_connectivity"))
        del reloaded, a, b
        before = kernel_counts()
        t0 = time.perf_counter()
        train_egtr.main(argv)
        torch.cuda.synchronize()
        t_relaunch = time.perf_counter() - t0
        after = kernel_counts()
    finally:
        msda.FWD_BATCH_P = old_flag
    per_forward = forward_counts(
        model.config, level_shapes(perf_train_step.BUCKET_HW,
                                   model.config.num_feature_levels),
        batch_p=True)["msda_fwd_bp"]
    forwards, microbatches = _driver_forwards(DRIVER_ARGS)
    expect = dict.fromkeys(msda_cuda.KERNELS, 0)
    expect.update(msda_fwd_bp=per_forward * forwards,
                  msda_bwd_rows=per_forward * microbatches,
                  msda_bwd_value=per_forward * microbatches)
    phases, bad = {}, []
    for phase in ("main", "finetune"):
        train, val, ok = _phase_records(out, phase)
        if not ok:
            bad.append(f"{phase}: {len(train)} train and {len(val)} val "
                       "records, or a non-finite loss")
        phases[phase] = {
            "epoch_seconds": [r["epoch_seconds"] for r in val],
            "step_ms": [1e3 * r["step_seconds"] for r in train],
            "train_total_loss": [r["total_loss"] for r in train],
            "validation_total_loss": [r["validation_total_loss"]
                                      for r in val]}
    with open(f"{out}/metrics_test.json") as f:
        test = json.load(f)
    keys = RECALL_KEYS + [k for k in test if k.startswith("coco/")]
    if not all(k in test and math.isfinite(test[k]) for k in keys) or len(
            keys) < 7:
        bad.append(f"metrics_test.json lacks finite {keys}: {test}")
    artifact = sorted(os.listdir(f"{out}/artifact"))
    if artifact != ["config.json", "weights.pt"]:
        bad.append(f"artifact holds {artifact}")
    step_ms = [t for p in phases.values() for t in p["step_ms"]]
    print(f"driver (train_egtr.main, batch_p on; {SYNTH_VG}, "
          f"{' '.join(DRIVER_ARGS)}): data written in {t_data:.1f} s; run "
          f"{t_run:.1f} s, epochs "
          f"{ {p: [round(t, 1) for t in v['epoch_seconds']] for p, v in phases.items()} } s"
          f", ms per optimizer step {[round(t, 1) for t in step_ms]} (mean "
          f"{sum(step_ms) / len(step_ms):.1f}); launches "
          f"{ {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in expect.items() if v} }); losses "
          f"{ {p: v['validation_total_loss'] for p, v in phases.items()} }; "
          f"test metrics {test}; artifact reloaded bit-equal: {bit_equal}; "
          f"relaunch {t_relaunch:.1f} s, launches "
          f"{ {k: after[k] - before[k] for k in after if after[k] != before[k]} }",
          flush=True)
    if counts != expect:
        raise SystemExit(f"driver: launches {counts}, expected {expect}")
    if bad:
        raise SystemExit(f"driver: {bad}")
    if not bit_equal:
        raise SystemExit("driver: the reloaded artifact's forward differs")
    relaunch = {k: after[k] - before[k] for k in after}
    if relaunch != {**dict.fromkeys(after, 0),
                    "msda_fwd_bp": per_forward * SYNTH_VG["n_test"]}:
        raise SystemExit(f"driver relaunch: launches {relaunch}: it must "
                         "resume and take no step, only the test evaluation")
    return {"counts": counts, "phases": phases, "seconds": t_run,
            "relaunch_seconds": t_relaunch, "data_seconds": t_data,
            "mean_step_ms": sum(step_ms) / len(step_ms), "test": test,
            "entries": entries}


def _test_bucket(data, cfg):
    """The padded (H, W) of the test split's first batch, as the drivers'
    loaders make it."""
    from egtr_tpu_torch.data.loader import Loader
    from egtr_tpu_torch.data.visual_genome import VGDataset

    batch = next(iter(Loader(VGDataset(data, "test", size=800,
                                       max_size=1333), 1, shuffle=False,
                             max_gt=cfg.max_gt_boxes,
                             num_rel_labels=cfg.num_rel_labels,
                             num_workers=1)))
    return tuple(batch["pixel_values"].shape[1:3])


def drive_evaluate(workdir, driver):
    """The evaluation driver's main path, in-process, with the flag off, on
    phase 17's artifact and test split: first K4, K5 and K6 held against
    their plain versions at the test bucket's levels, the served run's
    shapes; then the exact run, whose R@K and mR@K, and each image's top-k
    triplets, must be phase 17's, and whose SGG-evaluator work is replayed
    with the native matcher and with the numpy loop; the served
    configuration's overrides; and the FPS loop."""
    from egtr_tpu_torch.config import EgtrConfig
    from egtr_tpu_torch.scripts import evaluate_egtr

    data, out = driver_paths(workdir)
    artifact = f"{out}/artifact"
    cfg = EgtrConfig.load(f"{artifact}/config.json")
    bucket = _test_bucket(data, cfg)
    shapes = level_shapes(bucket, cfg.num_feature_levels)
    q_rows = check_q_kernel(shapes, "test")
    win_rows = check_win_kernels(shapes, "test")
    argv = ["--data_path", data, "--artifact_path", artifact, "--device",
            DEVICE]
    n_test = SYNTH_VG["n_test"]
    served_cfg = cfg.replace(msda_window=WINDOW, msda_band="point",
                             msda_int8=True)
    runs, bad, calls = {}, [], []
    # forwards per run; run_fps: one warm-up, the timed loop's, and
    # decomposition loops of ten on the first batch (strict sync, chained,
    # and on the card chained under the profiler)
    loops = 3 if torch.device(DEVICE).type == "cuda" else 2
    for label, extra, run_cfg, forwards in (
            ("exact", [], cfg, n_test),
            ("served", SERVED_EVAL_ARGS, served_cfg, n_test),
            ("infer_only", ["--infer_only", "true"], cfg,
             1 + n_test + loops * 10)):
        reset_kernel_counts()
        t0 = time.perf_counter()
        with recorded_entries(
                calls=calls if label == "exact" else None) as entries:
            result = evaluate_egtr.main(argv + extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernel_counts()
        expect = {k: v * forwards
                  for k, v in forward_counts(run_cfg, shapes).items()}
        if counts != expect:
            bad.append(f"{label}: launches {counts}, expected {expect}")
        runs[label] = {"seconds": seconds, "counts": counts,
                       "result": result}
        if label == "exact":
            runs[label]["top_k_bit_equal_to_driver"] = same_top_k = (
                bool(entries) and same_entries(entries, driver["entries"]))
    matching = time_sg_eval(calls)
    want = {k: driver["test"][k] for k in RECALL_KEYS}
    exact = {k: runs["exact"]["result"][k] for k in RECALL_KEYS}
    served = {k: runs["served"]["result"][k] for k in RECALL_KEYS}
    fps = runs["infer_only"]["result"]
    fps_keys = ("fps", "strict_sync_fps", "chained_ms_per_image",
                "device_ms_per_image", "host_rtt_ms")
    print(f"evaluate (evaluate_egtr.main, batch_p off; phase 17's artifact, "
          f"{n_test} test images at {bucket}): exact "
          f"{runs['exact']['seconds']:.1f} s, R@K/mR@K {exact} (phase 17: "
          f"{want}), top-k triplets of its {len(driver['entries'])} images "
          f"with relations bit-equal to phase 17's: {same_top_k}; served "
          f"({' '.join(SERVED_EVAL_ARGS)}) {runs['served']['seconds']:.1f} s, "
          f"R@K/mR@K {served}; --infer_only {runs['infer_only']['seconds']:.1f}"
          f" s, { {k: fps[k] for k in fps_keys + ('device_idle_share', 'images', 'device', 'timer')} }"
          f"; launches "
          f"{ {l: {k: v for k, v in r['counts'].items() if v} for l, r in runs.items()} }"
          f"; SGG evaluator, the exact run's {matching['calls']} calls "
          f"replayed (host ms, least of {SG_EVAL_ROUNDS}), native matcher | "
          "numpy loop: "
          + "; ".join(f"{name} {m['native_ms']:.3f} | {m['numpy_ms']:.3f}, "
                      f"same recalls {m['same_recalls']}, largest recall "
                      f"{m['max_recall']}" for name, m in matching.items()
                      if name != "calls"), flush=True)
    if not (matching["recorded"]["same_recalls"]
            and matching["planted"]["same_recalls"]):
        bad.append("the native matcher's recalls differ from the numpy "
                   "loop's")
    if matching["planted"]["max_recall"] != 1.0:
        bad.append("the planted ground truth found no match")
    if not same_top_k:
        bad.append("the top-k triplets differ from phase 17's")
    if exact != want:
        bad.append(f"R@K/mR@K {exact} differ from phase 17's {want}")
    if not all(math.isfinite(fps[k]) and fps[k] > 0 for k in fps_keys):
        bad.append(f"--infer_only: {fps}")
    if bad:
        raise SystemExit(f"evaluate: {bad}")
    return {"runs": runs, "q_rows": q_rows, "win_rows": win_rows,
            "sg_eval": matching, "bucket": list(bucket)}


def drive_pretrain(workdir):
    """The pretraining driver's main path, in-process: two phases at full
    width on the synthetic VG set, the artifact, the COCO test evaluation;
    then the artifact merged into a fresh EGTR model."""
    from egtr_tpu_torch.scripts import pretrain_detr
    from egtr_tpu_torch.train.checkpoint import (load_pretrained,
                                                 merge_pretrained)

    data, _ = driver_paths(workdir)
    out = f"{workdir}/pretrain"
    reset_kernel_counts()
    t0 = time.perf_counter()
    detector = pretrain_detr.main(["--data_path", data, "--output_path", out,
                                   "--device", DEVICE, *PRETRAIN_ARGS])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernel_counts()
    cfg = detector.config
    del detector
    per_forward = forward_counts(
        cfg, level_shapes(perf_train_step.BUCKET_HW,
                          cfg.num_feature_levels))["msda_fwd"]
    forwards, microbatches = _driver_forwards(PRETRAIN_ARGS)
    expect = dict.fromkeys(msda_cuda.KERNELS, 0)
    expect.update(msda_fwd=per_forward * forwards,
                  msda_bwd_rows=per_forward * microbatches,
                  msda_bwd_value=per_forward * microbatches)
    bad, phases = [], {}
    for phase in ("main", "finetune"):
        train, val, ok = _phase_records(out, phase)
        if not ok:
            bad.append(f"{phase}: {len(train)} train and {len(val)} val "
                       "records, or a non-finite loss")
        phases[phase] = {
            "step_ms": [1e3 * r["step_seconds"] for r in train],
            "train_total_loss": [r["total_loss"] for r in train],
            "validation_total_loss": [r["validation_total_loss"]
                                      for r in val]}
    with open(f"{out}/metrics_test.json") as f:
        test = json.load(f)
    if not test or not all(k.startswith("coco/") and math.isfinite(v)
                           for k, v in test.items()):
        bad.append(f"metrics_test.json: {test}")
    # train_egtr --pretrained: every detector leaf from the artifact, the
    # relation head and the frequency-bias tables fresh
    art_cfg, artifact = load_pretrained(f"{out}/artifact")
    fresh = EgtrModel(art_cfg).state_dict()
    _, initialized = merge_pretrained(fresh, artifact)
    want = sorted(n.replace(".", "/") for n in fresh
                  if n.startswith("relation_head.")
                  or n in ("rel_dist", "triplet_dist"))
    detector_leaves = sum(n.startswith("model.") for n in fresh)
    if sorted(initialized) != want or len(artifact) != detector_leaves:
        bad.append(f"merge_pretrained: {len(initialized)} fresh paths "
                   f"({len(want)} expected), {len(artifact)} artifact "
                   f"entries for {detector_leaves} detector leaves")
    print(f"pretrain (pretrain_detr.main; {SYNTH_VG}, "
          f"{' '.join(PRETRAIN_ARGS)}): {seconds:.1f} s, ms per optimizer "
          f"step { {p: [round(t, 1) for t in v['step_ms']] for p, v in phases.items()} }"
          f"; launches { {k: v for k, v in counts.items() if v} } (expected "
          f"{ {k: v for k, v in expect.items() if v} }); losses "
          f"{ {p: v['validation_total_loss'] for p, v in phases.items()} }; "
          f"test metrics {test}; merged into EgtrModel: {len(artifact)} "
          f"detector leaves loaded, {len(initialized)} paths fresh "
          "(the relation head and the frequency-bias tables)", flush=True)
    if counts != expect:
        raise SystemExit(f"pretrain: launches {counts}, expected {expect}")
    if bad:
        raise SystemExit(f"pretrain: {bad}")
    return {"counts": counts, "seconds": seconds, "phases": phases,
            "test": test, "fresh_paths": len(initialized)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        built = pool.submit(msda_cuda.build), pool.submit(native.build)
        libs, native_lib = (f.result() for f in built)
    print(f"kernel build: {sorted(p.name for p in libs.values())} and "
          f"{native_lib.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    cfg = infer.bench_config()
    train_cfg = perf_train_step.train_config()
    shapes = level_shapes(infer.BUCKET_HW, cfg.num_feature_levels)
    train_shapes = level_shapes(perf_train_step.BUCKET_HW,
                                train_cfg.num_feature_levels)
    adapt_cfg = perf_train_step.adapt_config()
    adapt_hw = perf_train_step.ADAPT_HW
    adapt_shapes = level_shapes(adapt_hw, adapt_cfg.num_feature_levels)
    rows = check_kernel(shapes, "serving")
    train_rows = check_kernel(train_shapes, "training")
    bwd_rows = check_bwd_kernels(train_shapes, "training")
    q_rows = check_q_kernel(shapes)
    win_rows = check_win_kernels(shapes)
    bp_rows = check_bp_kernel(shapes, train_shapes)

    served_cfg = infer.serving_config()
    tile_cfg = infer.bench_config(msda_window=WINDOW, msda_band="tile")
    exact_counts, exact_ms, exact_model, x = serve(cfg, "exact", N_REQUESTS)
    served_counts, served_ms, served_model, _ = serve(served_cfg, "served",
                                                      N_REQUESTS)
    tile_counts, tile_ms, tile_model, _ = serve(tile_cfg, "tile",
                                                N_TILE_REQUESTS)
    side_by_side = time_side_by_side(
        {"exact": exact_model, "served": served_model, "tile": tile_model},
        x, SIDE_BY_SIDE_ROUNDS)
    medians = {k: sorted(v)[len(v) // 2] for k, v in side_by_side.items()}
    print(f"ms/request, exact | served | tile, {SIDE_BY_SIDE_ROUNDS} rounds "
          f"in turns, on {card}: median "
          + " | ".join(f"{medians[k]:.3f}" for k in side_by_side)
          + "; min " + " | ".join(f"{min(v):.3f}"
                                  for v in side_by_side.values()),
          flush=True)
    batch_p_serve = serve_batch_p(
        {"exact": exact_model, "served": served_model, "tile": tile_model}, x)
    del exact_model, served_model, tile_model
    model_errs = compare_f32(cfg, "exact", MODEL_ATOL)
    served_errs = compare_f32(served_cfg, "served", SERVED_MODEL_ATOL)
    int8_grad_counts = check_int8_grad(shapes)
    exact_train = train(train_cfg, "exact", perf_train_step.BUCKET_HW, 2,
                        TRAIN_STEPS, accum=True)
    counts = exact_train["counts"]
    train_errs = compare_train_f32(train_cfg, "exact",
                                   perf_train_step.BUCKET_HW, 2, GRAD_RTOL)
    # the windowed path: the banded backward kernels, the band-adaptation
    # fine-tune and its siblings
    bwd_win_rows = check_bwd_win_kernels(adapt_shapes,
                                         perf_train_step.ADAPT_BATCH)
    adapt_args = (adapt_hw, perf_train_step.ADAPT_BATCH)
    adapt = train(adapt_cfg, "adaptation", *adapt_args, ADAPT_STEPS,
                  lrs=perf_train_step.ADAPT_LRS)
    adapt_tile = train(adapt_cfg.replace(msda_band="tile"), "adaptation tile",
                       *adapt_args, 1, lrs=perf_train_step.ADAPT_LRS)
    adapt_int8 = train(adapt_cfg.replace(msda_int8=True), "adaptation int8",
                       *adapt_args, 1, lrs=perf_train_step.ADAPT_LRS)
    adapt_errs = compare_train_f32(adapt_cfg, "adaptation", adapt_hw, 2,
                                   ADAPT_GRAD_RTOL)
    # the training driver with every exact forward through K11
    with tempfile.TemporaryDirectory() as workdir:
        driver = drive_trainer(workdir)
        # the other two entry points on phase 17's set and artifact
        evaluate = drive_evaluate(workdir, driver)
        pretrain = drive_pretrain(workdir)

    def pick(table, call, dtype="bfloat16", batch=1):
        return next(r for r in table if r["call"] == call
                    and r["dtype"] == dtype and r.get("batch", 1) == batch)

    def banded_entry(name, line, main_form, launches):
        mine = {r["dtype"]: r for r in win_rows if r["kernel"] == name}
        test_bucket = [r for r in evaluate["win_rows"] if r["kernel"] == name]
        main = mine[main_form]
        return {
            "name": name, "route": "cuda",
            "source": "egtr_tpu_torch/csrc/msda_fwd_win.cu",
            "replaces": f"egtr_tpu/ops/msda_pallas.py:{line}",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"]
                               for r in [*mine.values(), *test_bucket]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "form": main_form,
            "graph_ms": main["graph_ms"],
            "ms_float32": mine["float32"]["ms"],
            "ms_bfloat16": mine["bfloat16"]["ms"],
            "ms_int8": mine["int8"]["ms"],
            **{f"graph_ms_{form}": r["graph_ms"] for form, r in mine.items()},
            "bit_equal_run_to_run": all(r["bit_equal_run_to_run"]
                                        for r in mine.values()),
            "calls": list(mine.values()),
            "calls_test_bucket": test_bucket,
            **({"bit_equal_to_k6_broadcast": all(
                r["bit_equal_to_k6_broadcast"]
                for r in [*mine.values(), *test_bucket])}
               if name == "msda_fwd_win" else {}),
        }

    def banded_bwd_entry(kind, name, line, launches):
        mine = [r for r in bwd_win_rows if r[f"{kind}_kernel"] == name]
        main = next(r for r in mine if r["dtype"] == "bfloat16")
        keys = ("dix", "diy", "daw") if kind == "rows" else ("dvalue",)
        entry = {
            "name": name, "route": "cuda",
            "source": "egtr_tpu_torch/csrc/msda_bwd_win.cu",
            "replaces": f"egtr_tpu/ops/msda_pallas.py:{line}",
            "launches": launches,
            "max_abs_err": max(main["max_abs_err"][k] for k in keys),
            "ms": main[f"{kind}_ms"],
            # the plain version computes rows and value in one call
            "plain_ms": main["plain_ms"],
            "bound_ms": main[f"{kind}_bound_ms"],
            "bound_by": main[f"{kind}_bound_by"],
            "library_ms": None, "form": "bfloat16", "batch": main["batch"],
            "ms_float32": next(r for r in mine
                               if r["dtype"] == "float32")[f"{kind}_ms"],
            "calls": mine,
        }
        if kind == "value":
            entry["graph_ms"] = main["value_graph_ms"]
            entry["graph_ms_float32"] = next(
                r for r in mine if r["dtype"] == "float32")["value_graph_ms"]
            entry["run_to_run_max_abs_diff"] = max(
                r["value_run_to_run_max_abs_diff"] for r in mine)
            if name == "msda_bwd_win_value":
                entry["max_abs_diff_to_k10_broadcast"] = max(
                    r["value_max_abs_diff_to_k10_broadcast"] for r in mine)
        else:
            entry["graph_ms"] = main["rows_graph_ms"]
            entry["graph_ms_float32"] = next(
                r for r in mine if r["dtype"] == "float32")["rows_graph_ms"]
            entry["bit_equal_run_to_run"] = all(
                r["rows_bit_equal_run_to_run"] for r in mine)
            if name == "msda_bwd_win_rows":
                entry["bit_equal_to_k8_broadcast"] = all(
                    r["rows_bit_equal_to_k8_broadcast"] for r in mine)
        return entry

    main_row = pick(rows, "encoder")
    bp_main = next(r for r in bp_rows if r["bucket"] == "serving"
                   and r["Q"] != 200 and r["form"] == "bfloat16")
    bp_launches = {label: r["counts"]["msda_fwd_bp"]
                   for label, r in batch_p_serve.items()}
    bp_launches["driver"] = driver["counts"]["msda_fwd_bp"]
    # the source that serves each form of K11, the main (bfloat16) form's
    # first
    here = os.path.dirname(os.path.abspath(__file__))
    bp_routes = {str(dtype)[6:]: fn
                 for dtype, fn in msda_cuda.BP_ROUTES.items()}
    bp_sources = {form: os.path.relpath(msda_cuda.source_of(fn), here)
                  for form, fn in bp_routes.items()}
    bp_entry = {
        "name": "msda_fwd_bp", "route": "cuda",
        "source": bp_sources["bfloat16"],
        "sources_by_form": bp_sources, "routes_by_form": bp_routes,
        "replaces": "egtr_tpu/ops/msda_pallas.py:180",
        "launches": sum(bp_launches.values()),
        **{f"launches_{k}": v for k, v in bp_launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in bp_rows
                           if r["form"] == "bfloat16"),
        "ms": bp_main["ms"], "plain_ms": bp_main["plain_ms"],
        "bound_ms": bp_main["bound_ms"], "bound_by": bp_main["bound_by"],
        "library_ms": None, "form": "bfloat16",
        "ms_msda_fwd_same_call": bp_main["ms_msda_fwd_same_call"],
        "bit_equal_where_routed": all(
            r[f"bit_equal_to_{r['routed_to']}"] for r in bp_rows
            if r["routed_to"] != "msda_fwd_bp"),
        "calls": bp_rows,
        "served_f32_max_abs_err": {"exact": model_errs["batch_p"],
                                   "served": served_errs["batch_p"]},
        "served_bf16_max_abs_diff_flag_off": {
            label: r["max_abs_diff"] for label, r in batch_p_serve.items()},
        "served_bf16_bit_equal_flag_off": {
            label: r["bit_equal_flag_off"]
            for label, r in batch_p_serve.items()},
    }
    bwd_row = pick(bwd_rows, "encoder")
    q_row = pick(q_rows, "encoder_served")
    bf16_bwd = [r for r in bwd_rows if r["dtype"] == "bfloat16"]
    # the evaluation driver's runs (exact, served, --infer_only) and the
    # pretraining driver's
    evaluated = {label: run["counts"]
                 for label, run in evaluate["runs"].items()}
    pretrained = pretrain["counts"]
    fwd_launches = (exact_counts["msda_fwd"] + tile_counts["msda_fwd"]
                    + counts["msda_fwd"])
    kernels = {"kernels": [{
        "name": "msda_fwd",
        "route": "cuda",
        "source": "egtr_tpu_torch/csrc/msda_fwd.cu",
        "replaces": "egtr_tpu/ops/msda_pallas.py:144",
        "launches": fwd_launches,
        "launches_serving": exact_counts["msda_fwd"],
        "launches_serving_tile": tile_counts["msda_fwd"],
        "launches_serving_served": served_counts["msda_fwd"],
        "launches_training": counts["msda_fwd"],
        "launches_adaptation": adapt["counts"]["msda_fwd"],
        "launches_evaluate": evaluated["exact"]["msda_fwd"],
        "launches_evaluate_infer_only": evaluated["infer_only"]["msda_fwd"],
        "launches_pretrain": pretrained["msda_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + train_rows
                           if r["dtype"] == "bfloat16"),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "library_composite_ms": main_row["library_composite_ms"],
        "library_composite": COMPOSITE_NOTE,
        "graph_ms": main_row["graph_ms"],
        "gather_bytes": main_row["gather_bytes"],
        "gather_GBps_L2": main_row["gather_GBps_L2"],
        "ms_encoder": main_row["ms"],
        "ms_encoder_raster": pick(rows, "encoder_raster")["ms"],
        "ms_decoder": pick(rows, "decoder")["ms"],
        "graph_ms_decoder": pick(rows, "decoder")["graph_ms"],
        "graph_ms_decoder_batch2_training": pick(
            train_rows, "decoder", batch=2)["graph_ms"],
        "ms_encoder_training": pick(train_rows, "encoder")["ms"],
        "ms_encoder_raster_training": pick(train_rows,
                                           "encoder_raster")["ms"],
        "ms_decoder_training": pick(train_rows, "decoder")["ms"],
        "calls": rows + train_rows,
        "model_f32_max_abs_err": model_errs,
    }, {
        "name": "msda_bwd_rows",
        "route": "cuda",
        "source": "egtr_tpu_torch/csrc/msda_bwd.cu",
        "replaces": "egtr_tpu/ops/msda_pallas.py:487",
        "launches": counts["msda_bwd_rows"],
        "launches_training": counts["msda_bwd_rows"],
        "launches_adaptation": adapt["counts"]["msda_bwd_rows"],
        "launches_pretrain": pretrained["msda_bwd_rows"],
        "max_abs_err": max(max(r["max_abs_err"][k] for k in ("dloc", "daw"))
                           for r in bf16_bwd),
        "ms": bwd_row["rows_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["rows_bound_ms"],
        "bound_by": bwd_row["rows_bound_by"],
        "library_ms": None,
        "library_composite_ms": bwd_row["library_composite_ms"],
        "library_composite": COMPOSITE_NOTE + " (its autograd backward: the "
                             "work of K2 and K3 together)",
        "graph_ms": bwd_row["rows_graph_ms"],
        "gather_bytes": bwd_row["rows_gather_bytes"],
        "gather_GBps_L2": bwd_row["rows_gather_GBps_L2"],
        "ms_encoder": bwd_row["rows_ms"],
        "ms_encoder_raster": pick(bwd_rows, "encoder_raster")["rows_ms"],
        "ms_decoder": pick(bwd_rows, "decoder")["rows_ms"],
        "graph_ms_decoder": pick(bwd_rows, "decoder")["rows_graph_ms"],
        "graph_ms_decoder_batch2": pick(bwd_rows, "decoder",
                                        batch=2)["rows_graph_ms"],
        "calls": bwd_rows,
    }, {
        "name": "msda_bwd_value",
        "route": "cuda",
        "source": "egtr_tpu_torch/csrc/msda_bwd.cu",
        "replaces": "egtr_tpu/ops/msda_pallas.py:608",
        "launches": counts["msda_bwd_value"],
        "launches_training": counts["msda_bwd_value"],
        "launches_adaptation": adapt["counts"]["msda_bwd_value"],
        "launches_pretrain": pretrained["msda_bwd_value"],
        "max_abs_err": max(r["max_abs_err"]["dvalue"] for r in bf16_bwd),
        "ms": bwd_row["value_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["value_bound_ms"],
        "bound_by": bwd_row["value_bound_by"],
        "library_ms": None,
        "library_composite_ms": bwd_row["library_composite_ms"],
        "library_composite": COMPOSITE_NOTE + " (its autograd backward: the "
                             "work of K2 and K3 together)",
        "graph_ms": bwd_row["value_graph_ms"],
        "ms_encoder": bwd_row["value_ms"],
        "ms_encoder_raster": pick(bwd_rows, "encoder_raster")["value_ms"],
        "ms_decoder": pick(bwd_rows, "decoder")["value_ms"],
        "graph_ms_decoder": pick(bwd_rows, "decoder")["value_graph_ms"],
        "graph_ms_decoder_batch2": pick(bwd_rows, "decoder",
                                        batch=2)["value_graph_ms"],
        "calls": bwd_rows,
        "run_to_run_max_abs_diff": max(
            r["value_run_to_run_max_abs_diff"] for r in bwd_rows),
    }, {
        "name": "msda_fwd_q",
        "route": "cuda",
        "source": "egtr_tpu_torch/csrc/msda_fwd_q.cu",
        "replaces": "egtr_tpu/ops/msda_pallas.py:130",
        "launches": served_counts["msda_fwd_q"],
        "launches_serving_served": served_counts["msda_fwd_q"],
        "launches_evaluate_served": evaluated["served"]["msda_fwd_q"],
        "launches_adaptation_int8": adapt_int8["counts"]["msda_fwd_q"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in q_rows + evaluate["q_rows"]),
        "ms": q_row["ms"],
        "plain_ms": q_row["plain_ms"],
        "bound_ms": q_row["bound_ms"],
        "bound_by": q_row["bound_by"],
        "library_ms": None,
        "graph_ms": q_row["graph_ms"],
        "ms_encoder_served": q_row["ms"],
        "ms_encoder": pick(q_rows, "encoder")["ms"],
        "ms_decoder": pick(q_rows, "decoder")["ms"],
        "graph_ms_encoder": pick(q_rows, "encoder")["graph_ms"],
        "graph_ms_decoder": pick(q_rows, "decoder")["graph_ms"],
        "graph_ms_decoder_batch2": pick(q_rows, "decoder",
                                        batch=2)["graph_ms"],
        "bit_equal_run_to_run": all(r["bit_equal_run_to_run"]
                                    for r in q_rows),
        "calls": q_rows,
        "calls_test_bucket": evaluate["q_rows"],
        "int8_grad_launches": int8_grad_counts,
        "served_model_f32_max_abs_err": served_errs,
    },
        banded_entry("msda_fwd_win", 240, "bfloat16",
                     tile_counts["msda_fwd_win"]),
        {**banded_entry("msda_fwd_win_pp", 249, "int8",
                        served_counts["msda_fwd_win_pp"]),
         "launches_serving_served": served_counts["msda_fwd_win_pp"],
         "launches_evaluate_served": evaluated["served"]["msda_fwd_win_pp"]},
        banded_bwd_entry("rows", "msda_bwd_win_rows", 836,
                         adapt_tile["counts"]["msda_bwd_win_rows"]),
        banded_bwd_entry("rows", "msda_bwd_win_rows_pp", 722,
                         adapt["counts"]["msda_bwd_win_rows_pp"]),
        banded_bwd_entry("value", "msda_bwd_win_value", 877,
                         adapt_tile["counts"]["msda_bwd_win_value"]),
        banded_bwd_entry("value", "msda_bwd_win_value_pp", 772,
                         adapt["counts"]["msda_bwd_win_value_pp"]),
        bp_entry,
    ], "serve_ms_per_request": {"exact": exact_ms, "served": served_ms,
                                "tile": tile_ms},
        "serve_ms_per_request_in_turns": side_by_side,
        "train": {"ms_per_step": exact_train["ms_per_step"],
                  "accumulated_step_ms":
                      exact_train["accumulated_step_ms"][0],
                  "max_memory_allocated_gb":
                      exact_train["max_memory_allocated_gb"]},
        "train_adaptation": {
            label: {k: v for k, v in run.items() if k != "counts"}
            for label, run in (("point", adapt), ("tile", adapt_tile),
                               ("point_int8", adapt_int8))},
        "train_f32": {"exact": train_errs, "adaptation": adapt_errs},
        "driver": {k: v for k, v in driver.items()
                   if k not in ("counts", "entries")},
        "evaluate": {label: {k: v for k, v in run.items() if k != "counts"}
                     for label, run in evaluate["runs"].items()},
        "evaluate_test_bucket": evaluate["bucket"],
        "sg_eval_host_ms": evaluate["sg_eval"],
        "pretrain": {k: v for k, v in pretrain.items() if k != "counts"}}
    print(json.dumps(kernels))
    print(f"total {time.perf_counter() - t_start:.1f} s; card: {card}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
