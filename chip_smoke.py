"""Drive the PyTorch port (egtr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Every phase runs unguarded; any failure ends the script with a nonzero exit
and no result line. In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written MSDA kernels (forward; backward rows and value)
   from egtr_tpu_torch/csrc, the compilers started together;
3. holds the forward kernel against its plain PyTorch version at the two
   main paths' shapes (serving bucket 608x1008: levels (76,126),(38,63),
   (19,32),(10,16), S = 12738; training bucket 800x1344: levels (100,168),
   (50,84),(25,42),(13,21), S = 22323, where level 0 rounds the y weights in
   bfloat16; encoder call Q = S, decoder call Q = 200; 8 heads of 32) in
   float32 and bfloat16, times both with CUDA events, and checks the
   kernel's batch addressing on a batch of 2;
4. holds the two backward kernels against the plain backward at the
   training bucket's shapes the same way, and prints the largest difference
   between two runs of the value kernel (its float32 atomics add in an
   order that changes);
5. serves a few requests through ``infer.infer`` with the bench
   configuration at full width (ResNet-50, d_model 256, 6+6 layers, 200
   queries, 150/50 labels, bfloat16, seeded random weights) and checks the
   outputs and that the forward kernel ran 12 times per forward;
6. runs the same model in float32 (TF32 off) through the kernel and through
   the plain MSDA and compares logits, boxes and relation scores;
7. trains: the train probe's step (``scripts/perf_train_step``) at full
   width, bfloat16, batch 2 at 800x1344, dropout 0.1: three steps and one
   accumulated step (accum 2 over a batch of 4). Checks that every metric
   is finite, the gradient norm positive, the trainable parameters moved,
   the frozen ones bit-identical, and that each microbatch launched each of
   the three kernels 12 times;
8. runs one float32 (TF32 off) forward + backward of the same model through
   the kernels and through the plain op and compares the total loss and
   every parameter's gradient;
9. prints a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` last.

It exits nonzero without a result where CUDA is absent.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from egtr_tpu_torch import infer
from egtr_tpu_torch.models.detr import level_shapes
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.ops import criterion, msda, msda_cuda
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

H, D, L, P = 8, 32, 4, 4
N_REQUESTS = 4
TRAIN_STEPS = 3
DEVICE = "cuda"


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


def msda_inputs(Q, S, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    value = torch.randn((1, S, H, D), generator=g, device=DEVICE).to(dtype)
    # locations roam slightly outside [0, 1] so the zero padding is hit
    loc = torch.rand((1, Q, H, L, P, 2), generator=g, device=DEVICE) * 1.2 - 0.1
    aw = torch.randn((1, Q, H, L * P), generator=g, device=DEVICE).softmax(-1)
    return value, loc, aw.reshape(1, Q, H, L, P).to(dtype)


def bound(tensors, aw, flops_per_sample_channel=FLOPS_PER_SAMPLE_CHANNEL):
    """Least time for a call on the card: ``tensors`` (each input read once,
    each output written once) over the HBM rate, against the flops over the
    float32 rate. Returns (ms, "bytes" | "operations")."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    flops = aw.numel() * D * flops_per_sample_channel
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / FP32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def check_kernel(shapes, bucket):
    """K1 against the plain version at the encoder and decoder shapes."""
    S = sum(h * w for h, w in shapes)
    rows = []
    for call, Q in (("encoder", S), ("decoder", 200)):
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, aw = msda_inputs(Q, S, dtype, seed=len(rows))
            kern = msda_cuda.msda_fwd(value, shapes, loc, aw)
            plain = msda.ms_deform_attn_plain(value, shapes, loc, aw)
            torch.cuda.synchronize()
            err = (kern.float() - plain.float()).abs()
            atol, rtol = TOL[dtype]
            limit = atol + rtol * plain.float().abs()
            row = {
                "bucket": bucket, "call": call, "Q": Q,
                "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err.max().item(),
                "max_err_over_limit": (err / limit).max().item(),
                "ms": cuda_ms(lambda: msda_cuda.msda_fwd(value, shapes, loc,
                                                         aw), 100),
                "plain_ms": cuda_ms(lambda: msda.ms_deform_attn_plain(
                    value, shapes, loc, aw), 5),
            }
            row["bound_ms"], row["bound_by"] = bound((value, loc, aw, kern),
                                                     aw)
            print(f"msda_fwd {bucket} {call} Q={Q} {row['dtype']}: max abs err "
                  f"{row['max_abs_err']:.3e} (err/limit "
                  f"{row['max_err_over_limit']:.3f}, atol {atol} rtol "
                  f"{rtol}); kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})", flush=True)
            if not torch.isfinite(kern.float()).all():
                raise SystemExit(f"msda_fwd {call} {dtype}: non-finite output")
            if row["max_err_over_limit"] > 1.0:
                raise SystemExit(f"msda_fwd {call} {dtype}: kernel disagrees "
                                 "with the plain version")
            rows.append(row)
    # the batch index of the kernel's addressing (the main path is batch 1)
    value, loc, aw = msda_inputs(200, S, torch.float32, seed=len(rows))
    value, loc, aw = (torch.cat([t, t.flip(1)]) for t in (value, loc, aw))
    plain = msda.ms_deform_attn_plain(value, shapes, loc, aw)
    err = (msda_cuda.msda_fwd(value, shapes, loc, aw) - plain).abs()
    atol, rtol = TOL[torch.float32]
    print(f"msda_fwd {bucket} decoder batch 2 float32: max abs err "
          f"{err.max().item():.3e}", flush=True)
    if (err > atol + rtol * plain.abs()).any():
        raise SystemExit("msda_fwd batch 2: kernel disagrees with plain")
    return rows


def serve(cfg):
    """The main path: requests through infer.infer at full width."""
    model, x = infer.build(cfg, 1, *infer.BUCKET_HW, seed=0)
    msda_cuda.launches = 0
    times, packed = infer.time_requests(model, x, N_REQUESTS, warmup=2)
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    launches = msda_cuda.launches
    forwards = N_REQUESTS + 2 + 1
    per_forward = cfg.encoder_layers + cfg.decoder_layers  # one MSDA each
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
    print(f"serve {cfg.compute_dtype} {hw} b1: {N_REQUESTS} requests, "
          f"ms/request mean "
          f"{sum(times) / len(times):.3f} min {min(times):.3f} max "
          f"{max(times):.3f}; msda_fwd launches {launches} over {forwards} "
          f"forwards", flush=True)
    if launches != per_forward * forwards:
        raise SystemExit(f"msda_fwd launched {launches} times, expected "
                         f"{per_forward * forwards} ({per_forward} per "
                         "forward)")
    return launches, times


def compare_f32(cfg):
    """Same float32 weights, kernel path against the plain-MSDA path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.replace(compute_dtype="float32")
    model_k, x = infer.build(cfg, 1, *infer.BUCKET_HW, seed=0)
    _noise_msda_heads(model_k, x.device)
    model_p = EgtrModel(cfg.replace(msda_impl="matmul"))
    model_p.load_state_dict(model_k.state_dict(), strict=True)
    model_p = model_p.to(x.device).eval()
    with torch.inference_mode():
        before = msda_cuda.launches
        out_k = model_k(x)
        mid = msda_cuda.launches
        out_p = model_p(x)
        after = msda_cuda.launches
    per_forward = cfg.encoder_layers + cfg.decoder_layers
    if mid - before != per_forward or after != mid:
        raise SystemExit(f"f32 launches: kernel path {mid - before} (expected "
                         f"{per_forward}), plain path {after - mid} "
                         "(expected 0)")
    errs = {}
    for key in ("logits", "pred_boxes", "pred_rel"):
        errs[key] = (out_k[key] - out_p[key]).abs().max().item()
    print(f"model f32 kernel vs plain MSDA: max abs err {errs} "
          f"(atol {MODEL_ATOL})", flush=True)
    if max(errs.values()) > MODEL_ATOL or not all(
            torch.isfinite(out_k[k]).all() for k in errs):
        raise SystemExit("float32 model: kernel path disagrees with plain")
    return errs


def _scaled_err(got, ref, dtype):
    """Largest |got - ref| over the limit atol*max|ref| + rtol*|ref|."""
    atol, rtol = BWD_TOL[dtype]
    ref = ref.float()
    err = (got.float() - ref).abs()
    limit = atol * max(1.0, ref.abs().max().item()) + rtol * ref.abs()
    return err.max().item(), (err / limit).max().item()


def check_bwd_kernels(shapes, bucket):
    """K2 and K3 against the plain backward at the encoder and decoder
    shapes of the training bucket."""
    S = sum(h * w for h, w in shapes)
    rows = []
    for call, Q in (("encoder", S), ("decoder", 200)):
        for dtype in (torch.float32, torch.bfloat16):
            value, loc, aw = msda_inputs(Q, S, dtype, seed=100 + len(rows))
            g = torch.randn((1, Q, H * D), device=DEVICE,
                            generator=torch.Generator(device=DEVICE)
                            .manual_seed(len(rows))).to(dtype)
            args = (value, shapes, loc, aw, g)
            dloc, daw = msda_cuda.msda_bwd_rows(*args)
            dvalue = msda_cuda.msda_bwd_value(*args)
            again = msda_cuda.msda_bwd_value(*args)
            pv, pl, pa = msda.ms_deform_attn_plain_bwd(*args)
            torch.cuda.synchronize()
            errs = {n: _scaled_err(k, p, dtype) for n, k, p in (
                ("dvalue", dvalue, pv), ("dloc", dloc, pl), ("daw", daw, pa))}
            row = {
                "bucket": bucket, "call": call, "Q": Q,
                "dtype": str(dtype).split(".")[-1],
                "max_abs_err": {n: e[0] for n, e in errs.items()},
                "max_err_over_limit": {n: e[1] for n, e in errs.items()},
                "value_run_to_run_max_abs_diff":
                    (dvalue.float() - again.float()).abs().max().item(),
                "rows_ms": cuda_ms(lambda: msda_cuda.msda_bwd_rows(*args), 50),
                "value_ms": cuda_ms(lambda: msda_cuda.msda_bwd_value(*args),
                                    50),
                # the plain backward computes all three gradients in one call
                "plain_ms": cuda_ms(lambda: msda.ms_deform_attn_plain_bwd(
                    *args), 3, warmup=1),
            }
            row["rows_bound_ms"], row["rows_bound_by"] = bound(
                (value, loc, aw, g, dloc, daw), aw, FLOPS_ROWS)
            row["value_bound_ms"], row["value_bound_by"] = bound(
                (loc, aw, g, dvalue), aw, FLOPS_VALUE)
            atol, rtol = BWD_TOL[dtype]
            print(f"msda_bwd {bucket} {call} Q={Q} {row['dtype']}: max abs "
                  f"err {row['max_abs_err']} (err/limit "
                  f"{row['max_err_over_limit']}, atol {atol}*max|ref| rtol "
                  f"{rtol}); rows {row['rows_ms']:.4f} ms (bound "
                  f"{row['rows_bound_ms']:.4f} ms, {row['rows_bound_by']}), "
                  f"value {row['value_ms']:.4f} ms (bound "
                  f"{row['value_bound_ms']:.4f} ms, {row['value_bound_by']}), "
                  f"plain backward {row['plain_ms']:.4f} ms; value kernel "
                  f"run-to-run max abs diff "
                  f"{row['value_run_to_run_max_abs_diff']:.3e}", flush=True)
            for t in (dvalue, dloc, daw):
                if not torch.isfinite(t.float()).all():
                    raise SystemExit(f"msda_bwd {call} {dtype}: non-finite")
            if max(row["max_err_over_limit"].values()) > 1.0:
                raise SystemExit(f"msda_bwd {call} {dtype}: kernels disagree "
                                 "with the plain backward")
            rows.append(row)
    # the batch index of the kernels' addressing
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


def kernel_counts():
    return {"msda_fwd": msda_cuda.launches,
            "msda_bwd_rows": msda_cuda.bwd_rows_launches,
            "msda_bwd_value": msda_cuda.bwd_value_launches}


def reset_kernel_counts():
    msda_cuda.launches = 0
    msda_cuda.bwd_rows_launches = 0
    msda_cuda.bwd_value_launches = 0


def _noise_msda_heads(model, device, seed=1):
    """Random init zeroes the offset and weight kernels, so sampling would
    not depend on the image; give them seeded noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("sampling_offsets.weight",
                              "attention_weights.weight")):
                p.normal_(0.0, 0.1, generator=g)


def train(cfg):
    """The training main path: the train probe's step at full width."""
    hw = perf_train_step.BUCKET_HW
    model, optimizer, generator = perf_train_step.build(cfg, DEVICE, seed=0)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch2 = perf_train_step.synthetic_batch(cfg, 2, *hw, DEVICE, seed=0)
    batch4 = perf_train_step.synthetic_batch(cfg, 4, *hw, DEVICE, seed=1)
    step = make_train_step(model, cfg, optimizer, task="sgg")
    step_accum = make_train_step(model, cfg, optimizer, task="sgg",
                                 accum_steps=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    times, metrics = perf_train_step.time_steps(step, batch2, generator,
                                                TRAIN_STEPS, DEVICE)
    accum_times, accum_metrics = perf_train_step.time_steps(
        step_accum, batch4, generator, 1, DEVICE)
    counts = kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    microbatches = TRAIN_STEPS + 2
    per_microbatch = cfg.encoder_layers + cfg.decoder_layers
    print(f"train {cfg.compute_dtype} {hw[0]}x{hw[1]} b2: {TRAIN_STEPS} steps, "
          f"ms/step {[round(t, 1) for t in times]} (the first builds cuDNN's "
          f"plans); accumulated step (accum 2, batch 4) "
          f"{accum_times[0]:.1f} ms; max memory allocated {peak_gb:.2f} GB; "
          f"launches {counts} over {microbatches} microbatches; total_loss "
          f"{metrics['total_loss']:.4f} grad_norm {metrics['grad_norm']:.4f}; "
          f"accumulated total_loss {accum_metrics['total_loss']:.4f} "
          f"grad_norm {accum_metrics['grad_norm']:.4f}", flush=True)
    for name, m in (("step", metrics), ("accumulated step", accum_metrics)):
        bad = [k for k, v in m.items() if v != v or v in (float("inf"),
                                                         float("-inf"))]
        if bad:
            raise SystemExit(f"train {name}: non-finite metrics {bad}")
        if not m["grad_norm"] > 0:
            raise SystemExit(f"train {name}: grad_norm {m['grad_norm']}")
        expect = {"total_loss", "grad_norm", "loss_rel", "loss_connectivity",
                  f"loss_ce_{cfg.decoder_layers - 2}",
                  f"rel_gate_{cfg.decoder_layers}"}
        if not expect <= set(m):
            raise SystemExit(f"train {name}: metrics lack "
                             f"{sorted(expect - set(m))}")
    for kernel, n in counts.items():
        if n != per_microbatch * microbatches:
            raise SystemExit(
                f"{kernel} launched {n} times in training, expected "
                f"{per_microbatch * microbatches} ({per_microbatch} per "
                "microbatch)")
    moved = {label: [0, 0] for label in ("main", "backbone", "initialized")}
    for name, p in model.named_parameters():
        label = optimizer.labels[name]
        if label == "frozen":
            if not torch.equal(p, old[name]):
                raise SystemExit(f"train: frozen parameter {name} changed")
        else:
            moved[label][0] += int(not torch.equal(p, old[name]))
            moved[label][1] += 1
        if not torch.isfinite(p).all():
            raise SystemExit(f"train: parameter {name} is not finite")
    print(f"train: parameters moved per group (moved, all) {moved}; frozen "
          f"leaves bit-identical", flush=True)
    for label, (n_moved, n_all) in moved.items():
        # a leaf whose gradient is exactly zero gets no Adam step
        if n_moved < 0.9 * n_all:
            raise SystemExit(f"train: only {n_moved} of {n_all} {label} "
                             "parameters moved")
    return counts, times, accum_times, peak_gb


def compare_train_f32(cfg):
    """One float32 forward + backward (TF32 off, dropout 0) of the training
    model through the kernels and through the plain op: total loss and every
    parameter's gradient."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hw = perf_train_step.BUCKET_HW
    cfg = cfg.replace(compute_dtype="float32", dropout=0.0)
    model_k, _, _ = perf_train_step.build(cfg, DEVICE, seed=0)
    _noise_msda_heads(model_k, DEVICE)
    model_p = EgtrModel(cfg.replace(msda_impl="matmul"))
    model_p.load_state_dict(model_k.state_dict(), strict=True)
    model_p = model_p.to(DEVICE)
    batch = perf_train_step.synthetic_batch(cfg, 2, *hw, DEVICE, seed=0)
    per_pass = cfg.encoder_layers + cfg.decoder_layers
    results = []
    for model, expect in ((model_k, per_pass), (model_p, 0)):
        model.train()
        reset_kernel_counts()
        out = model(batch["pixel_values"], batch["pixel_mask"])
        total, _ = criterion.sgg_criterion(out, batch["labels"], cfg,
                                           train=True)
        total.backward()
        torch.cuda.synchronize()
        counts = kernel_counts()
        if set(counts.values()) != {expect}:
            raise SystemExit(f"f32 train launches {counts}, expected "
                             f"{expect} of each")
        results.append((total.item(), {n: p.grad for n, p in
                                       model.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p) = results
    worst, worst_name = 0.0, ""
    for name, gp in grads_p.items():
        gk = grads_k[name]
        if gk is None or gp is None:
            if gk is not gp:
                raise SystemExit(f"f32 train: gradient of {name} missing on "
                                 "one path")
            continue
        scale = gp.abs().max().item()
        err = (gk - gp).abs().max().item() / max(scale, 1e-12)
        if not torch.isfinite(gk).all():
            raise SystemExit(f"f32 train: non-finite gradient of {name}")
        if err > worst:
            worst, worst_name = err, name
    print(f"train f32 kernels vs plain op ({cfg.encoder_layers}+"
          f"{cfg.decoder_layers} layers, {hw[0]}x{hw[1]} b2): total loss "
          f"{loss_k:.6f} vs {loss_p:.6f}; largest gradient error relative to "
          f"the gradient's largest entry {worst:.3e} ({worst_name}), over "
          f"{len(grads_p)} parameters (rtol {GRAD_RTOL})", flush=True)
    if abs(loss_k - loss_p) > 1e-4 * abs(loss_p) or worst > GRAD_RTOL:
        raise SystemExit("float32 train step: kernel path disagrees with the "
                         "plain op")
    return {"loss_kernels": loss_k, "loss_plain": loss_p,
            "max_grad_rel_err": worst}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    libs = msda_cuda.build()
    print(f"kernel build: {sorted(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    cfg = infer.bench_config()
    train_cfg = perf_train_step.train_config()
    shapes = level_shapes(infer.BUCKET_HW, cfg.num_feature_levels)
    train_shapes = level_shapes(perf_train_step.BUCKET_HW,
                                train_cfg.num_feature_levels)
    rows = check_kernel(shapes, "serving")
    train_rows = check_kernel(train_shapes, "training")
    bwd_rows = check_bwd_kernels(train_shapes, "training")
    launches, _ = serve(cfg)
    model_errs = compare_f32(cfg)
    counts, step_ms, accum_ms, peak_gb = train(train_cfg)
    train_errs = compare_train_f32(train_cfg)

    def pick(table, call, dtype="bfloat16"):
        return next(r for r in table
                    if r["call"] == call and r["dtype"] == dtype)

    main_row = pick(rows, "encoder")
    bwd_row = pick(bwd_rows, "encoder")
    bf16_bwd = [r for r in bwd_rows if r["dtype"] == "bfloat16"]
    kernels = {"kernels": [{
        "name": "msda_fwd",
        "route": "cuda",
        "source": "egtr_tpu_torch/csrc/msda_fwd.cu",
        "replaces": "egtr_tpu/ops/msda_pallas.py:144",
        "launches": launches + counts["msda_fwd"],
        "launches_serving": launches,
        "launches_training": counts["msda_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in rows + train_rows
                           if r["dtype"] == "bfloat16"),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "ms_encoder": main_row["ms"],
        "ms_decoder": pick(rows, "decoder")["ms"],
        "ms_encoder_training": pick(train_rows, "encoder")["ms"],
        "ms_decoder_training": pick(train_rows, "decoder")["ms"],
        "calls": rows + train_rows,
        "model_f32_max_abs_err": model_errs,
    }, {
        "name": "msda_bwd_rows",
        "route": "cuda",
        "source": "egtr_tpu_torch/csrc/msda_bwd.cu",
        "replaces": "egtr_tpu/ops/msda_pallas.py:487",
        "launches": counts["msda_bwd_rows"],
        "max_abs_err": max(max(r["max_abs_err"][k] for k in ("dloc", "daw"))
                           for r in bf16_bwd),
        "ms": bwd_row["rows_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["rows_bound_ms"],
        "bound_by": bwd_row["rows_bound_by"],
        "library_ms": None,
        "ms_encoder": bwd_row["rows_ms"],
        "ms_decoder": pick(bwd_rows, "decoder")["rows_ms"],
        "calls": bwd_rows,
        "train_f32": train_errs,
    }, {
        "name": "msda_bwd_value",
        "route": "cuda",
        "source": "egtr_tpu_torch/csrc/msda_bwd.cu",
        "replaces": "egtr_tpu/ops/msda_pallas.py:608",
        "launches": counts["msda_bwd_value"],
        "max_abs_err": max(r["max_abs_err"]["dvalue"] for r in bf16_bwd),
        "ms": bwd_row["value_ms"],
        "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["value_bound_ms"],
        "bound_by": bwd_row["value_bound_by"],
        "library_ms": None,
        "ms_encoder": bwd_row["value_ms"],
        "ms_decoder": pick(bwd_rows, "decoder")["value_ms"],
        "run_to_run_max_abs_diff": max(
            r["value_run_to_run_max_abs_diff"] for r in bwd_rows),
    }], "train": {"ms_per_step": step_ms, "accumulated_step_ms": accum_ms[0],
                  "max_memory_allocated_gb": peak_gb}}
    print(json.dumps(kernels))
    print(f"total {time.perf_counter() - t_start:.1f} s; card: {card}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
