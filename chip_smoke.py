"""Drive the PyTorch port (egtr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Every phase runs unguarded; any failure ends the script with a nonzero exit
and no result line. In order it:

1. prints the card's name and power limit (nvidia-smi);
2. builds the hand-written MSDA forward kernel from egtr_tpu_torch/csrc;
3. holds the kernel against its plain PyTorch version at the main path's
   shapes (608x1008 bucket: levels (76,126),(38,63),(19,32),(10,16),
   S = 12738; encoder call Q = S, decoder call Q = 200; 8 heads of 32) in
   float32 and bfloat16, times both with CUDA events, and checks the
   kernel's batch addressing on a batch of 2;
4. serves a few requests through ``infer.infer`` with the bench
   configuration at full width (ResNet-50, d_model 256, 6+6 layers, 200
   queries, 150/50 labels, bfloat16, seeded random weights) and checks the
   outputs and that the kernel ran 12 times per forward;
5. runs the same model in float32 (TF32 off) through the kernel and through
   the plain MSDA and compares logits, boxes and relation scores;
6. prints a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` last.

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
from egtr_tpu_torch.ops import msda, msda_cuda

# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores, where the kernel does its arithmetic
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# flops per sampled (query, head, level, point) and channel: two 2-corner
# dot products (3 each) and their weighted sum into the accumulator (4)
FLOPS_PER_SAMPLE_CHANNEL = 10

# kernel vs plain: float32 differs only in the order of summation; bf16
# outputs may differ by one rounding of the float32 sum (2**-8), allow two
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 2 * 2.0 ** -8)}
# float32 model, kernel vs plain MSDA: summation order in 12 MSDA calls,
# carried through the decoder and the heads
MODEL_ATOL = 1e-3

H, D, L, P = 8, 32, 4, 4
N_REQUESTS = 8
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


def bound(value, loc, aw, out):
    """Least time for the call on the card: each input read once and the
    output written once over the HBM rate, against the flops over the
    float32 rate. Returns (ms, "bytes" | "operations")."""
    nbytes = sum(t.numel() * t.element_size() for t in (value, loc, aw, out))
    flops = aw.numel() * D * FLOPS_PER_SAMPLE_CHANNEL
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = flops / FP32_FLOPS * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def check_kernel(shapes):
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
                "call": call, "Q": Q, "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err.max().item(),
                "max_err_over_limit": (err / limit).max().item(),
                "ms": cuda_ms(lambda: msda_cuda.msda_fwd(value, shapes, loc,
                                                         aw), 200),
                "plain_ms": cuda_ms(lambda: msda.ms_deform_attn_plain(
                    value, shapes, loc, aw), 10),
            }
            row["bound_ms"], row["bound_by"] = bound(value, loc, aw, kern)
            print(f"msda_fwd {call} Q={Q} {row['dtype']}: max abs err "
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
    print(f"msda_fwd decoder batch 2 float32: max abs err "
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
    # random init zeroes the offset and weight kernels, so sampling would
    # not depend on the image; give them seeded noise
    g = torch.Generator(device=x.device).manual_seed(1)
    with torch.no_grad():
        for name, p in model_k.named_parameters():
            if name.endswith(("sampling_offsets.weight",
                              "attention_weights.weight")):
                p.normal_(0.0, 0.1, generator=g)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it needs one GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = msda_cuda.build()
    print(f"kernel build: {lib.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    cfg = infer.bench_config()
    shapes = level_shapes(infer.BUCKET_HW, cfg.num_feature_levels)
    rows = check_kernel(shapes)
    launches, _ = serve(cfg)
    model_errs = compare_f32(cfg)

    main_row = next(r for r in rows
                    if r["call"] == "encoder" and r["dtype"] == "bfloat16")
    kernels = {"kernels": [{
        "name": "msda_fwd",
        "route": "cuda",
        "source": "egtr_tpu_torch/csrc/msda_fwd.cu",
        "replaces": "egtr_tpu/ops/msda_pallas.py:144",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["dtype"] == "bfloat16"),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "ms_encoder": main_row["ms"],
        "ms_decoder": next(r["ms"] for r in rows if r["call"] == "decoder"
                           and r["dtype"] == "bfloat16"),
        "max_abs_err_bf16": max(r["max_abs_err"] for r in rows
                                if r["dtype"] == "bfloat16"),
        "calls": rows,
        "model_f32_max_abs_err": model_errs,
    }]}
    print(json.dumps(kernels))
    print(f"total {time.perf_counter() - t_start:.1f} s; card: {card}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
