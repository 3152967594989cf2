"""Trained-offsets windowed-MSDA accuracy experiment (PyTorch port of the
repo's ``scripts/exp_trained_offsets.py``).

The windowed (banded) MSDA approximation is checked against offsets that
training moved off their directional init, on the learnable synthetic VG
set (``scripts/make_synth_vg.py``):

  1. ``train``: fit the full EGTR model from scratch at the FPS-protocol
     shape (600x1000 -> one 608x1008 bucket), long enough for the encoder
     sampling offsets to move; ``--resume`` continues a run's full state,
     ``--init_from`` warm-starts the weights of a finished run under another
     ``--window``/``--band`` (the band-adaptation fine-tune).
  2. ``offsets``: histogram the trained encoder sampling offsets in level
     pixels and the attention-weighted share of in-image samples each
     (window, band) variant clamps (``offset_stats.json``).
  3. ``sweep``: evaluate exact and windowed variants on the test split: R@K,
     mR@K and the raw outputs' deltas to the exact path
     (``window_sweep.json``, incremental).

    python -m egtr_tpu_torch.scripts.exp_trained_offsets train \
        --data_path DIR --out OUT [--train_seconds 1800] [--batch 4] \
        [--window 16 --band point --init_from OUT0/artifact] [--resume] \
        [--device cpu]
    python -m egtr_tpu_torch.scripts.exp_trained_offsets offsets ...
    python -m egtr_tpu_torch.scripts.exp_trained_offsets sweep \
        --windows 0,16p,16pi,8p [--int8] ...

It runs on the GPU unless ``--device cpu`` is given, and raises where CUDA
is absent. What the JAX script has for the TPU and its compiler is left
out: ``maybe_aot`` (ahead-of-time compiled programs) and
``enable_compilation_cache``, since the port runs eagerly and compiles no
program. So ``compile_plus_eval_sec`` keeps its name, for the two reports
to compare, but holds a variant's evaluation seconds. ``offsets`` keeps the
artifact's MSDA implementation (the JAX script forces its gather path,
which in the port would bypass the kernels on the card); the offsets differ
from a gather run's by round-off only. The step generator's dropout masks
differ from JAX's PRNG draws, as in ``train_egtr``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

KEYS = ("logits", "pred_boxes", "pred_rel", "pred_connectivity")


def _model_kw(args):
    if not args.tiny:  # full EGTR architecture
        return {}
    # --tiny: CPU smoke-test scale for validating the script end-to-end
    return dict(d_model=64, encoder_layers=2, decoder_layers=2,
                encoder_ffn_dim=64, decoder_ffn_dim=64, num_queries=16)


def _bucket(args):
    return ((-(-args.size // 16) * 16, -(-args.max_size // 16) * 16),)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(args):
    """(cfg, model, train loader, fg_matrix, train dataset)."""
    from ..config import EgtrConfig
    from ..data.loader import Loader
    from ..data.visual_genome import VGDataset, vg_get_statistics
    from ..models.egtr import EgtrModel

    train_ds = VGDataset(args.data_path, "train", size=args.size,
                         max_size=args.max_size)
    num_rel = len(train_ds.rel_categories)
    cfg = EgtrConfig(
        num_labels=train_ds.num_classes(), num_rel_labels=num_rel,
        compute_dtype="bfloat16", max_gt_boxes=16, max_gt_rels=64,
        msda_window=args.window, msda_band=args.band,
        **(_model_kw(args) or {"num_queries": 200}))
    loader = Loader(train_ds, args.batch, shuffle=True, drop_last=True,
                    max_gt=cfg.max_gt_boxes, num_rel_labels=num_rel,
                    buckets=_bucket(args), num_workers=2)
    model = EgtrModel(cfg)
    fg = vg_get_statistics(train_ds)
    return cfg, model, loader, fg, train_ds


def _differing_fields(a, b, keep=lambda name: True) -> List[str]:
    return [f.name for f in dataclasses.fields(a)
            if keep(f.name) and getattr(a, f.name) != getattr(b, f.name)]


def cmd_train(args):
    """Train; returns the run's first and last step, the clock's seconds
    (from the end of the first step to the end of the last) and each step's
    total loss."""
    from ..config import EgtrConfig
    from ..infer import resolve_device
    from ..models.egtr import compute_freq_dists
    from ..models.layers import init_params
    from ..train.checkpoint import (CheckpointManager, load_pretrained,
                                    save_pretrained)
    from ..train.optim import make_optimizer
    from ..train.train_step import make_train_step
    from ..train.trainer import _payload, to_device

    device = resolve_device(args.device)
    if args.resume:
        # Resume must reproduce the producing run's architecture: the
        # CLI-derived config is held to the artifact's config.json (flag
        # drift would otherwise train another config and overwrite it)
        saved = EgtrConfig.load(
            os.path.join(args.out, "artifact", "config.json"))
        cfg, model, loader, fg, _ = build(args)
        if saved != cfg:
            diff = _differing_fields(saved, cfg)
            raise SystemExit(
                f"--resume: CLI-derived config disagrees with the "
                f"artifact's on fields {diff}; rerun with matching flags")
    else:
        cfg, model, loader, fg, _ = build(args)
    if not (args.resume or args.init_from):  # else the weights are loaded
        init_params(model, torch.Generator().manual_seed(args.seed))
    state = dict(model.state_dict())
    state["rel_dist"], state["triplet_dist"] = compute_freq_dists(
        fg, cfg.freq_bias_eps, cfg.use_log_softmax)

    if args.init_from:
        # adaptation fine-tune: warm-start the WEIGHTS from a finished
        # run's artifact and train under another msda_window/band, so the
        # offsets and attention adapt to the bands. Weights only: a new
        # phase in a new run directory starts with fresh AdamW moments
        init_cfg, init_state = load_pretrained(args.init_from)
        arch_fields = _differing_fields(
            init_cfg, cfg, keep=lambda name: not name.startswith("msda_"))
        if arch_fields:
            raise SystemExit(
                f"--init_from: architecture disagrees on {arch_fields}; "
                f"only msda_* fields may differ for an adaptation run")
        mismatched = sorted(
            set(state) ^ set(init_state)
            | {k for k in set(state) & set(init_state)
               if state[k].shape != init_state[k].shape})
        if mismatched:
            raise ValueError(f"--init_from: the artifact's entries differ "
                             f"in name or shape at {mismatched}")
        state = init_state
    model.load_state_dict(state, strict=True)
    model.to(device)

    # the offsets sit in the "backbone" LR group (optim.param_label), so
    # lr_backbone controls how fast they move; the flat high LRs are
    # deliberate: the goal is offsets far from their init
    tx = make_optimizer(model, args.lr, args.lr_backbone, lr_initialized=None,
                        initialized_paths=[])
    offset_groups = {label for name, label in tx.labels.items()
                     if "sampling_offsets" in name}
    if offset_groups != {"backbone"}:
        raise RuntimeError(f"the sampling offsets are in the LR groups "
                           f"{offset_groups}, not 'backbone'")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    mngr = CheckpointManager(os.path.join(args.out, "state"), max_to_keep=2)
    step = 0
    if args.resume:
        # the full state: weights, AdamW moments, the step counter and the
        # step generator (a weights-only warm start would restart Adam cold
        # and count the steps twice in the log)
        payload = mngr.restore(map_location=device)
        if payload is None:
            raise SystemExit(f"--resume: no state checkpoint under "
                             f"{args.out}/state")
        model.load_state_dict(payload["model"], strict=True)
        opt_state = tx.adamw.state_dict()
        opt_state["state"] = payload["optimizer"]
        tx.adamw.load_state_dict(opt_state)
        generator.set_state(payload["generator"].cpu())
        step = payload["loop"]["step"]
    start_step = step
    step_fn = make_train_step(model, cfg, tx, task="sgg")

    def save_state():
        mngr.save(step, _payload(model, tx, generator, float("inf"), 0,
                                 step))

    t0 = None  # the clock starts at the first completed step
    losses = []
    log = open(os.path.join(args.out, "train_log.jsonl"), "a")
    # run-header record: resumed runs append to the same file, and without
    # a delimiter the mixed clocks/step ranges cannot be parsed into runs
    log.write(json.dumps({
        "run_header": True, "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                 time.gmtime()),
        "resume": bool(args.resume), "start_step": step,
        "args": {k: v for k, v in vars(args).items()}}) + "\n")
    log.flush()
    while t0 is None or time.time() - t0 < args.train_seconds:
        epoch_steps = 0
        for batch in loader:
            metrics = step_fn(to_device(batch, device), generator)
            losses.append(metrics["total_loss"].detach())
            step += 1
            epoch_steps += 1
            if t0 is None:
                _sync(device)
                t0 = time.time()
            if step % 50 == 0:
                m = {k_: float(v) for k_, v in metrics.items()}
                rec = {"step": step, "sec": round(time.time() - t0, 1),
                       "total_loss": m["total_loss"],
                       "loss_rel": m.get("loss_rel"),
                       "loss_ce": m.get("loss_ce"),
                       "loss_bbox": m.get("loss_bbox")}
                log.write(json.dumps(rec) + "\n")
                log.flush()
                print(rec, flush=True)
            if step % args.ckpt_every == 0:
                save_pretrained(os.path.join(args.out, "artifact"), cfg,
                                model.state_dict())
                save_state()
            if time.time() - t0 >= args.train_seconds:
                break
        if epoch_steps == 0:
            raise SystemExit("loader yielded no batches — dataset empty or "
                             "every image filtered out")
    clock_seconds = time.time() - t0
    log.close()
    save_pretrained(os.path.join(args.out, "artifact"), cfg,
                    model.state_dict())
    if mngr.latest_step() != step:
        save_state()
    print(f"[exp] trained to step {step} in "
          f"{time.time() - (t0 or time.time()):.0f}s this run; artifact at "
          f"{args.out}/artifact", flush=True)
    return {"start_step": start_step, "step": step,
            "clock_seconds": clock_seconds,
            "losses": torch.stack(losses).float().cpu().tolist()}


def _clamp_fracs(enc_offs, enc_aws, shapes, D):
    """Attention-weighted fraction of in-image encoder samples CLAMPED by
    each (window, band) variant, computed with the band machinery of the
    windowed path (query_tile / segment_rows_t / window_rows) on the
    captured offsets, on their device: the approximation's miss rate.
    enc_offs/enc_aws: per-layer lists of [B,Q,H,L,P,2] offsets (level px)
    and softmaxed [B,Q,H,L,P] weights (tensors or numpy arrays)."""
    from ..ops.msda_window import (query_tile, segment_bounds,
                                   segment_rows_t, window_rows)

    enc_offs = [torch.as_tensor(o) for o in enc_offs]
    enc_aws = [torch.as_tensor(a) for a in enc_aws]
    device = enc_offs[0].device if enc_offs else torch.device("cpu")
    Q = sum(h * w for h, w in shapes)
    # encoder reference points = each query's own raster center,
    # normalized per level (valid_ratios = 1 on unpadded images), in
    # float64 as the JAX script's numpy makes them
    refs = []
    for (h, w) in shapes:
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        refs.append(np.stack([(xx.ravel() + 0.5) / w,
                              (yy.ravel() + 0.5) / h], -1))
    ref = torch.from_numpy(np.concatenate(refs, 0)).to(device)   # [Q, 2]
    segs = segment_bounds(Q, shapes)

    out = {}
    for win in (8, 16, 32):
        sums = {"tile": [0.0, 0.0], "point": [0.0, 0.0]}  # [clamped, in]
        for off, aw in zip(enc_offs, enc_aws):
            for lid, (h, w) in enumerate(shapes):
                if h <= win:
                    continue
                TQ = query_tile(win, D, w)
                # [B,Q,H,P]: a float32 division and a float64 sum, as
                # numpy computes it in the JAX script, rounded to the
                # float32 rows the JAX script selects its bands from; the
                # selection's weighted means are summed in float64, so
                # that a device's summation order does not move a band
                # (float32 sums in another order flip a near-tie)
                loc_y = ref[None, :, None, None, 1] + (
                    off[:, :, :, lid, :, 1].float() / h).double()
                iy = segment_rows_t((loc_y * h - 0.5).float().double(
                    ).permute(0, 2, 3, 1), segs, TQ)
                awr = segment_rows_t(aw[:, :, :, lid].float().double(
                    ).permute(0, 2, 3, 1), segs, TQ)
                for band in ("tile", "point"):
                    _, _, _, awe, inband, in_img = window_rows(
                        iy, awr, h, win, TQ, per_point=band == "point")
                    w_in = torch.where(in_img, awe, 0.0).double()
                    sums[band][0] += (w_in * ~inband).sum()
                    sums[band][1] += w_in.sum()
        for band, (csum, wsum) in sums.items():
            csum, wsum = float(csum), float(wsum)
            out[f"clamp_frac_win{win}_{band}"] = (
                csum / wsum if wsum else 0.0)
    return out


def encoder_sampling(model, cfg, batch, device):
    """One forward (eval mode) of ``batch`` with forward hooks on every
    encoder layer's ``self_attn.sampling_offsets`` and
    ``self_attn.attention_weights`` Dense (the decoder's ``encoder_attn``,
    also an MSDA module, is not hooked). Returns per layer, in the JAX
    script's order (the layer names sorted as strings), the offsets
    [B,Q,H,L,P,2] in level pixels and the softmaxed weights [B,Q,H,L,P],
    on ``device``."""
    H, L, P = (cfg.encoder_attention_heads, cfg.num_feature_levels,
               cfg.encoder_n_points)
    captured = {}
    hooks = []
    for i in range(cfg.encoder_layers):
        attn = getattr(model.model, f"encoder_layer_{i}").self_attn
        for part in ("sampling_offsets", "attention_weights"):
            def hook(_module, _inputs, output, key=(str(i), part)):
                captured[key] = output.detach()
            hooks.append(getattr(attn, part).register_forward_hook(hook))
    model.eval()
    try:
        with torch.no_grad():
            model(torch.from_numpy(batch["pixel_values"]).to(device),
                  torch.from_numpy(batch["pixel_mask"]).to(device))
    finally:
        for h in hooks:
            h.remove()
    offs, aws = [], []
    for layer in sorted({k[0] for k in captured}):
        off = captured[(layer, "sampling_offsets")]
        aw = captured[(layer, "attention_weights")]
        B, Q = off.shape[:2]
        offs.append(off.reshape(B, Q, H, L, P, 2))
        aws.append(aw.reshape(B, Q, H, L * P).softmax(-1).reshape(
            B, Q, H, L, P))
    return offs, aws


def _offset_stats(enc_offs, enc_aws, shapes, D):
    """Histogram the ENCODER sampling offsets that ``encoder_sampling``
    captured (the raw Dense outputs are in level pixels —
    deformable_detr.py:1066-1073 normalizes by (w, h)); ``shapes`` are the
    levels of the forward's padded images, D the head width."""
    stats = {}
    enc_all = [o.cpu().numpy() for o in enc_offs]
    if enc_all:
        raw = np.concatenate(enc_all, axis=1)       # [B,Q,H,L,P,2] signed
        off = np.abs(raw)
        for axis, nm in ((0, "x"), (1, "y")):
            a = off[..., axis].ravel()
            stats[f"enc_|{nm}|_p50"] = float(np.percentile(a, 50))
            stats[f"enc_|{nm}|_p90"] = float(np.percentile(a, 90))
            stats[f"enc_|{nm}|_p99"] = float(np.percentile(a, 99))
            stats[f"enc_|{nm}|_max"] = float(a.max())
        # fraction of y-offsets a half-band of win/2 contains — the
        # band="tile" clamp criterion (one band per query tile, so a
        # point's MEAN offset eats into the slack)
        ay = off[..., 1].ravel()
        for win in (16, 32):
            stats[f"enc_y_within_{win//2}px"] = float(
                (ay <= win / 2).mean())
        # band="point" criterion: each point has its own band, so only the
        # DEVIATION of a point's y-offset from that point's mean (per
        # layer/head/level/point, across queries: each encoder layer picks
        # its bands on its own) can clamp. It bounds from above the
        # within-tile deviation the kernel sees.
        dev = np.concatenate(
            [np.abs(o[..., 1] - o[..., 1].mean(axis=1, keepdims=True))
             for o in enc_all], axis=1)
        d = dev.ravel()
        stats["enc_y_dev_pp_p90"] = float(np.percentile(d, 90))
        stats["enc_y_dev_pp_p99"] = float(np.percentile(d, 99))
        stats["enc_y_dev_pp_max"] = float(d.max())
        for win in (16, 32):
            stats[f"enc_y_dev_pp_within_{win//2}px"] = float(
                (d <= win / 2).mean())
        # exact clamp fractions through the band machinery
        stats.update(_clamp_fracs(enc_offs, enc_aws, shapes, D))
    return stats


def _sweep_eval(model, cfg, ds, batch_size, buckets):
    """Forward + top-k postprocess over the test split on the model's
    device. Returns (recall metrics, raw outputs of the first batch as
    float32 numpy)."""
    from ..data.loader import Loader
    from ..evaluation.postprocess import rescale_boxes_np, sgg_postprocess
    from ..evaluation.runner import _to_host
    from ..utils.aot import maybe_aot
    from ..evaluation.sg_eval import (SceneGraphEvaluator,
                                      evaluate_mean_recall,
                                      evaluate_per_predicate)

    device = next(model.parameters()).device
    loader = Loader(ds, batch_size, shuffle=False, max_gt=cfg.max_gt_boxes,
                    num_rel_labels=cfg.num_rel_labels,
                    buckets=buckets, num_workers=2)
    single = SceneGraphEvaluator(multiple_preds=False)
    per_pred = {n: SceneGraphEvaluator(multiple_preds=False)
                for n in ds.rel_categories}
    raw0 = None

    def forward_post(pixel_values, pixel_mask):
        with torch.inference_mode():
            out = model(pixel_values, pixel_mask)
            post = sgg_postprocess(
                out["logits"], out["pred_boxes"], out["pred_rel"],
                out["pred_connectivity"], num_labels=cfg.num_labels,
                top_k=100)
        return {k: out[k] for k in KEYS}, post

    # one program per bucket (utils/aot.py), as the JAX script jits it
    program = maybe_aot(forward_post, "sweep_eval", device)
    model.eval()
    for bi, batch in enumerate(loader):
        out, post = program(
            torch.from_numpy(batch["pixel_values"]).to(device),
            torch.from_numpy(batch["pixel_mask"]).to(device))
        post = _to_host(post)
        # the raw Q^2-sized head outputs are compared for batch 0 only
        if bi == 0:
            raw0 = {k: out[k].float().cpu().numpy() for k in KEYS}
        del out
        for j in range(batch["pixel_values"].shape[0]):
            if "valid" in batch and not batch["valid"][j]:
                continue
            n_gt = int(batch["labels"]["num_boxes"][j])
            if n_gt == 0:
                continue
            rel_dense = batch["labels"]["rel"][j, :n_gt, :n_gt]
            gt_rels = np.argwhere(rel_dense > 0)
            if len(gt_rels) == 0:
                continue
            orig_hw = batch["orig_size"][j]
            gt_entry = {
                "gt_relations": gt_rels,
                "gt_boxes": rescale_boxes_np(
                    batch["labels"]["boxes"][j, :n_gt], orig_hw),
                "gt_classes": batch["labels"]["class_labels"][j, :n_gt],
            }
            entry = {
                "pred_boxes": rescale_boxes_np(post["pred_boxes"][j],
                                               orig_hw),
                "pred_classes": post["pred_classes"][j],
                "obj_scores": post["obj_scores"][j],
                "pred_rel_inds": post["single_inds"][j],
                "rel_scores": post["single_rel_vec"][j],
            }
            single.evaluate_entry(gt_entry, entry)
            evaluate_per_predicate(gt_entry, entry, per_pred,
                                   ds.rel_categories)
    metrics = dict(single.aggregate())
    metrics.update(evaluate_mean_recall(
        {n: e.aggregate() for n, e in per_pred.items()},
        len(ds.rel_categories)))
    return metrics, raw0


def parse_windows(windows: str, int8: bool):
    """The sweep's variants, (window, band, int8): "16" one band per tile,
    "16p" one band per point, a trailing "i" int8 stage 1 on top ("16pi");
    ``int8`` adds (0, tile, int8) and (16, tile, int8)."""
    variants = []
    for tok in windows.split(","):
        tok = tok.strip()
        if not tok:
            continue
        is_int8 = tok.endswith("i")
        tok = tok.rstrip("i")
        band = "point" if tok.endswith("p") else "tile"
        variants.append((int(tok.rstrip("p")), band, is_int8))
    if int8:
        variants += [(0, "tile", True), (16, "tile", True)]
    return variants


def variant_key(win: int, band: str, int8: bool) -> str:
    return (f"win{win}" + ("_pp" if band == "point" else "")
            + ("_int8" if int8 else ""))


def _load_model(cfg, state, device):
    from ..models.egtr import EgtrModel

    model = EgtrModel(cfg)
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def cmd_sweep(args):
    from ..data.visual_genome import VGDataset
    from ..infer import resolve_device
    from ..train.checkpoint import load_pretrained

    device = resolve_device(args.device)
    cfg, state = load_pretrained(os.path.join(args.out, "artifact"))
    cfg = cfg.replace(dropout=0.0)
    if args.tiny:
        cfg = cfg.replace(**_model_kw(args))
    test_ds = VGDataset(args.data_path, "test", size=args.size,
                        max_size=args.max_size)

    # The report is INCREMENTAL: every finished variant is persisted at
    # once, variants already measured are skipped on a rerun, and the exact
    # path's batch-0 raw outputs are cached on disk for later deltas.
    path = os.path.join(args.out, "window_sweep.json")
    report = json.load(open(path)) if os.path.exists(path) else {}
    off_path = os.path.join(args.out, "offset_stats.json")
    if os.path.exists(off_path):  # written by the `offsets` command
        report["offsets"] = json.load(open(off_path))
    npz_path = os.path.join(args.out, "exact_raw0.npz")
    raw0 = dict(np.load(npz_path)) if os.path.exists(npz_path) else None

    def flush():
        with open(path, "w") as f:
            json.dump(report, f, indent=2)

    for win, band, int8 in parse_windows(args.windows, args.int8):
        key = variant_key(win, band, int8)
        exact = (win, int8) == (0, False)
        if key in report and (raw0 is not None or not exact):
            print(f"[exp] {key}: already measured, skipping", flush=True)
            continue
        c = cfg.replace(msda_window=win, msda_band=band, msda_int8=int8)
        model = _load_model(c, state, device)
        _sync(device)
        t0 = time.time()
        metrics, raw = _sweep_eval(model, c, test_ds, args.batch,
                                   _bucket(args))
        _sync(device)
        seconds = time.time() - t0
        del model
        report.setdefault(key, {
            **{k: metrics.get(k) for k in
               ("R@20", "R@50", "R@100", "mR@20", "mR@50", "mR@100")},
            "compile_plus_eval_sec": round(seconds, 1),
        })
        print(f"[exp] {key}: {report[key]}", flush=True)
        if exact:
            raw0 = raw
            np.savez(npz_path, **raw)
        elif raw0 is not None:
            deltas = {}
            for k in raw0:
                d = np.abs(raw[k].astype(np.float64)
                           - raw0[k].astype(np.float64))
                scale = float(np.abs(raw0[k]).max()) or 1.0
                deltas[k] = {"max_abs": float(d.max()),
                             "mean_abs": float(d.mean()),
                             "max_rel_of_scale": float(d.max() / scale)}
            report[f"{key}_vs_exact_outputs"] = deltas
        flush()

    flush()
    print(f"[exp] report written to {path}", flush=True)
    return report


def cmd_offsets(args):
    """The offset statistics of the artifact on the test split's first
    ``min(--batch, 2)`` images, on the card through the exact kernel
    (``--device cpu``: on the CPU). Returns the statistics and the per-layer
    offsets and weights they were drawn from, on the device."""
    from ..data.loader import Loader
    from ..data.visual_genome import VGDataset
    from ..infer import resolve_device
    from ..models.detr import level_shapes
    from ..train.checkpoint import load_pretrained

    device = resolve_device(args.device)
    cfg, state = load_pretrained(os.path.join(args.out, "artifact"))
    cfg = cfg.replace(dropout=0.0, msda_window=0)
    test_ds = VGDataset(args.data_path, "test", size=args.size,
                        max_size=args.max_size)
    batch0 = next(iter(Loader(
        test_ds, min(args.batch, 2), shuffle=False, max_gt=cfg.max_gt_boxes,
        num_rel_labels=cfg.num_rel_labels, buckets=_bucket(args),
        num_workers=2)))
    offs, aws = encoder_sampling(_load_model(cfg, state, device), cfg,
                                 batch0, device)
    shapes = level_shapes(batch0["pixel_values"].shape[1:3],
                          cfg.num_feature_levels, cfg.dilation)
    stats = _offset_stats(offs, aws, shapes,
                          cfg.d_model // cfg.encoder_attention_heads)
    path = os.path.join(args.out, "offset_stats.json")
    with open(path, "w") as f:
        json.dump(stats, f, indent=2)
    print("[exp] offset stats:", stats, flush=True)
    return {"stats": stats, "offsets": offs, "weights": aws}


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=["train", "sweep", "offsets"])
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lr_backbone", type=float, default=5e-5)
    ap.add_argument("--init_from", default=None,
                    help="train-time weights-only warm start from a "
                         "finished run's artifact dir (adaptation "
                         "fine-tune under a different msda_window/band)")
    ap.add_argument("--band", default="tile", choices=["tile", "point"],
                    help="train-time band mode when --window > 0")
    ap.add_argument("--window", type=int, default=0,
                    help="training-time msda_window (0 = exact)")
    ap.add_argument("--windows", default="0,16,32",
                    help="sweep-time window list")
    ap.add_argument("--int8", action="store_true",
                    help="sweep also evaluates int8 and win16+int8 "
                         "variants")
    ap.add_argument("--train_seconds", type=int, default=3600 * 3,
                    help="training budget (the clock starts at the first "
                         "completed step)")
    ap.add_argument("--resume", action="store_true",
                    help="train: continue the full state under --out/state")
    ap.add_argument("--ckpt_every", type=int, default=500)
    ap.add_argument("--size", type=int, default=600)
    ap.add_argument("--max_size", type=int, default=1000)
    ap.add_argument("--tiny", action="store_true",
                    help="shrunken model + shapes for CPU smoke tests")
    ap.add_argument("--seed", type=int, default=0)
    # the port's own
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises where CUDA is absent)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Run one command; returns what it returns (train: its steps, clock
    and losses; sweep: the report; offsets: the statistics with the
    captured offsets and weights)."""
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    commands = {"train": cmd_train, "sweep": cmd_sweep,
                "offsets": cmd_offsets}
    return commands[args.cmd](args)


if __name__ == "__main__":
    main()
