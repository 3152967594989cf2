"""Reusable SGG/detection evaluation loop (PyTorch port of
``egtr_tpu/evaluation/runner.py``).

The training driver runs it after fitting, as the reference does
(train_egtr.py:879-935, pretrain_detr.py:500-542), and dumps a metrics JSON
next to the artifact. The forward runs under ``torch.no_grad()`` in eval
mode on the model's device, the top-k post-processing there too, as one
program per batch signature (``infer_program``: on the card a captured CUDA
graph, as the JAX runner jits its ``infer``), and the small top-k results
cross to the host once per batch; the evaluators are numpy.

Detection (COCO) updates run for EVERY image — including images with zero
ground-truth relations — matching the reference, which evaluates detection
on the whole split (train_egtr.py:369-396) while the SGG recall evaluator
skips relation-less images. In a process group (``parallel.dist``) each
data rank evaluates its slice of the split (the loader's, pad rows skipped,
so the data ranks' image ids are disjoint); before aggregating, every rank
folds the other data ranks' evaluator states into its own
(``_merge_across_hosts``, over the mesh's data group: the ranks of a model
group evaluate the same images and hold the same states, so each image is
counted once), in the order one process would have evaluated the images,
so every rank returns the single-process metrics. Only the primary writes
them (``write_metrics``).

For Open Images (``oi_evaluator``) the forward also yields ``rel_full``, the
clipped relation scores times the clipped connectivity over all Q^2 pairs
([B, Q, Q, R] float32, computed on the device), which crosses to the host
with the batch's top-k results; the evaluator scores every (subject,
object) pair of each image that has relations.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..parallel import dist
from ..utils.aot import maybe_aot
from .coco_eval import CocoEvaluator
from .postprocess import (detection_postprocess, rescale_boxes_np,
                          sgg_postprocess)
from .sg_eval import (SceneGraphEvaluator, evaluate_mean_recall,
                      evaluate_per_predicate)


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One copy to the host per batch; floating tensors as float32."""
    return {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
            for k, v in tensors.items()}


def infer_program(model, cfg, *, sgg: bool = True, coco: bool = False,
                  oi: bool = False):
    """``run(batch) -> dict of tensors``: a loader batch's forward and its
    post-processing on the model's device in one program (JAX
    ``runner.py:46-67``): ``sgg_postprocess``'s top-k (``sgg``), the top-100
    detections as ``det_scores``/``det_labels``/``det_boxes_norm``
    (``coco``) and ``rel_full`` (``oi``). On the card one captured program
    per input signature (``utils/aot.maybe_aot``)."""
    device = next(model.parameters()).device

    def forward_post(pixel_values, pixel_mask):
        with torch.no_grad():
            out = model(pixel_values, pixel_mask)
            post = sgg_postprocess(
                out["logits"], out["pred_boxes"], out["pred_rel"],
                out["pred_connectivity"], num_labels=cfg.num_labels,
                top_k=100) if sgg else {}
            if coco:
                det = _detections(out)
                post["det_scores"] = det["scores"]
                post["det_labels"] = det["labels"]
                post["det_boxes_norm"] = det["boxes"]
            if oi:
                post["rel_full"] = rel_full(out)
        return post

    program = maybe_aot(forward_post, "infer", device)

    def run(batch):
        model.eval()
        return program(torch.from_numpy(batch["pixel_values"]).to(device),
                       torch.from_numpy(batch["pixel_mask"]).to(device))

    return run


def _in_order(states, chunks):
    """One evaluator state made of ``chunks``, (rank, first, end) runs of
    the ranks' ``states``, in that order."""
    def cat(get):
        return [x for r, lo, hi in chunks for x in get(states[r])[lo:hi]]

    if isinstance(states[0], list):                   # OIEvaluator
        return cat(lambda s: s)
    if "recalls" in states[0]:                        # SceneGraphEvaluator
        return {"recalls": {k: cat(lambda s: s["recalls"][k])
                            for k in states[0]["recalls"]},
                "image_ids": cat(lambda s: s["image_ids"])}
    merged = {"gts": {}, "dts": {}, "img_ids": cat(lambda s: s["img_ids"])}
    for s in states:                                  # CocoEvaluator
        merged["gts"].update(s["gts"])
        merged["dts"].update(s["dts"])
    return merged


def _merge_across_hosts(evaluators, marks, mesh=None) -> None:
    """Fold every rank's evaluator state into the local evaluators (JAX
    ``runner.py:207-221``; the reference's pickle all_gather,
    util/misc.py:93-135). ``marks[i]``: evaluator i's image count after
    each batch, so that the merged state takes the ranks' images batch by
    batch, rank by rank: the single-process order, which the COCO and OI
    evaluators' score sorts depend on where scores tie. ``mesh``: the merge
    runs over its data group (None: every rank is a data rank). No-op
    without a process group or with one data rank."""
    if not dist.is_distributed() or (mesh is not None and mesh.dp == 1):
        return
    gathered = dist.all_gather_objects(
        [(e.state(), m) for e, m in zip(evaluators, marks)],
        mesh.data_group if mesh is not None else None)
    for i, e in enumerate(evaluators):
        states = [g[i][0] for g in gathered]
        ends = [g[i][1] for g in gathered]
        chunks = []
        for b in range(max(len(m) for m in ends)):
            for r, m in enumerate(ends):
                if b < len(m):
                    chunks.append((r, m[b - 1] if b else 0, m[b]))
        e.clear()
        e.merge_state(_in_order(states, chunks))


def _mark(evaluators, marks) -> None:
    for e, m in zip(evaluators, marks):
        m.append(e.num_images())


def _detections(out) -> Dict[str, torch.Tensor]:
    """Top-100 detections at unit scale (rescaled on the host)."""
    ones = torch.ones((out["logits"].shape[0], 2), dtype=torch.int32,
                      device=out["logits"].device)
    return detection_postprocess(out["logits"], out["pred_boxes"], ones,
                                 top_k=100)


def evaluate_sgg(model, cfg, loader, rel_categories: Sequence[str], *,
                 eval_single_preds: bool = True,
                 eval_multiple_preds: bool = False,
                 coco_eval: bool = False,
                 oi_evaluator=None,
                 max_images: Optional[int] = None,
                 categories=None) -> Dict[str, float]:
    """Run the full evaluation protocol over ``loader``; returns metrics.

    oi_evaluator: an ``oi_eval.OIEvaluator`` for Open Images runs (scores
    all Q^2 pairs, reference train_egtr.py:154-173); None for Visual Genome.
    categories: detection category ids for the COCO evaluator (defaults to
    range(num_labels)). The evaluators merge over the data group of the
    model's mesh (``model.mesh``; None: every rank is a data rank).
    """
    coco = None
    if coco_eval:
        # VG detection eval re-offsets category ids by +1
        # (lib/evaluation/coco_eval.py:44-45)
        coco = CocoEvaluator(sorted(categories)
                             if categories is not None
                             else list(range(cfg.num_labels)))

    single = SceneGraphEvaluator(multiple_preds=False) \
        if eval_single_preds else None
    multiple = SceneGraphEvaluator(multiple_preds=True) \
        if eval_multiple_preds else None
    per_pred_single = {name: SceneGraphEvaluator(multiple_preds=False)
                       for name in rel_categories} \
        if eval_single_preds else None
    # the reference computes mean recall for BOTH evaluator modes — the
    # paper reports the unconstrained mR from the multiple-preds list
    # (train_egtr.py:112-121,410-417, sg_eval.py:331-372)
    per_pred_multiple = {name: SceneGraphEvaluator(multiple_preds=True)
                         for name in rel_categories} \
        if eval_multiple_preds else None

    evaluators = [e for e in (single, multiple, coco, oi_evaluator)
                  if e is not None]
    for per_pred in (per_pred_single, per_pred_multiple):
        evaluators += list((per_pred or {}).values())
    marks = [[] for _ in evaluators]
    n_img = 0
    so_pairs = {}
    run = infer_program(model, cfg, coco=coco is not None,
                        oi=oi_evaluator is not None)
    for batch in loader:
        post = _to_host(run(batch))
        B = batch["pixel_values"].shape[0]
        for j in range(B):
            # pad rows of a trailing partial batch (valid=False) are
            # duplicates — skip so each image is counted exactly once
            if "valid" in batch and not batch["valid"][j]:
                continue
            image_id = int(batch["image_id"][j])
            n_gt = int(batch["labels"]["num_boxes"][j])
            orig_hw = batch["orig_size"][j]
            gt_boxes_abs = rescale_boxes_np(
                batch["labels"]["boxes"][j, :n_gt], orig_hw)
            gt_classes = batch["labels"]["class_labels"][j, :n_gt]

            # detection is evaluated on every image, relations or not
            # (reference train_egtr.py:369-396)
            if coco is not None:
                h0, w0 = float(orig_hw[0]), float(orig_hw[1])
                det_boxes = post["det_boxes_norm"][j] * np.array(
                    [w0, h0, w0, h0])
                coco.update(image_id, gt_boxes_abs, gt_classes + 1,
                            det_boxes, post["det_scores"][j],
                            post["det_labels"][j] + 1)
            n_img += 1

            if n_gt == 0:
                continue
            rel_dense = batch["labels"]["rel"][j, :n_gt, :n_gt]
            gt_rels = np.argwhere(rel_dense > 0)
            if len(gt_rels) == 0:
                continue
            gt_entry = {
                "gt_relations": gt_rels,
                "gt_boxes": gt_boxes_abs,
                "gt_classes": gt_classes,
            }
            pred_boxes_abs = rescale_boxes_np(post["pred_boxes"][j], orig_hw)
            for evaluator, per_pred, inds, scores in (
                    (single, per_pred_single, "single_inds",
                     "single_rel_vec"),
                    (multiple, per_pred_multiple, "mult_inds",
                     "mult_rel_scores")):
                if evaluator is None:
                    continue
                entry = {
                    "pred_boxes": pred_boxes_abs,
                    "pred_classes": post["pred_classes"][j],
                    "obj_scores": post["obj_scores"][j],
                    "pred_rel_inds": post[inds][j],
                    "rel_scores": post[scores][j],
                }
                evaluator.evaluate_entry(gt_entry, entry, image_id=image_id)
                evaluate_per_predicate(gt_entry, entry, per_pred,
                                       rel_categories, image_id=image_id)
            if oi_evaluator is not None:
                Q = post["pred_classes"].shape[1]
                if so_pairs.get("Q") != Q:
                    # all Q^2 (subject, object) index pairs, built once; the
                    # reference rebuilds them per image
                    # (train_egtr.py:154-173)
                    so_pairs = {"Q": Q, "pairs": np.indices(
                        (Q, Q)).reshape(2, -1).T}
                oi_evaluator(gt_entry, {
                    "pred_boxes": pred_boxes_abs,
                    "pred_classes": post["pred_classes"][j],
                    "obj_scores": post["obj_scores"][j],
                    "sbj_obj_inds": so_pairs["pairs"],
                    "pred_scores": post["rel_full"][j].reshape(
                        -1, cfg.num_rel_labels),
                })
        _mark(evaluators, marks)
        if max_images and n_img >= max_images:
            break
    _merge_across_hosts(evaluators, marks, getattr(model, "mesh", None))

    metrics: Dict[str, float] = {}
    for label, evaluator, per_pred in (("single", single, per_pred_single),
                                       ("multiple", multiple,
                                        per_pred_multiple)):
        if evaluator is None:
            continue
        metrics.update({f"{label}/{k}": v
                        for k, v in evaluator.aggregate().items()})
        results = {n: e.aggregate() for n, e in per_pred.items()}
        metrics.update({f"{label}/{k}": v for k, v in evaluate_mean_recall(
            results, len(rel_categories)).items()})
    if coco is not None:
        metrics.update({f"coco/{k}": v for k, v in coco.summarize().items()})
    if oi_evaluator is not None:
        metrics.update({f"oi/{k}": v for k, v in
                        oi_evaluator.aggregate_metrics().items()})
    return metrics


def rel_full(out) -> torch.Tensor:
    """The Open Images evaluation's scores of every (subject, object,
    predicate): clip(pred_rel, 0, 1) * clip(pred_connectivity, 0, 1), [B, Q,
    Q, R] (egtr_tpu's runner.py:61-63)."""
    return (out["pred_rel"].clamp(0, 1)
            * out["pred_connectivity"].clamp(0, 1))


def evaluate_detection(model, cfg, loader, *,
                       max_images: Optional[int] = None,
                       categories=None, mesh=None) -> Dict[str, float]:
    """COCO-protocol detection evaluation for the base detector — the
    end-of-pretraining eval of reference pretrain_detr.py:500-542. ``mesh``:
    the ranks' layout, whose data group the merge runs over (None: every
    rank a data rank)."""
    coco = CocoEvaluator(sorted(categories) if categories is not None
                         else list(range(cfg.num_labels)))
    marks = [[]]
    n_img = 0
    run = infer_program(model, cfg, sgg=False, coco=True)
    for batch in loader:
        det = _to_host(run(batch))
        det = {"scores": det["det_scores"], "labels": det["det_labels"],
               "boxes": det["det_boxes_norm"]}
        B = batch["pixel_values"].shape[0]
        for j in range(B):
            if "valid" in batch and not batch["valid"][j]:
                continue
            n_gt = int(batch["labels"]["num_boxes"][j])
            orig_hw = batch["orig_size"][j]
            h0, w0 = float(orig_hw[0]), float(orig_hw[1])
            coco.update(
                int(batch["image_id"][j]),
                rescale_boxes_np(batch["labels"]["boxes"][j, :n_gt], orig_hw),
                batch["labels"]["class_labels"][j, :n_gt] + 1,
                det["boxes"][j] * np.array([w0, h0, w0, h0]),
                det["scores"][j], det["labels"][j] + 1)
            n_img += 1
        _mark([coco], marks)
        if max_images and n_img >= max_images:
            break
    _merge_across_hosts([coco], marks, mesh)
    return {f"coco/{k}": v for k, v in coco.summarize().items()}


def write_metrics(metrics: Dict[str, float], path: str,
                  extra: Optional[dict] = None) -> None:
    """Dump the metrics JSON the reference writes next to the checkpoint
    (train_egtr.py:928-935). The primary rank only: after the merge every
    rank holds the same metrics."""
    if not dist.is_primary():
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({**metrics, **(extra or {})}, f, indent=2, default=float)
