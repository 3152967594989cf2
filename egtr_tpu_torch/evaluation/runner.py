"""Reusable SGG/detection evaluation loop (PyTorch port of
``egtr_tpu/evaluation/runner.py``).

The training driver runs it after fitting, as the reference does
(train_egtr.py:879-935, pretrain_detr.py:500-542), and dumps a metrics JSON
next to the artifact. The forward runs under ``torch.no_grad()`` in eval
mode on the model's device, the top-k post-processing there too, and the
small top-k results cross to the host once per batch; the evaluators are
numpy.

Detection (COCO) updates run for EVERY image — including images with zero
ground-truth relations — matching the reference, which evaluates detection
on the whole split (train_egtr.py:369-396) while the SGG recall evaluator
skips relation-less images. One process evaluates the whole split; the
evaluators' ``merge_state`` is there for several.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .coco_eval import CocoEvaluator
from .postprocess import (detection_postprocess, rescale_boxes_np,
                          sgg_postprocess)
from .sg_eval import (SceneGraphEvaluator, evaluate_mean_recall,
                      evaluate_per_predicate)


def _to_host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One copy to the host per batch; floating tensors as float32."""
    return {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
            for k, v in tensors.items()}


def _forward(model, batch):
    device = next(model.parameters()).device
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(batch["pixel_values"]).to(device),
                     torch.from_numpy(batch["pixel_mask"]).to(device))


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

    oi_evaluator: the Open Images evaluator, not ported yet (it needs
    ``evaluation/oi_eval.py``): anything but None raises.
    categories: detection category ids for the COCO evaluator (defaults to
    range(num_labels)).
    """
    if oi_evaluator is not None:
        raise NotImplementedError(
            "the Open Images evaluation (evaluation/oi_eval.py) is not "
            "ported yet")
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

    n_img = 0
    for batch in loader:
        out = _forward(model, batch)
        post = sgg_postprocess(
            out["logits"], out["pred_boxes"], out["pred_rel"],
            out["pred_connectivity"], num_labels=cfg.num_labels, top_k=100)
        if coco is not None:
            det = _detections(out)
            post["det_scores"] = det["scores"]
            post["det_labels"] = det["labels"]
            post["det_boxes_norm"] = det["boxes"]
        post = _to_host(post)
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
        if max_images and n_img >= max_images:
            break

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
    return metrics


def evaluate_detection(model, cfg, loader, *,
                       max_images: Optional[int] = None,
                       categories=None) -> Dict[str, float]:
    """COCO-protocol detection evaluation for the base detector — the
    end-of-pretraining eval of reference pretrain_detr.py:500-542."""
    coco = CocoEvaluator(sorted(categories) if categories is not None
                         else list(range(cfg.num_labels)))
    n_img = 0
    for batch in loader:
        det = _to_host(_detections(_forward(model, batch)))
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
        if max_images and n_img >= max_images:
            break
    return {f"coco/{k}": v for k, v in coco.summarize().items()}


def write_metrics(metrics: Dict[str, float], path: str,
                  extra: Optional[dict] = None) -> None:
    """Dump the metrics JSON the reference writes next to the checkpoint
    (train_egtr.py:928-935)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({**metrics, **(extra or {})}, f, indent=2, default=float)
