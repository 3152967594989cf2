"""On-device eval postprocessing: top-k triplet scoring (PyTorch port of
``egtr_tpu/evaluation/postprocess.py``).

Semantics match the reference's evaluate_batch (train_egtr.py:56-94):

- obj_scores/classes = max softmax over the first num_labels classes
- sub_ob = outer(obj_scores) with zero diagonal (no self-relations)
- pred_rel is clamped to [0,1] and multiplied by clamped connectivity
- multiple-preds: top-k over Q*Q*R triplet scores -> (s, o, p)
- single-preds (graph constraint): top-k over Q*Q of max-predicate score
  -> (s, o) plus the full R-vector of relation scores for those pairs

``torch.topk`` may order tied scores differently from ``jax.lax.top_k``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.boxes import box_cxcywh_to_xyxy


def sgg_postprocess(logits, pred_boxes, pred_rel, pred_connectivity, *,
                    num_labels: int, top_k: int = 100
                    ) -> Dict[str, torch.Tensor]:
    """Per-batch top-k triplets. Returns a dict of small tensors.

    logits [B,Q,C], pred_boxes [B,Q,4] (cxcywh, normalized),
    pred_rel [B,Q,Q,R] (sigmoid), pred_connectivity [B,Q,Q,1] (sigmoid).
    """
    B, Q, _ = logits.shape
    R = pred_rel.shape[-1]
    top_k = min(top_k, Q * Q)  # tiny-config guard

    probs = logits.softmax(-1)[..., :num_labels]
    obj_scores, pred_classes = probs.max(-1)                 # [B,Q]

    sub_ob = obj_scores[:, :, None] * obj_scores[:, None, :]
    eye = torch.eye(Q, dtype=torch.bool, device=logits.device)[None]
    sub_ob = sub_ob.masked_fill(eye, 0.0)                    # [B,Q,Q]

    rel = pred_rel.clamp(0.0, 1.0) * pred_connectivity.clamp(0.0, 1.0)

    # multiple-preds path: top-k over the full triplet tensor
    trip = rel * sub_ob[..., None]                           # [B,Q,Q,R]
    mult_scores, mult_idx = trip.reshape(B, -1).topk(top_k, dim=1)
    mult_s = torch.div(mult_idx, Q * R, rounding_mode="floor")
    mult_o = torch.div(mult_idx, R, rounding_mode="floor") % Q
    mult_p = mult_idx % R
    mult_rel_scores = rel.reshape(B, -1).gather(1, mult_idx)

    # single-preds path: top-k over pairs of max-predicate score
    pair_score = rel.amax(-1) * sub_ob                       # [B,Q,Q]
    single_scores, single_idx = pair_score.reshape(B, -1).topk(top_k, dim=1)
    single_s = torch.div(single_idx, Q, rounding_mode="floor")
    single_o = single_idx % Q
    single_rel_vec = rel.reshape(B, Q * Q, R).gather(
        1, single_idx[..., None].expand(B, top_k, R))        # [B,k,R]

    return {
        "obj_scores": obj_scores,
        "pred_classes": pred_classes,
        "pred_boxes": pred_boxes,
        "mult_inds": torch.stack([mult_s, mult_o, mult_p], -1),  # [B,k,3]
        "mult_rel_scores": mult_rel_scores,                      # [B,k]
        "mult_trip_scores": mult_scores,
        "single_inds": torch.stack([single_s, single_o], -1),    # [B,k,2]
        "single_rel_vec": single_rel_vec,                        # [B,k,R]
        "single_pair_scores": single_scores,
    }


def detection_postprocess(logits, pred_boxes, target_sizes, top_k: int = 100
                          ) -> Dict[str, torch.Tensor]:
    """COCO-style detection post-processing.

    Reference: DeformableDetrFeatureExtractor.post_process
    (deformable_detr.py:273-319): sigmoid probs, top-100 over the flattened
    Q x C grid, gather boxes, scale to absolute (h, w) coordinates.
    Returns dict(scores [B,k], labels [B,k], boxes [B,k,4] xyxy abs).
    """
    B, Q, C = logits.shape
    top_k = min(top_k, Q * C)
    prob = logits.sigmoid().reshape(B, -1)
    scores, idx = prob.topk(top_k, dim=1)
    box_idx = torch.div(idx, C, rounding_mode="floor")
    labels = idx % C
    xyxy = box_cxcywh_to_xyxy(pred_boxes)
    boxes = xyxy.gather(1, box_idx[..., None].expand(B, top_k, 4))
    img_h = target_sizes[:, 0].to(boxes.dtype)
    img_w = target_sizes[:, 1].to(boxes.dtype)
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)[:, None, :]
    return {"scores": scores, "labels": labels, "boxes": boxes * scale}
