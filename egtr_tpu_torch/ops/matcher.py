"""Hungarian matching (PyTorch port of ``egtr_tpu/ops/matcher.py``).

The cost matrix is built on the device. The assignment itself is solved on
the host with ``scipy.optimize.linear_sum_assignment``, one image at a time,
as the original EGTR matcher does (model/deformable_detr.py:2886-3015): the
JAX package's in-jit Jonker-Volgenant solver exists to avoid a host
round-trip under ``jit``, which eager PyTorch does not need. Both solve the
same problem, so on costs without ties they return the same assignment.

Padded-target convention, as in the JAX package: each image has ``max_gt``
target slots; slot j is real iff ``j < num_boxes``. Only the real rows are
solved; pad slots get ``query_index = -1`` and never appear in ``gt_index``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from .boxes import box_cxcywh_to_xyxy, generalized_box_iou

_PAD_COST = 1e5  # constant cost of padded gt columns; >> any real cost


class MatchResult(NamedTuple):
    # per gt slot j: index of the query assigned to it (-1 on pad slots)
    query_index: torch.Tensor    # [B, G] int64
    # per gt slot j: the (smoothing-shifted) matching cost at the assignment;
    # meaningless on pad slots
    matching_cost: torch.Tensor  # [B, G] float32
    # per query q: matched gt slot, or -1
    gt_index: torch.Tensor       # [B, Q] int64


def compute_cost_matrix(logits, pred_boxes, tgt_ids, tgt_boxes, tgt_valid,
                        class_cost: float, bbox_cost: float, giou_cost: float,
                        smoothing: float, focal_alpha: float = 0.25,
                        focal_gamma: float = 2.0) -> torch.Tensor:
    """Cost matrix [B, Q, G], float32. Reference:
    deformable_detr.py:2949-2996. Padded target columns (``~tgt_valid``) are
    overwritten with ``_PAD_COST``."""
    out_prob = torch.sigmoid(logits.float())                  # [B,Q,C]
    alpha, gamma = focal_alpha, focal_gamma
    neg = (1 - alpha) * (out_prob ** gamma) * (-torch.log(1 - out_prob + 1e-8))
    pos = alpha * ((1 - out_prob) ** gamma) * (-torch.log(out_prob + 1e-8))
    safe_ids = tgt_ids.clamp(min=0).long()
    B, Q, _ = out_prob.shape
    cls = torch.gather(pos - neg, 2,
                       safe_ids[:, None, :].expand(B, Q, safe_ids.shape[1]))

    pred_boxes, tgt_boxes = pred_boxes.float(), tgt_boxes.float()
    bbox = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    giou = generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                               box_cxcywh_to_xyxy(tgt_boxes))  # [B,Q,G]

    cost = bbox_cost * bbox + class_cost * cls + giou_cost * (-giou)
    if smoothing:
        # shift so a perfect match sits at inverse_sigmoid(smoothing)
        # (deformable_detr.py:2987-2996)
        bias_eps = math.log(1e-8)
        cost_min = class_cost * (1 - alpha) * bias_eps - giou_cost
        inv_sig = -math.log(1.0 / smoothing - 1.0)
        cost = cost - cost_min + inv_sig
    return torch.where(tgt_valid[:, None, :], cost,
                       torch.full_like(cost, _PAD_COST))


@torch.no_grad()
def hungarian_match(cost: torch.Tensor, num_boxes: torch.Tensor
                    ) -> MatchResult:
    """Batched assignment. cost: [B, Q, G]; num_boxes: [B].

    One device-to-host copy of the cost matrix, scipy per image on the first
    ``num_boxes`` target rows, one copy back. Callers mask pad slots with
    ``j < num_boxes``, as in the JAX package."""
    B, Q, G = cost.shape
    if G > Q:
        raise ValueError("need at least as many queries as (padded) targets")
    cost_t = cost.detach().float().transpose(1, 2)           # [B, G, Q]
    host = cost_t.cpu().numpy()
    counts = num_boxes.cpu().numpy()
    col4row = np.full((B, G), -1, np.int64)
    gt_index = np.full((B, Q), -1, np.int64)
    for b in range(B):
        nb = int(counts[b])
        rows, cols = linear_sum_assignment(host[b, :nb])
        col4row[b, rows] = cols
        gt_index[b, cols] = rows
    query_index = torch.from_numpy(col4row).to(cost.device)
    matching_cost = torch.gather(
        cost_t, 2, query_index.clamp(min=0)[:, :, None])[..., 0]
    return MatchResult(query_index, matching_cost,
                       torch.from_numpy(gt_index).to(cost.device))
