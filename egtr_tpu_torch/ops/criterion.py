"""Detection + scene-graph losses on padded, masked targets (PyTorch port of
``egtr_tpu/ops/criterion.py``).

Re-expression of ``DeformableDetrLoss`` (model/deformable_detr.py:2653-2861)
and ``SceneGraphGenerationLoss`` (model/egtr.py:544-1034) in the JAX
package's fixed-shape form: masked reductions and fixed-K top-k selections
with rank masking instead of per-image loops and index lists. The loss values
are the reference's.

Padded target convention:
    class_labels [B, G] int, boxes [B, G, 4] cxcywh (pad = (0.5,0.5,1,1)),
    num_boxes [B] int, rel [B, G, G, R] {0,1}.

Normalization is per process, as in the reference (egtr.py:976-980 keeps the
``num_boxes`` all-reduce commented out).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import EgtrConfig
from .boxes import box_cxcywh_to_xyxy, generalized_box_iou
from .losses import bce_with_logits, sigmoid_focal_loss_elementwise
from .matcher import MatchResult, compute_cost_matrix, hungarian_match


def nonmatching_cost(cfg: EgtrConfig) -> float:
    """Analytic max matching cost for unmatched queries (egtr.py:598-603)."""
    return float(
        -math.log(1e-8) * cfg.ce_loss_coefficient
        + 4 * cfg.bbox_cost
        + 2 * cfg.giou_cost
        - math.log(1.0 / cfg.smoothing - 1.0)
    )


def _slot_valid(targets) -> torch.Tensor:
    """[B, G] bool: target slot j is real iff j < num_boxes."""
    G = targets["class_labels"].shape[1]
    slots = torch.arange(G, device=targets["num_boxes"].device)
    return slots[None] < targets["num_boxes"][:, None]


def match(logits, pred_boxes, targets, cfg: EgtrConfig,
          class_cost: Optional[float] = None,
          smoothing: Optional[float] = None) -> MatchResult:
    """Build the cost matrix on the device and solve the assignment; no
    gradient flows through it (the reference matcher is @torch.no_grad)."""
    with torch.no_grad():
        cost = compute_cost_matrix(
            logits, pred_boxes, targets["class_labels"], targets["boxes"],
            _slot_valid(targets),
            class_cost=(cfg.ce_loss_coefficient if class_cost is None
                        else class_cost),
            bbox_cost=cfg.bbox_cost, giou_cost=cfg.giou_cost,
            smoothing=cfg.smoothing if smoothing is None else smoothing,
            focal_alpha=0.25)
        return hungarian_match(cost, targets["num_boxes"])


def detection_losses(logits, pred_boxes, targets, res: MatchResult,
                     num_boxes_total, cfg: EgtrConfig,
                     valid_img=None) -> Dict[str, torch.Tensor]:
    """labels (focal), boxes (L1 + GIoU), cardinality.

    Reference reductions: loss_ce = focal.mean(1).sum()/num_boxes * Q
    == elementwise_sum / num_boxes (egtr.py:648-659); box losses are sums
    over matched pairs / num_boxes (egtr.py:693-719).

    ``valid_img`` ([B] float, optional): per-image weight, 0 for the
    duplicated pad rows of a padded eval tail, so the loss over a padded
    batch equals the loss over its real rows. None = all ones.
    """
    B, Q, C = logits.shape
    v = (torch.ones((B,), dtype=logits.dtype, device=logits.device)
         if valid_img is None else valid_img)
    valid = _slot_valid(targets) & (v[:, None] > 0)                # [B,G]

    # --- classification (focal over one-hot with background dropped) ---
    matched = res.gt_index >= 0                                    # [B,Q]
    cls_of_q = torch.gather(targets["class_labels"].long(), 1,
                            res.gt_index.clamp(min=0))
    target_classes = torch.where(matched, cls_of_q,
                                 torch.full_like(cls_of_q, C))     # [B,Q]
    onehot = F.one_hot(target_classes, C + 1)[..., :-1].to(logits.dtype)
    focal = sigmoid_focal_loss_elementwise(
        logits, onehot, alpha=cfg.focal_alpha, gamma=2.0)
    loss_ce = (focal.sum(dim=(1, 2)) * v).sum() / num_boxes_total

    # --- boxes: pad slots carry query_index -1; clamp, then mask ---
    src_boxes = torch.gather(
        pred_boxes, 1,
        res.query_index.clamp(min=0)[..., None].expand(-1, -1, 4))  # [B,G,4]
    l1 = (src_boxes - targets["boxes"]).abs().sum(-1)               # [B,G]
    zero = torch.zeros((), dtype=l1.dtype, device=l1.device)
    loss_bbox = torch.where(valid, l1, zero).sum() / num_boxes_total

    giou = torch.diagonal(generalized_box_iou(
        box_cxcywh_to_xyxy(src_boxes), box_cxcywh_to_xyxy(targets["boxes"])),
        dim1=-2, dim2=-1)                                           # [B,G]
    loss_giou = torch.where(valid, 1.0 - giou, zero).sum() / num_boxes_total

    # --- cardinality (logging; quirk preserved: compares argmax to the
    #     LAST real class since there is no background logit,
    #     egtr.py:663-677) ---
    card_pred = (logits.argmax(-1) != C - 1).sum(1)
    card_abs = (card_pred.float() - targets["num_boxes"].float()).abs()
    card_err = (card_abs * v).sum() / v.sum().clamp(min=1.0)

    return {"loss_ce": loss_ce, "loss_bbox": loss_bbox,
            "loss_giou": loss_giou, "cardinality_error": card_err}


def uncertainty_loss(targets, res: MatchResult, valid_img=None
                     ) -> torch.Tensor:
    """No-grad diagnostic (egtr.py:679-689): mean over gt relation entries of
    sigmoid(cost_i) * sigmoid(cost_j). ``valid_img`` zeroes pad images."""
    with torch.no_grad():
        u = torch.sigmoid(res.matching_cost)                       # [B,G]
        rel_n = targets["rel"].sum(-1)                             # [B,G,G]
        pair_u = u[:, :, None] * u[:, None, :]
        if valid_img is not None:
            rel_n = rel_n * valid_img[:, None, None]
        total = (rel_n * pair_u).sum()
        count = rel_n.sum()
        return total / count.clamp(min=1.0)


def _permuted_rel_target(targets, res: MatchResult, Q: int) -> torch.Tensor:
    """Query-indexed dense relation target [B,Q,Q,R]: row q is the gt row
    matched to query q (zeros if unmatched). Equivalent to the reference's
    full_src/full_target permutation (egtr.py:754-781)."""
    B, G, _, R = targets["rel"].shape
    rel_pad = F.pad(targets["rel"], (0, 0, 0, 1, 0, 1))            # [B,G+1,G+1,R]
    idx = torch.where(res.gt_index >= 0, res.gt_index,
                      torch.full_like(res.gt_index, G))            # [B,Q]
    batch = torch.arange(B, device=idx.device)[:, None, None]
    return rel_pad[batch, idx[:, :, None], idx[:, None, :]]       # [B,Q,Q,R]


def relation_losses(pred_rel_logits, pred_conn_logits, targets,
                    res: MatchResult, cfg: EgtrConfig, train: bool,
                    generator: Optional[torch.Generator] = None,
                    valid_img=None) -> Dict[str, torch.Tensor]:
    """loss_rel + loss_connectivity (egtr.py:754-921).

    Training uses hard-negative sampling: per image, k = num_gt_rels *
    rel_sample_negatives largest-scoring negatives within the matched block,
    and likewise for non-matching pairs, as a fixed-size top-k with rank
    masking. Eval averages BCE.mean(-1) over all Q^2 pairs. ``generator``
    feeds the uniform (``rel_sample_*_largest=False``) sampling.
    """
    if cfg.rel_sample_approx_topk:
        raise NotImplementedError(
            "rel_sample_approx_topk (approximate top-k negative mining) is "
            "not ported yet")
    B, Q, _, R = pred_rel_logits.shape
    dev = pred_rel_logits.device
    v = (torch.ones((B,), dtype=torch.float32, device=dev)
         if valid_img is None else valid_img.float())
    nv = v.sum().clamp(min=1.0)
    nm_cost = nonmatching_cost(cfg)

    matched = res.gt_index >= 0                                     # [B,Q]
    cost_q = torch.where(
        matched,
        torch.gather(res.matching_cost, 1, res.gt_index.clamp(min=0)),
        torch.full((), nm_cost, dtype=res.matching_cost.dtype, device=dev))
    w = 1.0 - torch.sigmoid(cost_q)                                 # [B,Q]
    pair_w = w[:, :, None] * w[:, None, :]                          # [B,Q,Q]

    target_q = _permuted_rel_target(targets, res, Q)                # [B,Q,Q,R]

    # --- connectivity (always over all pairs; egtr.py:783-796) ---
    target_conn = (target_q.amax(-1, keepdim=True) > 0).to(
        pred_conn_logits.dtype)                                     # [B,Q,Q,1]
    conn_bce = bce_with_logits(pred_conn_logits, target_conn)
    loss_connectivity = (conn_bce.mean(dim=(1, 2, 3)) * v).sum() / nv

    # adaptive smoothing weight applied to positive targets
    smoothed_target = target_q * pair_w[..., None]

    if not train or (cfg.rel_sample_negatives is None
                     and cfg.rel_sample_nonmatching is None):
        per_img = bce_with_logits(pred_rel_logits, smoothed_target).mean(
            dim=(1, 2, 3))
        loss_rel = (per_img * v).sum() / nv
        return {"loss_rel": loss_rel, "loss_connectivity": loss_connectivity}

    # --- training: sampled entries ---
    pair_matched = matched[:, :, None] & matched[:, None, :]        # [B,Q,Q]
    true_mask = target_q == 1.0                                     # [B,Q,Q,R]
    n_true = true_mask.sum(dim=(1, 2, 3))                           # [B]

    bce_all = bce_with_logits(pred_rel_logits, smoothed_target)     # [B,Q,Q,R]
    sum_true = torch.where(true_mask, bce_all,
                           torch.zeros_like(bce_all)).sum(dim=(1, 2, 3))

    if generator is None and (not cfg.rel_sample_negatives_largest
                              or not cfg.rel_sample_nonmatching_largest):
        raise ValueError(
            "relation_losses: a generator is required when "
            "rel_sample_*_largest is False (uniform negative sampling)")

    flat_logits = pred_rel_logits.reshape(B, -1)
    neg_inf = torch.full_like(flat_logits, float("-inf"))

    def sampled_sum(cand_mask, k_per_rel, largest):
        """Sum of BCE(pred, 0) over k = min(k_per_rel * n_true, avail)
        candidates, chosen by largest pred (or uniformly)."""
        if k_per_rel is None:
            zeros = torch.zeros((B,), device=dev)
            return zeros, zeros
        avail = cand_mask.sum(dim=(1, 2, 3))
        # the fixed top-k size caps the sampled negatives at k_per_rel *
        # max_gt_rels per image (kept from the JAX package)
        K = min(int(k_per_rel * cfg.max_gt_rels), flat_logits.shape[1])
        k_eff = torch.minimum(k_per_rel * n_true, avail)            # [B]
        k_eff = torch.where(n_true == 0, torch.zeros_like(k_eff),
                            k_eff.clamp(max=K))
        cand = cand_mask.reshape(B, -1)
        if largest:
            score = torch.where(cand, flat_logits.detach(), neg_inf)
        else:
            u = torch.rand(flat_logits.shape, device=dev, generator=generator)
            score = torch.where(cand, u, neg_inf)
        top_vals, top_idx = torch.topk(score, K, dim=1)             # [B,K]
        sel_logits = torch.gather(flat_logits, 1, top_idx)
        rank_ok = ((torch.arange(K, device=dev)[None] < k_eff[:, None])
                   & torch.isfinite(top_vals))
        # BCE with target 0 == softplus(logit)
        sp = sel_logits.clamp(min=0.0) + torch.log1p(
            torch.exp(-sel_logits.abs()))
        return torch.where(rank_ok, sp, torch.zeros_like(sp)).sum(dim=1), k_eff

    false_mask = pair_matched[..., None] & (target_q != 1.0)
    nonm_mask = (~pair_matched)[..., None].expand(target_q.shape)
    sum_neg, k_neg = sampled_sum(false_mask, cfg.rel_sample_negatives,
                                 cfg.rel_sample_negatives_largest)
    sum_nonm, k_nonm = sampled_sum(nonm_mask, cfg.rel_sample_nonmatching,
                                   cfg.rel_sample_nonmatching_largest)

    total = ((sum_true + sum_neg + sum_nonm) * v).sum()
    count = ((n_true + k_neg + k_nonm) * v).sum()
    loss_rel = total / count.clamp(min=1)
    # how often the fixed-K cap binds (images with > max_gt_rels true
    # relation entries), as a streamed metric
    capped = ((n_true > cfg.max_gt_rels) * v).sum() / nv
    return {"loss_rel": loss_rel, "loss_connectivity": loss_connectivity,
            "rel_sample_capped_frac": capped}


def _aux_losses(outputs, targets, cfg, num_boxes_total, losses, weight,
                smoothing, valid_img) -> None:
    """Per-layer auxiliary detection losses with their own matching."""
    if not cfg.auxiliary_loss:
        return
    for i in range(cfg.decoder_layers - 1):
        aux_logits = outputs["all_logits"][:, i]
        aux_boxes = outputs["all_pred_boxes"][:, i]
        aux_res = match(aux_logits, aux_boxes, targets, cfg,
                        smoothing=smoothing)
        aux = detection_losses(aux_logits, aux_boxes, targets, aux_res,
                               num_boxes_total, cfg, valid_img=valid_img)
        for k in ("loss_ce", "loss_bbox", "loss_giou"):
            losses[f"{k}_{i}"] = aux[k]
            weight[f"{k}_{i}"] = weight[k]
        losses[f"cardinality_error_{i}"] = aux["cardinality_error"]


def _enc_losses(outputs, targets, cfg: EgtrConfig, num_boxes_total,
                losses: dict, weight: dict,
                smoothing: Optional[float] = None, valid_img=None) -> None:
    """Two-stage proposal losses with binarized class labels
    (egtr.py:1019-1033 / deformable_detr.py:2848-2859)."""
    if not cfg.two_stage or outputs.get("enc_outputs_class") is None:
        return
    enc_logits = outputs["enc_outputs_class"]
    enc_boxes = torch.sigmoid(outputs["enc_outputs_coord_logits"])
    bin_targets = dict(targets)
    bin_targets["class_labels"] = torch.zeros_like(targets["class_labels"])
    res = match(enc_logits, enc_boxes, bin_targets, cfg, smoothing=smoothing)
    enc = detection_losses(enc_logits, enc_boxes, bin_targets, res,
                           num_boxes_total, cfg, valid_img=valid_img)
    for k in ("loss_ce", "loss_bbox", "loss_giou"):
        losses[f"{k}_enc"] = enc[k]
        weight[f"{k}_enc"] = weight[k]
    losses["cardinality_error_enc"] = enc["cardinality_error"]


def _num_boxes_total(targets, v) -> torch.Tensor:
    num_boxes = targets["num_boxes"].float()
    if v is not None:
        num_boxes = num_boxes * v
    return num_boxes.sum().clamp(min=1.0)


def sgg_criterion(outputs, targets, cfg: EgtrConfig, train: bool,
                  generator: Optional[torch.Generator] = None, valid=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full EGTR loss (egtr.py:421-505 + SceneGraphGenerationLoss.forward).

    ``valid`` ([B] bool, optional): per-image mask for padded eval tails;
    masked losses equal the losses over the real rows only.
    """
    logits = outputs["logits"]
    pred_boxes = outputs["pred_boxes"]
    v = None if valid is None else valid.float()
    num_boxes_total = _num_boxes_total(targets, v)

    res = match(logits, pred_boxes, targets, cfg)
    losses = detection_losses(
        logits, pred_boxes, targets, res, num_boxes_total, cfg, valid_img=v)
    losses.update(relation_losses(
        outputs["pred_rel_logits"], outputs["pred_connectivity_logits"],
        targets, res, cfg, train, generator, valid_img=v))
    losses["uncertainty"] = uncertainty_loss(targets, res, valid_img=v)

    weight = {
        "loss_ce": cfg.ce_loss_coefficient,
        "loss_bbox": cfg.bbox_loss_coefficient,
        "loss_giou": cfg.giou_loss_coefficient,
        "loss_rel": cfg.rel_loss_coefficient,
        "loss_connectivity": cfg.connectivity_loss_coefficient,
    }
    _aux_losses(outputs, targets, cfg, num_boxes_total, losses, weight,
                None, v)
    _enc_losses(outputs, targets, cfg, num_boxes_total, losses, weight,
                valid_img=v)
    total = sum(losses[k] * w for k, w in weight.items() if k in losses)
    return total, losses


def detection_criterion(outputs, targets, cfg: EgtrConfig, valid=None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Detector pretraining loss (DeformableDetrForObjectDetection,
    deformable_detr.py:2562-2618): labels/boxes/cardinality with matcher
    class_cost = ce_loss_coefficient, no smoothing; aux per-layer re-match.
    ``valid``: per-image mask for padded eval tails (see sgg_criterion)."""
    logits = outputs["logits"]
    pred_boxes = outputs["pred_boxes"]
    v = None if valid is None else valid.float()
    num_boxes_total = _num_boxes_total(targets, v)

    res = match(logits, pred_boxes, targets, cfg, smoothing=0.0)
    losses = detection_losses(
        logits, pred_boxes, targets, res, num_boxes_total, cfg, valid_img=v)

    weight = {
        "loss_ce": cfg.ce_loss_coefficient,
        "loss_bbox": cfg.bbox_loss_coefficient,
        "loss_giou": cfg.giou_loss_coefficient,
    }
    _aux_losses(outputs, targets, cfg, num_boxes_total, losses, weight,
                0.0, v)
    _enc_losses(outputs, targets, cfg, num_boxes_total, losses, weight,
                smoothing=0.0, valid_img=v)
    total = sum(losses[k] * w for k, w in weight.items() if k in losses)
    return total, losses
