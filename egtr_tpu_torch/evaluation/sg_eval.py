"""Scene-graph Recall@K evaluation on the host: the port's own copy of
``egtr_tpu/evaluation/sg_eval.py``. The triplet matching runs in the native
C++ kernel (``egtr_tpu_torch/native``) where the JAX package's does; the
numpy loop, ``_compute_pred_matches_plain``, is its plain version, which
the evaluator never takes. Unlike the JAX package, a native library that fails
to build raises.

Re-implementation of the reference evaluator semantics
(lib/evaluation/sg_eval.py:19-372, itself from KERN/MotifNet):
- sgdet mode, graph-constrained (single) and unconstrained (multiple) paths,
- triplet match = exact (sub_cls, predicate, obj_cls) equality AND both boxes
  IoU >= 0.5 under the +1-pixel IoU convention of the Cython
  ``bbox_overlaps`` (lib/fpn/box_intersections_cpu/bbox.pyx:15-60),
- per-image recall = |union of matched GT over top-k preds| / #GT,
  appended per image and averaged in ``aggregate``,
- mean recall over per-predicate evaluators with NaN rows skipped in the
  numerator but the denominator fixed at #predicates
  (sg_eval.py:343-352).

The evaluator records the image id of each entry, so that ``merge_state``
can refuse the state of another process that evaluated the same image.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def bbox_overlaps_plus1(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU with the +1-pixel convention (bbox.pyx:15-60)."""
    b1 = boxes1.astype(np.float64)
    b2 = boxes2.astype(np.float64)
    area2 = (b2[:, 2] - b2[:, 0] + 1) * (b2[:, 3] - b2[:, 1] + 1)
    area1 = (b1[:, 2] - b1[:, 0] + 1) * (b1[:, 3] - b1[:, 1] + 1)
    iw = (np.minimum(b1[:, None, 2], b2[None, :, 2])
          - np.maximum(b1[:, None, 0], b2[None, :, 0]) + 1).clip(0)
    ih = (np.minimum(b1[:, None, 3], b2[None, :, 3])
          - np.maximum(b1[:, None, 1], b2[None, :, 1]) + 1).clip(0)
    inter = iw * ih
    union = area1[:, None] + area2[None, :] - inter
    return inter / union


def intersect_2d(x1: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """[m1,n] x [m2,n] -> [m1,m2] rows-equal matrix (lib/pytorch_misc.py:10)."""
    if x1.shape[1] != x2.shape[1]:
        raise ValueError("Input arrays must have same #columns")
    return (x1[:, None] == x2[None]).all(-1)


def argsort_desc(scores: np.ndarray) -> np.ndarray:
    """Indices sorting a tensor descending (lib/pytorch_misc.py:27-34)."""
    return np.column_stack(
        np.unravel_index(np.argsort(-scores.ravel()), scores.shape))


def _triplet(predicates, relations, classes, boxes):
    sub_ob = classes[relations[:, :2]]
    triplets = np.column_stack((sub_ob[:, 0], predicates, sub_ob[:, 1]))
    triplet_boxes = np.column_stack(
        (boxes[relations[:, 0]], boxes[relations[:, 1]]))
    return triplets, triplet_boxes


def _compute_pred_matches(gt_triplets, pred_triplets, gt_boxes, pred_boxes,
                          iou_thresh: float, phrdet: bool) -> List[List[int]]:
    """For each predicted triplet, the gt triplets it matches, from the
    native kernel."""
    from ..native import triplet_matches

    dense = triplet_matches(gt_triplets, gt_boxes, pred_triplets, pred_boxes,
                            iou_thresh, phrdet)
    pred_to_gt: List[List[int]] = [[] for _ in range(pred_boxes.shape[0])]
    for g, p in zip(*np.nonzero(dense)):
        pred_to_gt[p].append(int(g))
    return pred_to_gt


def _compute_pred_matches_plain(gt_triplets, pred_triplets, gt_boxes,
                                pred_boxes, iou_thresh: float,
                                phrdet: bool) -> List[List[int]]:
    """``_compute_pred_matches`` by a numpy loop over the gt triplets."""
    pred_to_gt: List[List[int]] = [[] for _ in range(pred_boxes.shape[0])]
    keeps = intersect_2d(gt_triplets, pred_triplets)
    gt_has_match = keeps.any(1)
    for gt_ind, gt_box, keep_inds in zip(
            np.where(gt_has_match)[0], gt_boxes[gt_has_match],
            keeps[gt_has_match]):
        boxes = pred_boxes[keep_inds]
        if phrdet:
            gt_u = gt_box.reshape(2, 4)
            gt_u = np.concatenate((gt_u.min(0)[:2], gt_u.max(0)[2:]), 0)
            bu = boxes.reshape(-1, 2, 4)
            bu = np.concatenate((bu.min(1)[:, :2], bu.max(1)[:, 2:]), 1)
            inds = bbox_overlaps_plus1(gt_u[None], bu)[0] >= iou_thresh
        else:
            sub_iou = bbox_overlaps_plus1(gt_box[None, :4], boxes[:, :4])[0]
            obj_iou = bbox_overlaps_plus1(gt_box[None, 4:], boxes[:, 4:])[0]
            inds = (sub_iou >= iou_thresh) & (obj_iou >= iou_thresh)
        for i in np.where(keep_inds)[0][inds]:
            pred_to_gt[i].append(int(gt_ind))
    return pred_to_gt


def evaluate_recall(gt_rels, gt_boxes, gt_classes, pred_rels, pred_boxes,
                    pred_classes, iou_thresh=0.5, phrdet=False):
    """pred_to_gt matching (sg_eval.py:167-243); pred_rels assumed sorted."""
    if pred_rels.size == 0:
        return [[]]
    gt_triplets, gt_triplet_boxes = _triplet(
        gt_rels[:, 2], gt_rels[:, :2], gt_classes, gt_boxes)
    pred_triplets, pred_triplet_boxes = _triplet(
        pred_rels[:, 2], pred_rels[:, :2], pred_classes, pred_boxes)
    return _compute_pred_matches(
        gt_triplets, pred_triplets, gt_triplet_boxes, pred_triplet_boxes,
        iou_thresh, phrdet)


def check_disjoint(mine: Sequence, theirs: Sequence, what: str) -> None:
    """Raise if two evaluators' states share an image id: each image must be
    evaluated by one process only, or its recall would count twice."""
    common = set(mine) & set(theirs)
    if common:
        raise ValueError(f"{what}: the merged state repeats image ids "
                         f"{sorted(common)[:10]}")


class SceneGraphEvaluator:
    """sgdet R@K accumulator (BasicSceneGraphEvaluator, sg_eval.py:19-72)."""

    def __init__(self, multiple_preds: bool = False,
                 ks: Sequence[int] = (20, 50, 100)):
        self.multiple_preds = multiple_preds
        self.recalls: Dict[int, List[float]] = {k: [] for k in ks}
        self.image_ids: List = []

    def evaluate_entry(self, gt_entry: dict, pred_entry: dict,
                       iou_thresh: float = 0.5,
                       image_id: Optional[int] = None) -> None:
        gt_rels = np.asarray(gt_entry["gt_relations"])
        gt_boxes = np.asarray(gt_entry["gt_boxes"], float)
        gt_classes = np.asarray(gt_entry["gt_classes"])

        pred_rel_inds = np.asarray(pred_entry["pred_rel_inds"])
        rel_scores = np.asarray(pred_entry["rel_scores"])

        if self.multiple_preds:
            pred_rels = pred_rel_inds            # [k, 3] (s, o, p)
        else:
            pred_rels = np.column_stack(
                (pred_rel_inds, rel_scores.argmax(1)))  # graph constraint
        pred_to_gt = evaluate_recall(
            gt_rels, gt_boxes, gt_classes, pred_rels,
            np.asarray(pred_entry["pred_boxes"], float),
            np.asarray(pred_entry["pred_classes"]), iou_thresh=iou_thresh)

        for k in self.recalls:
            match: np.ndarray = np.array([], dtype=np.int64)
            for m in pred_to_gt[:k]:
                match = np.union1d(match, m)
            self.recalls[k].append(float(len(match)) / float(gt_rels.shape[0]))
        if image_id is not None:
            self.image_ids.append(image_id)

    def aggregate(self) -> Dict[str, float]:
        return {f"R@{k}": float(np.mean(v)) if v else float("nan")
                for k, v in self.recalls.items()}

    def state(self) -> dict:
        return {"recalls": self.recalls, "image_ids": self.image_ids}

    def merge_state(self, other: dict) -> None:
        """Fold another process's per-image recalls into this accumulator;
        raises where both evaluated one image."""
        check_disjoint(self.image_ids, other["image_ids"],
                       "SceneGraphEvaluator.merge_state")
        for k, v in other["recalls"].items():
            self.recalls.setdefault(k, []).extend(v)
        self.image_ids.extend(other["image_ids"])


def evaluate_mean_recall(per_predicate: Dict[str, Dict[str, float]],
                         num_predicates: int) -> Dict[str, float]:
    """mR@K from per-predicate evaluator results (sg_eval.py:331-372):
    NaN rows are skipped in the sum, the denominator stays #predicates."""
    out = {}
    for k in (20, 50, 100):
        total = 0.0
        for name, res in per_predicate.items():
            v = res.get(f"R@{k}", float("nan"))
            if np.isnan(res.get("R@100", float("nan"))):
                continue
            total += v
        out[f"mR@{k}"] = total / num_predicates
    return out


def evaluate_per_predicate(gt_entry, entry, evaluators, rel_categories,
                           image_id: Optional[int] = None):
    """Feed one image into the per-predicate evaluator dict: each
    predicate present in the gt is evaluated against the gt restricted
    to that predicate (reference calculate_mR_from_evaluator_list,
    lib/evaluation/sg_eval.py:331-372)."""
    gt_rels = gt_entry["gt_relations"]
    for pred_id, name in enumerate(rel_categories):
        mask = gt_rels[:, 2] == pred_id
        if not mask.any():
            continue
        sub_gt = dict(gt_entry)
        sub_gt["gt_relations"] = gt_rels[mask]
        evaluators[name].evaluate_entry(sub_gt, entry, image_id=image_id)
