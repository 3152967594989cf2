"""Open Images V6 relation evaluation on the host (numpy): the port's own
copy of ``egtr_tpu/evaluation/oi_eval.py``.

Re-implementation of the reference's OI scoring pipeline
(lib/evaluation/oi_eval.py + ap_eval_rel.py, PySGG lineage):
- per-image micro Recall@K over top-100 (subject, predicate, object)
  triples built from all Q^2 pairs with the top-2 predicates per pair,
- per-predicate VOC-style AP with rel (min of subject/object IoU) and phr
  (union-box IoU) conventions, weighted by class frequency,
- final score = 0.4 * w_rel_mAP + 0.4 * w_phr_mAP + 0.2 * microR@50
  (oi_eval.py:287-293),
- faux-COCO detection mAP via :mod:`egtr_tpu_torch.evaluation.coco_map`, with
  the reference's +1-pixel box widening.

The recall's triplet matching runs in the native kernel
(``sg_eval._compute_pred_matches``); a library that fails to build raises.
The numpy loop ``sg_eval._compute_pred_matches_plain`` is its plain version,
which the evaluator never takes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from . import sg_eval
from .coco_map import CocoMAP


def _top_inds_desc(scores: np.ndarray, k: int) -> np.ndarray:
    """Top-``k`` indices of a 2-D array in descending score order — the
    partial-top-k equivalent of ``argsort_desc(scores)[:k]``
    (lib/pytorch_misc.py:27-34) that avoids sorting the full P x prd_k
    product tensor. Ties break by flat index (stable), matching numpy's
    behavior on the fully-sorted path for distinct scores."""
    flat = scores.ravel()
    if flat.size <= k:
        top = np.argsort(-flat, kind="stable")
    else:
        part = np.argpartition(-flat, k - 1)[:k]
        # sort the k survivors by (-score, flat index) for a stable order
        part = part[np.lexsort((part, -flat[part]))]
        top = part
    return np.column_stack(np.unravel_index(top, scores.shape))


def boxes_union(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    return np.stack([
        np.minimum(b1[:, 0], b2[:, 0]), np.minimum(b1[:, 1], b2[:, 1]),
        np.maximum(b1[:, 2], b2[:, 2]), np.maximum(b1[:, 3], b2[:, 3])], 1)


def _iou_inter_plus1(box1: np.ndarray, box2: np.ndarray) -> np.ndarray:
    """AP-eval IoU quirk (ap_eval_rel.py:41-66): the intersection uses the
    +1-pixel convention but the areas do not. Reproduced verbatim."""
    lt_x = np.maximum(box1[:, None, 0], box2[None, :, 0])
    lt_y = np.maximum(box1[:, None, 1], box2[None, :, 1])
    rb_x = np.minimum(box1[:, None, 2], box2[None, :, 2])
    rb_y = np.minimum(box1[:, None, 3], box2[None, :, 3])
    iw = (rb_x - lt_x + 1).clip(0)
    ih = (rb_y - lt_y + 1).clip(0)
    inter = iw * ih
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return inter / (area1[:, None] + area2[None, :] - inter)


def get_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """VOC-style AP (ap_eval_rel.py:168-186)."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def ap_eval(image_ids: List, dets: Dict, gts: Dict, npos: int,
            rel_or_phr: bool = True, ovthresh: float = 0.5):
    """Per-predicate AP (ap_eval_rel.py:168-265)."""
    confidence = dets["confidence"]
    sorted_ind = np.argsort(-confidence)
    BB_s = dets["BB_s"][sorted_ind]
    BB_o = dets["BB_o"][sorted_ind]
    BB_r = dets["BB_r"][sorted_ind]
    LBL_s = dets["LBL_s"][sorted_ind]
    LBL_o = dets["LBL_o"][sorted_ind]
    image_ids = [image_ids[x] for x in sorted_ind]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    visited = {k: [False] * v["gt_num"] for k, v in gts.items()}
    for d in range(nd):
        R = gts[image_ids[d]]
        vis = visited[image_ids[d]]
        ovmax, jmax = -np.inf, -1
        if R["gt_boxes_sbj"].size > 0:
            valid = np.logical_and(R["gt_labels_sbj"] == LBL_s[d],
                                   R["gt_labels_obj"] == LBL_o[d])
            if valid.any():
                if rel_or_phr:
                    ov_s = _iou_inter_plus1(BB_s[d][None].astype(np.float32),
                                            R["gt_boxes_sbj"].astype(np.float32))[0]
                    ov_o = _iou_inter_plus1(BB_o[d][None].astype(np.float32),
                                            R["gt_boxes_obj"].astype(np.float32))[0]
                    overlaps = np.minimum(ov_s, ov_o)
                else:
                    overlaps = _iou_inter_plus1(
                        BB_r[d][None].astype(np.float32),
                        R["gt_boxes_rel"].astype(np.float32))[0]
                overlaps = overlaps * valid
                ovmax = overlaps.max()
                jmax = int(overlaps.argmax())
            else:
                ovmax, jmax = 0.0, -1
        if ovmax > ovthresh:
            if not vis[jmax]:
                tp[d] = 1.0
                vis[jmax] = True
            else:
                fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / (float(npos) + 1e-12)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, get_ap(rec, prec)


def prepare_mAP_dets(topk_dets: List[dict], cls_num: int):
    """Group detections/gts per predicate class (ap_eval_rel.py:68-146)."""
    cls_image_ids = [[] for _ in range(cls_num)]
    cls_dets = [dict(confidence=np.empty(0), BB_s=np.empty((0, 4)),
                     BB_o=np.empty((0, 4)), BB_r=np.empty((0, 4)),
                     LBL_s=np.empty(0), LBL_o=np.empty(0))
                for _ in range(cls_num)]
    cls_gts = [{} for _ in range(cls_num)]
    npos = [0] * cls_num
    for dets in topk_dets:
        image_id = dets["image"]
        rel_boxes = boxes_union(dets["det_boxes_s_top"],
                                dets["det_boxes_o_top"]) \
            if len(dets["det_boxes_s_top"]) else np.empty((0, 4))
        gt_boxes_rel = boxes_union(dets["gt_boxes_sbj"],
                                   dets["gt_boxes_obj"]) \
            if len(dets["gt_boxes_sbj"]) else np.empty((0, 4))
        prd = dets["det_labels_p_top"]
        for c in range(cls_num):
            inds = np.where(prd == c)[0]
            if len(inds):
                d = cls_dets[c]
                d["confidence"] = np.concatenate(
                    [d["confidence"], dets["det_scores_top"][inds]])
                d["BB_s"] = np.concatenate(
                    [d["BB_s"], dets["det_boxes_s_top"][inds]], 0)
                d["BB_o"] = np.concatenate(
                    [d["BB_o"], dets["det_boxes_o_top"][inds]], 0)
                d["BB_r"] = np.concatenate([d["BB_r"], rel_boxes[inds]], 0)
                d["LBL_s"] = np.concatenate(
                    [d["LBL_s"], dets["det_labels_s_top"][inds]])
                d["LBL_o"] = np.concatenate(
                    [d["LBL_o"], dets["det_labels_o_top"][inds]])
                cls_image_ids[c] += [image_id] * len(inds)
            g_inds = np.where(dets["gt_labels_prd"] == c)[0]
            n = len(g_inds)
            npos[c] += n
            cls_gts[c][image_id] = dict(
                gt_boxes_sbj=dets["gt_boxes_sbj"][g_inds],
                gt_boxes_obj=dets["gt_boxes_obj"][g_inds],
                gt_boxes_rel=gt_boxes_rel[g_inds],
                gt_labels_sbj=dets["gt_labels_sbj"][g_inds],
                gt_labels_obj=dets["gt_labels_obj"][g_inds],
                gt_num=n)
    return cls_image_ids, cls_dets, cls_gts, npos


class OIEvaluator:
    """Accumulates per-image entries; final score per oi_eval.py:287-293."""

    def __init__(self, rel_categories: Sequence[str],
                 ind_to_classes: Sequence[str], prd_k: int = 2,
                 topk: int = 100):
        self.rel_categories = list(rel_categories)
        self.ind_to_classes = list(ind_to_classes)
        self.prd_k = prd_k
        self.topk = topk
        self.results: List[dict] = []

    def __call__(self, gt_entry: dict, pred_entry: dict) -> None:
        """Accumulate one image, reducing the Q^2-pair predictions to the
        per-image top-``topk`` triples IMMEDIATELY (the reference stores
        raw Q^2 x prd_k score tensors per image and sorts them all at
        aggregate time, oi_eval.py:77-293 — ~10 MB/image at Q=200, which
        does not scale to the 125k-image OI test split). The reduction
        here is exactly the reference's selection (top prd_k predicates
        per pair, then global top-k of s*o*p products, then the >1e-5
        score cut), computed with partial top-k instead of full sorts."""
        gt_boxes = np.asarray(gt_entry["gt_boxes"], float)
        gt_class = np.asarray(gt_entry["gt_classes"])
        rels = np.asarray(gt_entry["gt_relations"]).reshape(-1, 3)
        r = dict(
            gt_boxes=gt_boxes, gt_class=gt_class,
            gt_sbj_boxes=gt_boxes[rels[:, 0]] if len(rels) else np.empty((0, 4)),
            gt_obj_boxes=gt_boxes[rels[:, 1]] if len(rels) else np.empty((0, 4)),
            gt_sbj_labels=gt_class[rels[:, 0]] if len(rels) else np.empty(0),
            gt_obj_labels=gt_class[rels[:, 1]] if len(rels) else np.empty(0),
            gt_prd_labels=rels[:, 2] if len(rels) else np.empty(0),
        )
        pb = np.asarray(pred_entry["pred_boxes"], float)
        pc = np.asarray(pred_entry["pred_classes"])
        ps = np.asarray(pred_entry["obj_scores"], float)
        so = np.asarray(pred_entry["sbj_obj_inds"]).reshape(-1, 2)
        scores_prd = np.asarray(pred_entry["pred_scores"], float)

        prd_k = min(self.prd_k, scores_prd.shape[1])
        # row-wise top prd_k predicates: argpartition + in-k sort instead
        # of a full argsort of every row
        part = np.argpartition(-scores_prd, prd_k - 1, axis=1)[:, :prd_k]
        part_scores = np.take_along_axis(scores_prd, part, axis=1)
        order = np.argsort(-part_scores, axis=1, kind="stable")
        labels_prd_sorted = np.take_along_axis(part, order, axis=1)
        scores_prd_sorted = np.take_along_axis(part_scores, order, axis=1)

        scores_so = ps[so[:, 0]] * ps[so[:, 1]]
        scores_spo = scores_so[:, None] * scores_prd_sorted  # [P, prd_k]
        inds = _top_inds_desc(scores_spo, self.topk)
        det_scores_top = scores_spo[inds[:, 0], inds[:, 1]]
        cand = det_scores_top > 0.00001
        inds = inds[cand]
        det_scores_top = det_scores_top[cand]
        s_idx, o_idx = so[inds[:, 0], 0], so[inds[:, 0], 1]
        r.update(
            pred_boxes=pb, pred_class=pc, pred_cls_scores=ps,
            det_boxes_s_top=pb[s_idx], det_boxes_o_top=pb[o_idx],
            det_labels_s_top=pc[s_idx],
            det_labels_p_top=labels_prd_sorted[inds[:, 0], inds[:, 1]],
            det_labels_o_top=pc[o_idx],
            det_scores_top=det_scores_top,
        )
        self.results.append(r)

    # --- multi-host merge (reference util/misc.py:93-135 analog) ---
    def state(self) -> List[dict]:
        return self.results

    def merge_state(self, other: List[dict]) -> None:
        self.results.extend(other)

    def clear(self) -> None:
        self.results = []

    def num_images(self) -> int:
        return len(self.results)

    def _eval_rel(self) -> Dict[str, float]:
        all_gt_cnt = 0
        recalls = {k: 0 for k in (1, 5, 10, 20, 50, 100)}
        topk_dets = []
        for im_i, res in enumerate(self.results):
            # the top-k triple selection already happened in __call__;
            # here we only re-assemble the per-image det record
            boxes_so_top = np.hstack([res["det_boxes_s_top"],
                                      res["det_boxes_o_top"]])
            labels_spo_top = np.stack([res["det_labels_s_top"],
                                       res["det_labels_p_top"],
                                       res["det_labels_o_top"]], 1) \
                if len(res["det_labels_p_top"]) else np.empty((0, 3))
            det_scores_top = res["det_scores_top"]

            topk_dets.append(dict(
                image=im_i,
                det_boxes_s_top=res["det_boxes_s_top"],
                det_boxes_o_top=res["det_boxes_o_top"],
                det_labels_s_top=res["det_labels_s_top"],
                det_labels_p_top=res["det_labels_p_top"],
                det_labels_o_top=res["det_labels_o_top"],
                det_scores_top=det_scores_top,
                gt_boxes_sbj=res["gt_sbj_boxes"],
                gt_boxes_obj=res["gt_obj_boxes"],
                gt_labels_sbj=res["gt_sbj_labels"],
                gt_labels_obj=res["gt_obj_labels"],
                gt_labels_prd=res["gt_prd_labels"]))

            gt_boxes_so = np.hstack([res["gt_sbj_boxes"], res["gt_obj_boxes"]])
            gt_labels_spo = np.stack([res["gt_sbj_labels"],
                                      res["gt_prd_labels"],
                                      res["gt_obj_labels"]], 1) \
                if len(res["gt_prd_labels"]) else np.empty((0, 3))
            pred_to_gt = sg_eval._compute_pred_matches(
                gt_labels_spo, labels_spo_top, gt_boxes_so, boxes_so_top,
                0.5, phrdet=False)
            all_gt_cnt += gt_labels_spo.shape[0]
            for k in recalls:
                match: np.ndarray = np.array([], np.int64)
                for m in pred_to_gt[:k]:
                    match = np.union1d(match, m)
                recalls[k] += len(match)

        for k in recalls:
            recalls[k] = float(recalls[k]) / (float(all_gt_cnt) + 1e-12)

        cls_num = len(self.rel_categories)
        cls_image_ids, cls_dets, cls_gts, npos = prepare_mAP_dets(
            topk_dets, cls_num)
        all_npos = sum(npos)
        out = {}
        for name, rel_or_phr in (("rel", True), ("phr", False)):
            w_map = 0.0
            m_ap = 0.0
            for c in range(cls_num):
                _, _, ap = ap_eval(cls_image_ids[c], cls_dets[c], cls_gts[c],
                                   npos[c], rel_or_phr)
                w_map += ap * float(npos[c]) / float(max(all_npos, 1))
                m_ap += ap
            out[f"w_{name}_mAP"] = w_map
            out[f"{name}_mAP"] = m_ap / cls_num
        out["microR@50"] = recalls[50]
        out["score"] = (out["w_rel_mAP"] * 0.4 + out["w_phr_mAP"] * 0.4
                        + recalls[50] * 0.2)
        return out

    def _eval_detection(self) -> Dict[str, float]:
        cats = list(range(len(self.ind_to_classes)))
        m = CocoMAP(cats)

        def widen(b):
            # the reference converts xyxy -> faux-COCO xywh with
            # w = x2-x1+1 (lib/evaluation/oi_eval.py:26-27,308-313), so
            # COCOeval sees boxes extended +1 px past the max corner —
            # for BOTH gt and detections. Match that convention exactly.
            b = np.asarray(b, np.float64).reshape(-1, 4).copy()
            b[:, 2:] += 1.0
            return b

        for i, res in enumerate(self.results):
            gt_w = widen(res["gt_boxes"])
            m.add_image(
                i,
                gt=dict(boxes=gt_w, labels=res["gt_class"],
                        area=((gt_w[:, 3] - gt_w[:, 1])
                              * (gt_w[:, 2] - gt_w[:, 0]))),
                det=dict(boxes=widen(res["pred_boxes"]),
                         labels=res["pred_class"],
                         scores=res["pred_cls_scores"]))
        stats = m.accumulate()
        return {f"bbox/{k}": v for k, v in stats.items()}

    def aggregate_metrics(self) -> Dict[str, float]:
        out = self._eval_detection()
        out.update(self._eval_rel())
        return out
