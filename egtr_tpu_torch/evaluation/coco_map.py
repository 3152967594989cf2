"""Self-contained COCO-protocol bbox mAP evaluator (numpy): the port's own
copy of ``egtr_tpu/evaluation/coco_map.py``.

It implements the COCOeval bbox protocol: 10 IoU thresholds 0.50:0.95,
101-point interpolated precision, area ranges (all/small/medium/large),
maxDets (1/10/100), greedy per-image-per-category matching with ignore
handling. Replaces the reference's ``CocoEvaluator`` dependency
(lib/evaluation/coco_eval.py).

Ground truth: per image, dict(boxes=[n,4] xyxy, labels=[n], iscrowd=[n]
optional, area=[n] optional). Detections: dict(boxes=[m,4] xyxy,
scores=[m], labels=[m]).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from .sg_eval import check_disjoint

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_xyxy(d: np.ndarray, g: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """COCO IoU (no +1 convention). For crowd gt, union = det area."""
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    ix0 = np.maximum(d[:, None, 0], g[None, :, 0])
    iy0 = np.maximum(d[:, None, 1], g[None, :, 1])
    ix1 = np.minimum(d[:, None, 2], g[None, :, 2])
    iy1 = np.minimum(d[:, None, 3], g[None, :, 3])
    inter = (ix1 - ix0).clip(0) * (iy1 - iy0).clip(0)
    area_d = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :].astype(bool), area_d[:, None], union)
    return inter / np.maximum(union, np.finfo(np.float64).eps)


class CocoMAP:
    def __init__(self, category_ids: Sequence[int]):
        self.cat_ids = list(category_ids)
        # per (image, cat): lists
        self._gts = defaultdict(list)    # (img, cat) -> list of gt dict
        self._dts = defaultdict(list)    # (img, cat) -> list of det dict
        self._img_ids: List = []

    def add_image(self, img_id, gt: Dict, det: Dict) -> None:
        self._img_ids.append(img_id)
        g_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        g_labels = np.asarray(gt["labels"]).reshape(-1)
        g_crowd = np.asarray(gt.get("iscrowd",
                                    np.zeros(len(g_labels)))).reshape(-1)
        g_area = gt.get("area")
        if g_area is None:
            g_area = ((g_boxes[:, 2] - g_boxes[:, 0])
                      * (g_boxes[:, 3] - g_boxes[:, 1]))
        for i in range(len(g_labels)):
            self._gts[(img_id, int(g_labels[i]))].append(
                dict(box=g_boxes[i], area=float(g_area[i]),
                     iscrowd=int(g_crowd[i])))
        d_boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        d_scores = np.asarray(det["scores"], np.float64).reshape(-1)
        d_labels = np.asarray(det["labels"]).reshape(-1)
        for i in range(len(d_labels)):
            self._dts[(img_id, int(d_labels[i]))].append(
                dict(box=d_boxes[i], score=float(d_scores[i])))

    # --- merge API (the reference syncs per-rank COCO predictions before
    #     summarizing: lib/evaluation/coco_eval.py:59-64,178-207) ---
    def state(self) -> Dict:
        return {"gts": dict(self._gts), "dts": dict(self._dts),
                "img_ids": list(self._img_ids)}

    def merge_state(self, other: Dict) -> None:
        """Fold another evaluator's ``state()`` into this one. Each image
        must come from one evaluator: a repeated image id raises (its
        ground truth and detections would count twice)."""
        check_disjoint(self._img_ids, other["img_ids"],
                       "CocoMAP.merge_state")
        for k, v in other["gts"].items():
            self._gts[k].extend(v)
        for k, v in other["dts"].items():
            self._dts[k].extend(v)
        self._img_ids.extend(other["img_ids"])

    def _evaluate_img(self, img_id, cat, area_rng, max_det):
        gts = self._gts.get((img_id, cat), [])
        dts = sorted(self._dts.get((img_id, cat), []),
                     key=lambda d: -d["score"])[:max_det]
        if not gts and not dts:
            return None
        g_ignore = np.array(
            [g["iscrowd"] or g["area"] < area_rng[0] or g["area"] > area_rng[1]
             for g in gts], bool)
        # sort gts: non-ignored first (stable)
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]

        G, D = len(gts), len(dts)
        ious = _iou_xyxy(
            np.array([d["box"] for d in dts]).reshape(-1, 4),
            np.array([g["box"] for g in gts]).reshape(-1, 4),
            np.array([g["iscrowd"] for g in gts]).reshape(-1))

        T = len(IOU_THRS)
        dtm = np.zeros((T, D), np.int64) - 1
        gtm = np.zeros((T, G), np.int64) - 1
        for ti, t in enumerate(IOU_THRS):
            for di in range(D):
                iou = min(t, 1 - 1e-10)
                m = -1
                for gi in range(G):
                    if gtm[ti, gi] >= 0 and not gts[gi]["iscrowd"]:
                        continue
                    if m > -1 and not g_ignore[m] and g_ignore[gi]:
                        break
                    if ious[di, gi] < iou:
                        continue
                    iou = ious[di, gi]
                    m = gi
                if m != -1:
                    dtm[ti, di] = m
                    gtm[ti, m] = di
        d_area = np.array(
            [(d["box"][2] - d["box"][0]) * (d["box"][3] - d["box"][1])
             for d in dts])
        d_ignore = np.zeros((T, D), bool)
        for ti in range(T):
            for di in range(D):
                m = dtm[ti, di]
                if m >= 0:
                    d_ignore[ti, di] = g_ignore[m]
                else:
                    d_ignore[ti, di] = (d_area[di] < area_rng[0]
                                        or d_area[di] > area_rng[1])
        return dict(
            scores=np.array([d["score"] for d in dts]),
            dtm=dtm, d_ignore=d_ignore,
            num_gt=int((~g_ignore).sum()))

    def accumulate(self) -> Dict[str, float]:
        img_ids = list(dict.fromkeys(self._img_ids))
        K = len(self.cat_ids)
        A = len(AREA_RANGES)
        M = len(MAX_DETS)
        T, R = len(IOU_THRS), len(REC_THRS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for ki, cat in enumerate(self.cat_ids):
            for ai, rng in enumerate(AREA_RANGES.values()):
                for mi, max_det in enumerate(MAX_DETS):
                    evals = [self._evaluate_img(i, cat, rng, max_det)
                             for i in img_ids]
                    evals = [e for e in evals if e is not None]
                    if not evals:
                        continue
                    scores = np.concatenate([e["scores"] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate([e["dtm"] for e in evals],
                                         axis=1)[:, order]
                    dig = np.concatenate([e["d_ignore"] for e in evals],
                                         axis=1)[:, order]
                    npig = sum(e["num_gt"] for e in evals)
                    if npig == 0:
                        continue
                    tps = (dtm >= 0) & ~dig
                    fps = (dtm < 0) & ~dig
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(fp + tp,
                                             np.finfo(np.float64).eps)
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        self.precision = precision
        self.recall = recall
        return self._summarize()

    def _summarize(self) -> Dict[str, float]:
        def s_ap(iou=None, area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            p = self.precision[:, :, :, ai, mi]
            if iou is not None:
                p = p[[int(np.where(np.isclose(IOU_THRS, iou))[0][0])]]
            vals = p[p > -1]
            return float(vals.mean()) if vals.size else -1.0

        def s_ar(area="all", max_det=100):
            ai = list(AREA_RANGES).index(area)
            mi = MAX_DETS.index(max_det)
            r = self.recall[:, :, ai, mi]
            vals = r[r > -1]
            return float(vals.mean()) if vals.size else -1.0

        return {
            "AP": s_ap(), "AP50": s_ap(iou=0.5), "AP75": s_ap(iou=0.75),
            "APs": s_ap(area="small"), "APm": s_ap(area="medium"),
            "APl": s_ap(area="large"),
            "AR@1": s_ar(max_det=1), "AR@10": s_ar(max_det=10),
            "AR@100": s_ar(max_det=100),
            "ARs@100": s_ar(area="small"), "ARm@100": s_ar(area="medium"),
            "ARl@100": s_ar(area="large"),
        }
