"""VG detection mAP wrapper (CocoEvaluator analog): the port's own copy of
``egtr_tpu/evaluation/coco_eval.py``.

Mirrors the reference's usage (lib/evaluation/coco_eval.py:24-66 +
train_egtr.py:369-396): per-image post-processed detections with
``category_id += 1`` re-offset are accumulated and summarized with the COCO
bbox protocol.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from .coco_map import CocoMAP


class CocoEvaluator:
    def __init__(self, category_ids: Sequence[int]):
        self._map = CocoMAP(list(category_ids))

    def update(self, image_id, gt_boxes_xyxy, gt_labels, det_boxes_xyxy,
               det_scores, det_labels) -> None:
        """labels here are the dataset's original category ids; the caller
        applies the +1 offset for VG (coco_eval.py:44-45)."""
        self._map.add_image(
            image_id,
            gt=dict(boxes=np.asarray(gt_boxes_xyxy),
                    labels=np.asarray(gt_labels)),
            det=dict(boxes=np.asarray(det_boxes_xyxy),
                     scores=np.asarray(det_scores),
                     labels=np.asarray(det_labels)))

    def summarize(self) -> Dict[str, float]:
        return self._map.accumulate()

    # --- merge: delegates to CocoMAP's state API, which refuses repeated
    #     image ids (reference: lib/evaluation/coco_eval.py:59-64,178-207) ---
    def state(self) -> dict:
        return self._map.state()

    def merge_state(self, other: dict) -> None:
        self._map.merge_state(other)

    def clear(self) -> None:
        self._map.clear()

    def num_images(self) -> int:
        return self._map.num_images()
