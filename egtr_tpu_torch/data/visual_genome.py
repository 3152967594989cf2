"""Visual Genome dataset (COCO-format JSON + rel.json): the port's own copy of
``egtr_tpu/data/visual_genome.py``, numpy and PIL only.

Mirrors the reference ``VGDetection``/``VGDataset``/``vg_get_statistics``
(data/visual_genome.py:14-118) semantics:
- object classes come from ``category_id - 1`` (drops the 'no relation'
  background offset; 150 classes 0..149),
- predicate ids in rel.json triples are shifted by -1 (50 predicates),
- relation triples index annotations in file order,
- ``debug`` caps the train split at 5,000 images.

The train augmentation draws from one ``np.random.Generator`` per dataset,
seeded with ``seed``, in item order, as the JAX package does.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np
from PIL import Image

from .transforms import (DETR_TRAIN_SCALES, Sample, preprocess,
                         size_with_aspect_ratio)


class VGDataset:
    def __init__(self, data_folder: str, split: str, *, train_aug: bool = False,
                 size: int = 800, max_size: int = 1333, debug: bool = False,
                 seed: int = 42, use_crop: bool = False):
        self.data_folder = data_folder
        self.split = split
        self.train_aug = train_aug and split == "train"
        self.size = size
        self.max_size = max_size
        self.rng = np.random.default_rng(seed)
        self.use_crop = use_crop

        with open(os.path.join(data_folder, f"{split}.json")) as f:
            coco = json.load(f)
        self.images: List[dict] = coco["images"]
        self.categories = {c["id"]: c["name"] for c in coco["categories"]}
        anns_by_image: Dict[int, List[dict]] = defaultdict(list)
        for a in coco["annotations"]:
            anns_by_image[a["image_id"]].append(a)
        self.anns_by_image = anns_by_image

        with open(os.path.join(data_folder, "rel.json")) as f:
            rel = json.load(f)
        self.rel = rel[split]
        # drop 'no_relation' (data/visual_genome.py:56)
        self.rel_categories = rel["rel_categories"][1:]

        self.ids = [img["id"] for img in self.images]
        self._img_by_id = {img["id"]: img for img in self.images}
        if debug and split == "train":
            self.ids = self.ids[:5000]

    def __len__(self):
        return len(self.ids)

    def num_classes(self) -> int:
        return len(self.categories)

    def nominal_size(self, idx: int):
        """Deterministic post-resize (h, w) upper bound from annotation
        metadata alone (no image decode). The train augmentation's final
        resize uses a DETR scale capped at 800 with the same max_size and
        an unchanged aspect ratio (transforms.preprocess), so the bound
        holds for augmented samples too — EXCEPT under crop augmentation
        (aspect ratio changes); the loader checks ``use_crop``. Multi-process
        loaders bucket on this so every process picks the same batch shape."""
        info = self._img_by_id[self.ids[idx]]
        s = max(DETR_TRAIN_SCALES) if self.train_aug else self.size
        return size_with_aspect_ratio(info["width"], info["height"],
                                      s, self.max_size)

    def raw_annotations(self, image_id: int):
        """(boxes_xyxy [n,4], class_labels_0based [n], rel_triples [m,3])."""
        anns = self.anns_by_image.get(image_id, [])
        boxes, labels = [], []
        for a in anns:
            x, y, w, h = a["bbox"]  # COCO xywh
            boxes.append([x, y, x + w, y + h])
            labels.append(a["category_id"] - 1)  # drop background offset
        rel_list = self.rel.get(str(image_id), [])
        rel = np.asarray(rel_list, np.int64).reshape(-1, 3)
        if len(rel):
            rel = rel.copy()
            rel[:, 2] -= 1  # drop 'no_relation' predicate
        return (np.asarray(boxes, np.float32).reshape(-1, 4),
                np.asarray(labels, np.int32), rel.astype(np.int32))

    def __getitem__(self, idx: int) -> Sample:
        image_id = self.ids[idx]
        info = self._img_by_id[image_id]
        path = os.path.join(self.data_folder, "images", info["file_name"])
        with Image.open(path) as f:
            img = f.convert("RGB")
        boxes, labels, rel = self.raw_annotations(image_id)
        return preprocess(
            img, boxes, labels, rel, train=self.train_aug, rng=self.rng,
            size=self.size, max_size=self.max_size, image_id=image_id,
            use_crop=self.use_crop)


def vg_get_statistics(dataset: VGDataset) -> np.ndarray:
    """fg_matrix [C+1, C+1, P] of triplet co-occurrence counts
    (data/visual_genome.py:84-118). Class indices use the raw 1-based
    category ids minus 1, matching ``fg_matrix[o1-1, o2-1, p]``."""
    num_classes = dataset.num_classes()
    num_predicates = len(dataset.rel_categories)
    fg = np.zeros((num_classes + 1, num_classes + 1, num_predicates), np.int64)
    for image_id in dataset.ids:
        anns = dataset.anns_by_image.get(image_id, [])
        gt_classes = np.array([a["category_id"] for a in anns], np.int64)
        rel_list = dataset.rel.get(str(image_id), [])
        for (s, o, p) in rel_list:
            fg[gt_classes[s] - 1, gt_classes[o] - 1, p - 1] += 1
    return fg
