"""Open Images V6 (VRD) dataset: the port's own copy of
``egtr_tpu/data/open_images.py``, numpy and PIL only.

Mirrors the reference ``OIDetection``/``OIDataset``/``oi_get_statistics``
(data/open_image.py:31-185):
- ``vrd-{split}-anno.json`` holds xyxy boxes, which go through the
  reference's xyxy -> xywh(+1) -> xyxy round trip (x2' = x2 + 1),
- ``categories_dict.json`` names the 601 object and 30 predicate classes,
- the train split keeps images with at most ``num_object_queries`` boxes and
  drops duplicate (subject, object, predicate) triples; with
  ``filter_multiple_rels`` each (subject, object) pair keeps one predicate,
  drawn from the dataset's generator,
- ``debug`` caps the train split at 5,000 images.

The annotations carry no image sizes, so ``nominal_size`` reads the JPEG
header (no pixel decode) and caches it; ``precache_sizes`` fills that cache
in one pass. The train augmentation and the predicate draws take one
``np.random.Generator`` per dataset, seeded with ``seed``, in item order, as
the JAX package does.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image

from .transforms import (DETR_TRAIN_SCALES, Sample, preprocess,
                         size_with_aspect_ratio)


class OIDataset:
    def __init__(self, data_folder: str, split: str, *, train_aug: bool = False,
                 filter_duplicate_rels: bool = True,
                 filter_multiple_rels: bool = False,
                 num_object_queries: int = 200,
                 size: int = 800, max_size: int = 1333, debug: bool = False,
                 seed: int = 42, use_crop: bool = False):
        if split not in ("train", "val", "test"):
            raise ValueError(f"split must be train, val or test: {split!r}")
        self.data_folder = data_folder
        self.img_dir = os.path.join(data_folder, "images")
        self.split = split
        self.train_aug = train_aug and split == "train"
        self.size = size
        self.max_size = max_size
        self.rng = np.random.default_rng(seed)
        self.use_crop = use_crop
        self._size_cache: Dict[int, Tuple[int, int]] = {}

        annotations = os.path.join(data_folder, "annotations")
        with open(os.path.join(annotations, f"vrd-{split}-anno.json")) as f:
            self.targets: List[dict] = json.load(f)
        with open(os.path.join(annotations, "categories_dict.json")) as f:
            info = json.load(f)
        self.ind_to_classes = info["obj"]
        self.rel_categories = info["rel"]

        self.filter_multiple_rels = filter_multiple_rels and split == "train"
        if split == "train":
            self.targets = [t for t in self.targets
                            if len(t["bbox"]) <= num_object_queries]
            if filter_duplicate_rels:
                for t in self.targets:
                    # first occurrence order, as a dict keeps it
                    seen = dict.fromkeys(map(tuple, t["rel"]))
                    t["rel"] = [list(triple) for triple in seen]
        if debug and split == "train":
            self.targets = self.targets[:5000]
        self.ids = list(range(len(self.targets)))

    def __len__(self):
        return len(self.targets)

    def num_classes(self) -> int:
        return len(self.ind_to_classes)

    def _image_path(self, idx: int) -> str:
        return os.path.join(self.img_dir, f"{self.targets[idx]['img_fn']}.jpg")

    def nominal_size(self, idx: int):
        """The post-resize (h, w) upper bound (``VGDataset.nominal_size``'s
        contract), from the JPEG header: PIL's open is lazy, so no pixels
        are decoded. Cached per index."""
        wh = self._size_cache.get(idx)
        if wh is None:
            with Image.open(self._image_path(idx)) as im:
                wh = self._size_cache[idx] = im.size
        s = max(DETR_TRAIN_SCALES) if self.train_aug else self.size
        return size_with_aspect_ratio(wh[0], wh[1], s, self.max_size)

    def precache_sizes(self) -> None:
        """Fill the ``nominal_size`` cache for the whole dataset in one pass,
        so that bucketing every batch opens each image's header once in
        all."""
        for idx in range(len(self.targets)):
            self.nominal_size(idx)

    def __getitem__(self, idx: int) -> Sample:
        t = self.targets[idx]
        with Image.open(self._image_path(idx)) as f:
            img = f.convert("RGB")
        # the reference's xyxy -> xywh(+1) -> xyxy round trip
        # (open_image.py:59-76): x2' = x2 + 1
        boxes = np.asarray(t["bbox"], np.float32).reshape(-1, 4).copy()
        boxes[:, 2:] += 1.0
        labels = np.asarray(t["det_labels"], np.int32)

        rel_list = t["rel"]
        if self.filter_multiple_rels:
            by_pair = defaultdict(list)
            for s, o, r in rel_list:
                by_pair[(s, o)].append(r)
            rel_list = [[s, o, int(self.rng.choice(rs))]
                        for (s, o), rs in by_pair.items()]
        rel = np.asarray(rel_list, np.int32).reshape(-1, 3)

        return preprocess(
            img, boxes, labels, rel, train=self.train_aug, rng=self.rng,
            size=self.size, max_size=self.max_size, image_id=idx,
            use_crop=self.use_crop)


def oi_get_statistics(dataset: OIDataset) -> np.ndarray:
    """fg_matrix [C+1, C+1, P] of triplet counts over the (filtered) targets
    (data/open_image.py:161-185)."""
    C = dataset.num_classes()
    P = len(dataset.rel_categories)
    fg = np.zeros((C + 1, C + 1, P), np.int64)
    for t in dataset.targets:
        labels = t["det_labels"]
        for s, o, r in t["rel"]:
            fg[labels[s], labels[o], r] += 1
    return fg
