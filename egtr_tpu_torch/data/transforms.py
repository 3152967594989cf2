"""Host-side image preprocessing (numpy/PIL) with shape buckets: the port's
own copy of ``egtr_tpu/data/transforms.py``, pixel for pixel.

Mirrors the reference preprocessing chain — HF ``DetrFeatureExtractor``
(shortest-side resize + ImageNet normalize + pad) and the DETR-style train
augmentors (model/deformable_detr.py:322-385, model/transform.py). Every image
is padded to one of a small set of bucket shapes, as in the JAX package, so
the batches of both packages are the same arrays. PIL does the decoding and
the BILINEAR resize: another interpolation would give other pixels.

Box convention inside targets: normalized (cx, cy, w, h) w.r.t. the
*unpadded* resized image — identical to the reference (transform.py:255-271),
so loss values and eval rescaling match.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# DETR multi-scale training resolutions (deformable_detr.py:338)
DETR_TRAIN_SCALES = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)


def size_with_aspect_ratio(w: int, h: int, size: int,
                           max_size: Optional[int]) -> Tuple[int, int]:
    """(oh, ow) for shortest-side resize — exact torch DetrFeatureExtractor
    semantics (round + int truncation order preserved)."""
    if max_size is not None:
        min_o, max_o = float(min(w, h)), float(max(w, h))
        if max_o / min_o * size > max_size:
            size = int(round(max_size * min_o / max_o))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh, ow


@dataclasses.dataclass
class Sample:
    """One preprocessed example (before batching/padding)."""
    image: np.ndarray            # [h, w, 3] float32, normalized
    boxes: np.ndarray            # [n, 4] normalized cxcywh
    class_labels: np.ndarray     # [n] int32
    rel: np.ndarray              # [m, 3] int32 (subject_idx, object_idx, predicate)
    orig_size: Tuple[int, int]   # (h, w) before any resize
    size: Tuple[int, int]        # (h, w) after resize (pre-padding)
    image_id: int = -1


def _resize_image_and_boxes(img: Image.Image, boxes_xyxy: np.ndarray,
                            target_hw: Tuple[int, int]):
    oh, ow = target_hw
    w, h = img.size
    img = img.resize((ow, oh), Image.BILINEAR)
    if len(boxes_xyxy):
        scale = np.array([ow / w, oh / h, ow / w, oh / h], np.float32)
        boxes_xyxy = boxes_xyxy * scale
    return img, boxes_xyxy


def _random_size_crop(img: Image.Image, boxes_xyxy, class_labels, rel,
                      rng, min_size: int = 384, max_size: int = 600):
    """DETR RandomSizeCrop (model/transform.py:170-179 + crop():19-59):
    random region, boxes translated+clamped, zero-area boxes removed.
    Relations are re-indexed; triples referencing removed boxes drop."""
    w = int(rng.integers(min_size, min(img.width, max_size) + 1)) \
        if min(img.width, max_size) >= min_size else img.width
    h = int(rng.integers(min_size, min(img.height, max_size) + 1)) \
        if min(img.height, max_size) >= min_size else img.height
    i = int(rng.integers(0, img.height - h + 1))
    j = int(rng.integers(0, img.width - w + 1))
    img = img.crop((j, i, j + w, i + h))
    if len(boxes_xyxy):
        b = boxes_xyxy - np.array([j, i, j, i], np.float32)
        b = np.minimum(b.reshape(-1, 2, 2), np.array([w, h], np.float32))
        b = np.clip(b, 0, None).reshape(-1, 4)
        keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        boxes_xyxy = b[keep]
        class_labels = np.asarray(class_labels)[keep]
        # remap relation indices to the kept set
        old_to_new = -np.ones(len(keep), np.int32)
        old_to_new[keep] = np.arange(int(keep.sum()), dtype=np.int32)
        if len(rel):
            rel = np.asarray(rel).reshape(-1, 3)
            s, o = old_to_new[rel[:, 0]], old_to_new[rel[:, 1]]
            ok = (s >= 0) & (o >= 0)
            rel = np.stack([s[ok], o[ok], rel[ok, 2]], 1)
    return img, boxes_xyxy, class_labels, rel


def _hflip(img: Image.Image, boxes_xyxy: np.ndarray):
    w = img.size[0]
    img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if len(boxes_xyxy):
        flipped = boxes_xyxy.copy()
        flipped[:, 0] = w - boxes_xyxy[:, 2]
        flipped[:, 2] = w - boxes_xyxy[:, 0]
        boxes_xyxy = flipped
    return img, boxes_xyxy


def preprocess(
    img: Image.Image,
    boxes_xyxy: np.ndarray,
    class_labels: np.ndarray,
    rel: np.ndarray,
    *,
    train: bool,
    rng: Optional[np.random.Generator] = None,
    size: int = 800,
    max_size: int = 1333,
    image_id: int = -1,
    use_crop: bool = False,
) -> Sample:
    """Resize (+ train-time augment) one image and its annotations.

    Train path mirrors DeformableDetrFeatureExtractorWithAugmentor[NoCrop]
    (deformable_detr.py:322-385): hflip(p=.5) then either a random DETR-scale
    resize or a 400/500/600 downscale, [RandomSizeCrop(384,600) when
    ``use_crop`` — the detector-pretraining variant], then a DETR-scale
    resize. EGTR training uses the NoCrop variant (train_egtr.py:578-582)
    because cropping drops boxes that relations index. ``rng`` draws the
    augmentation in the JAX package's order, so one seed gives both packages
    the same samples.
    """
    orig_w, orig_h = img.size
    boxes_xyxy = np.asarray(boxes_xyxy, np.float32).reshape(-1, 4)

    if train:
        if rng is None:
            raise ValueError("the train path draws its augmentation from rng")
        if rng.random() < 0.5:
            img, boxes_xyxy = _hflip(img, boxes_xyxy)
        if rng.random() < 0.5:
            s = int(rng.choice(DETR_TRAIN_SCALES))
            img, boxes_xyxy = _resize_image_and_boxes(
                img, boxes_xyxy,
                size_with_aspect_ratio(*img.size, s, max_size))
        else:
            s0 = int(rng.choice((400, 500, 600)))
            img, boxes_xyxy = _resize_image_and_boxes(
                img, boxes_xyxy, size_with_aspect_ratio(*img.size, s0, None))
            if use_crop:
                img, boxes_xyxy, class_labels, rel = _random_size_crop(
                    img, boxes_xyxy, class_labels, rel, rng)
            s = int(rng.choice(DETR_TRAIN_SCALES))
            img, boxes_xyxy = _resize_image_and_boxes(
                img, boxes_xyxy,
                size_with_aspect_ratio(*img.size, s, max_size))
    else:
        img, boxes_xyxy = _resize_image_and_boxes(
            img, boxes_xyxy, size_with_aspect_ratio(*img.size, size, max_size))

    w, h = img.size
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD

    # xyxy -> normalized cxcywh (transform.py:255-271)
    if len(boxes_xyxy):
        b = boxes_xyxy
        cxcywh = np.stack([
            (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
            b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1)
        cxcywh = cxcywh / np.array([w, h, w, h], np.float32)
    else:
        cxcywh = np.zeros((0, 4), np.float32)

    return Sample(
        image=arr, boxes=cxcywh,
        class_labels=np.asarray(class_labels, np.int32),
        rel=np.asarray(rel, np.int32).reshape(-1, 3),
        orig_size=(orig_h, orig_w), size=(h, w), image_id=image_id)


# ---------------------------------------------------------------------------
# Shape buckets


def default_buckets(max_size: int = 1333) -> Tuple[Tuple[int, int], ...]:
    """Buckets covering the DETR resize range with modest padding waste.

    The square max-size bucket is the safety net for batches mixing
    portrait and landscape images (their joint (max_h, max_w) bound is
    square-ish); resize caps the longest side at max_size, so it
    contains every in-protocol sample."""
    if max_size <= 1000:  # FPS protocol: 600/1000
        return ((608, 1008), (1008, 608), (768, 768), (1008, 1008))
    return ((800, 1344), (1344, 800), (1024, 1024), (768, 1344),
            (1344, 768), (1344, 1344))


def pick_bucket(h: int, w: int,
                buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest-area bucket that contains (h, w)."""
    fitting = [(bh * bw, (bh, bw)) for bh, bw in buckets if bh >= h and bw >= w]
    if not fitting:
        # silently returning a non-containing bucket would turn into a
        # collate error (or worse, cropped content) downstream
        raise ValueError(
            f"no bucket contains a {h}x{w} sample; buckets={tuple(buckets)} "
            "must include a square max-size bucket for mixed-orientation "
            "batches")
    return min(fitting)[1]


def collate(samples: List[Sample], bucket_hw: Tuple[int, int], max_gt: int,
            num_rel_labels: int):
    """Pad a list of samples into one fixed-shape batch dict of numpy arrays.

    Produces the padded-target layout consumed by
    :mod:`egtr_tpu_torch.ops.criterion` plus pixel_values/pixel_mask;
    :func:`egtr_tpu_torch.train.trainer.to_device` moves it to the card.
    """
    B = len(samples)
    H, W = bucket_hw
    pixel_values = np.zeros((B, H, W, 3), np.float32)
    pixel_mask = np.zeros((B, H, W), bool)
    class_labels = np.zeros((B, max_gt), np.int32)
    boxes = np.tile(np.array([0.5, 0.5, 1.0, 1.0], np.float32),
                    (B, max_gt, 1))
    num_boxes = np.zeros((B,), np.int32)
    rel = np.zeros((B, max_gt, max_gt, num_rel_labels), np.float32)
    orig_sizes = np.zeros((B, 2), np.int32)
    sizes = np.zeros((B, 2), np.int32)
    image_ids = np.zeros((B,), np.int64)

    for i, s in enumerate(samples):
        h, w = s.image.shape[:2]
        if h > H or w > W:
            raise ValueError(f"sample {h}x{w} exceeds bucket {H}x{W}")
        pixel_values[i, :h, :w] = s.image
        pixel_mask[i, :h, :w] = True
        n = min(len(s.class_labels), max_gt)
        class_labels[i, :n] = s.class_labels[:n]
        if n:
            boxes[i, :n] = s.boxes[:n]
        num_boxes[i] = n
        for (sj, oj, p) in s.rel:
            if sj < n and oj < n and 0 <= p < num_rel_labels:
                rel[i, sj, oj, p] = 1.0
        orig_sizes[i] = s.orig_size
        sizes[i] = s.size
        image_ids[i] = s.image_id

    return {
        "pixel_values": pixel_values,
        "pixel_mask": pixel_mask,
        "labels": {
            "class_labels": class_labels,
            "boxes": boxes,
            "num_boxes": num_boxes,
            "rel": rel,
        },
        "orig_size": orig_sizes,
        "size": sizes,
        "image_id": image_ids,
    }
