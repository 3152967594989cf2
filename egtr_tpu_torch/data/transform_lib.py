"""Composable image/target transform library (numpy/PIL): the port's own
copy of ``egtr_tpu/data/transform_lib.py``, array for array.

Standalone counterpart of the reference's DETR transform module
(model/transform.py:19-290): the same reusable pieces — crop / hflip /
resize / pad primitives and the RandomCrop, RandomSizeCrop, CenterCrop,
RandomHorizontalFlip, RandomResize, RandomPad, RandomSelect, ToArray,
RandomErasing, Normalize, Compose combinators — for the host-side numpy
pipeline. The drivers' path (``transforms.preprocess``) inlines the
augmentor recipes they use; this module is the library surface for custom
pipelines, and no driver imports it.

Contract: every transform is ``(image, target) -> (image, target)`` where
``image`` is a PIL.Image (HWC float32 numpy after ``ToArray``) and
``target`` is a dict with optional keys:

- "boxes": [n, 4] float32 absolute xyxy
- "labels": [n] int
- "rel": [m, 3] int (subject_idx, object_idx, predicate) — re-indexed when
  crops drop boxes (the reference never threads relations through crops;
  EGTR avoids crops for SGG training, train_egtr.py:578-582)
- "size": (h, w)

Determinism: random transforms take an explicit ``np.random.Generator``
(no hidden global RNG), unlike the reference's ``random`` module calls, so
one seed gives both packages the same draws.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from .transforms import IMAGENET_MEAN, IMAGENET_STD, size_with_aspect_ratio


def _empty_target(target):
    return target if target is not None else {}


def crop(image, target, region):
    """region = (top, left, height, width); boxes translated + clamped,
    degenerate boxes removed and relations re-indexed (transform.py:19-59)."""
    i, j, h, w = region
    image = image.crop((j, i, j + w, i + h))
    if target is None:
        return image, None
    target = dict(target)
    target["size"] = (h, w)
    if "boxes" in target and len(target["boxes"]):
        b = np.asarray(target["boxes"], np.float32) - np.array(
            [j, i, j, i], np.float32)
        b = np.minimum(b.reshape(-1, 2, 2),
                       np.array([w, h], np.float32))
        b = np.clip(b, 0, None).reshape(-1, 4)
        keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        target["boxes"] = b[keep]
        if "labels" in target:
            target["labels"] = np.asarray(target["labels"])[keep]
        if "rel" in target and len(target["rel"]):
            old_to_new = -np.ones(len(keep), np.int32)
            old_to_new[keep] = np.arange(int(keep.sum()), dtype=np.int32)
            rel = np.asarray(target["rel"]).reshape(-1, 3)
            s, o = old_to_new[rel[:, 0]], old_to_new[rel[:, 1]]
            ok = (s >= 0) & (o >= 0)
            target["rel"] = np.stack([s[ok], o[ok], rel[ok, 2]], 1)
    return image, target


def hflip(image, target):
    """Horizontal flip (transform.py:62-78)."""
    image = image.transpose(Image.FLIP_LEFT_RIGHT)
    if target is None:
        return image, None
    target = dict(target)
    w = image.size[0]
    if "boxes" in target and len(target["boxes"]):
        b = np.asarray(target["boxes"], np.float32)
        flipped = b.copy()
        flipped[:, 0] = w - b[:, 2]
        flipped[:, 2] = w - b[:, 0]
        target["boxes"] = flipped
    return image, target


def resize(image, target, size, max_size: Optional[int] = None):
    """Shortest-side resize with exact torch rounding semantics
    (transform.py:81-143)."""
    w, h = image.size
    oh, ow = size_with_aspect_ratio(w, h, size, max_size)
    image = image.resize((ow, oh), Image.BILINEAR)
    if target is None:
        return image, None
    target = dict(target)
    target["size"] = (oh, ow)
    if "boxes" in target and len(target["boxes"]):
        scale = np.array([ow / w, oh / h, ow / w, oh / h], np.float32)
        target["boxes"] = np.asarray(target["boxes"], np.float32) * scale
    return image, target


def pad(image, target, padding: Tuple[int, int]):
    """Bottom-right pad by (pad_x, pad_y) (transform.py:146-159)."""
    pad_x, pad_y = padding
    out = Image.new(image.mode, (image.width + pad_x, image.height + pad_y))
    out.paste(image, (0, 0))
    if target is None:
        return out, None
    target = dict(target)
    target["size"] = (out.height, out.width)
    return out, target


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, image, target):
        for t in self.transforms:
            image, target = t(image, target)
        return image, target


class RandomCrop:
    def __init__(self, size: Tuple[int, int], rng: np.random.Generator):
        self.size = size
        self.rng = rng

    def __call__(self, image, target):
        h, w = self.size
        i = int(self.rng.integers(0, image.height - h + 1))
        j = int(self.rng.integers(0, image.width - w + 1))
        return crop(image, target, (i, j, h, w))


class RandomSizeCrop:
    """Random target size in [min_size, min(image, max_size)]
    (transform.py:170-179)."""

    def __init__(self, min_size: int, max_size: int,
                 rng: np.random.Generator):
        self.min_size = min_size
        self.max_size = max_size
        self.rng = rng

    def __call__(self, image, target):
        w = int(self.rng.integers(self.min_size,
                                  min(image.width, self.max_size) + 1))
        h = int(self.rng.integers(self.min_size,
                                  min(image.height, self.max_size) + 1))
        i = int(self.rng.integers(0, image.height - h + 1))
        j = int(self.rng.integers(0, image.width - w + 1))
        return crop(image, target, (i, j, h, w))


class CenterCrop:
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, image, target):
        ch, cw = self.size
        top = int(round((image.height - ch) / 2.0))
        left = int(round((image.width - cw) / 2.0))
        return crop(image, target, (top, left, ch, cw))


class RandomHorizontalFlip:
    def __init__(self, rng: np.random.Generator, p: float = 0.5):
        self.p = p
        self.rng = rng

    def __call__(self, image, target):
        if self.rng.random() < self.p:
            return hflip(image, target)
        return image, target


class RandomResize:
    def __init__(self, sizes: Sequence[int], rng: np.random.Generator,
                 max_size: Optional[int] = None):
        self.sizes = list(sizes)
        self.max_size = max_size
        self.rng = rng

    def __call__(self, image, target=None):
        size = int(self.rng.choice(self.sizes))
        return resize(image, target, size, self.max_size)


class RandomPad:
    def __init__(self, max_pad: int, rng: np.random.Generator):
        self.max_pad = max_pad
        self.rng = rng

    def __call__(self, image, target):
        pad_x = int(self.rng.integers(0, self.max_pad + 1))
        pad_y = int(self.rng.integers(0, self.max_pad + 1))
        return pad(image, target, (pad_x, pad_y))


class RandomSelect:
    """transforms1 with probability p, else transforms2
    (transform.py:225-239)."""

    def __init__(self, transforms1, transforms2, rng: np.random.Generator,
                 p: float = 0.5):
        self.transforms1 = transforms1
        self.transforms2 = transforms2
        self.p = p
        self.rng = rng

    def __call__(self, image, target):
        if self.rng.random() < self.p:
            return self.transforms1(image, target)
        return self.transforms2(image, target)


class ToArray:
    """PIL -> HWC float32 in [0, 1] (the torch ToTensor analog, in the
    channels-last layout the port's models take, so no CHW transpose)."""

    def __call__(self, image, target):
        return np.asarray(image, np.float32) / 255.0, target


class RandomErasing:
    """Erase a random rectangle with noise — torchvision RandomErasing
    semantics (scale = erased-area fraction, ratio = aspect range) on an
    HWC float array (transform.py:247-252)."""

    def __init__(self, rng: np.random.Generator, p: float = 0.5,
                 scale: Tuple[float, float] = (0.02, 0.33),
                 ratio: Tuple[float, float] = (0.3, 3.3)):
        self.rng = rng
        self.p = p
        self.scale = scale
        self.ratio = ratio

    def __call__(self, image, target):
        assert isinstance(image, np.ndarray), "apply after ToArray"
        if self.rng.random() >= self.p:
            return image, target
        h, w = image.shape[:2]
        area = h * w
        for _ in range(10):
            er_area = area * self.rng.uniform(*self.scale)
            log_r = self.rng.uniform(math.log(self.ratio[0]),
                                     math.log(self.ratio[1]))
            aspect = math.exp(log_r)
            eh = int(round(math.sqrt(er_area * aspect)))
            ew = int(round(math.sqrt(er_area / aspect)))
            if eh < h and ew < w and eh > 0 and ew > 0:
                top = int(self.rng.integers(0, h - eh + 1))
                left = int(self.rng.integers(0, w - ew + 1))
                image = image.copy()
                image[top:top + eh, left:left + ew] = self.rng.standard_normal(
                    (eh, ew, image.shape[2])).astype(image.dtype)
                return image, target
        return image, target


class Normalize:
    """ImageNet-normalize + xyxy -> normalized cxcywh (transform.py:255-271)."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, image, target=None):
        assert isinstance(image, np.ndarray), "apply after ToArray"
        image = (image - self.mean) / self.std
        if target is None:
            return image, None
        target = dict(target)
        h, w = image.shape[:2]
        if "boxes" in target and len(target["boxes"]):
            b = np.asarray(target["boxes"], np.float32)
            cxcywh = np.stack([
                (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1)
            target["boxes"] = cxcywh / np.array([w, h, w, h], np.float32)
        return image, target
