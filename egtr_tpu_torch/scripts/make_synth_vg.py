"""Generate a synthetic Visual-Genome-format dataset with learnable structure
(the port's own copy of the repo's ``scripts/make_synth_vg.py``: the same
seed writes the same files, byte for byte).

Reference format: data/visual_genome.py:14-80 — COCO-style {split}.json +
rel.json + images/. Each image is a noisy background with k colored
rectangles; the object class IS the color, and relations are geometric
predicates computed from the box layout (left_of / above / overlap / near).
Uniform source image sizes keep every split in one shape bucket.

    python -m egtr_tpu_torch.scripts.make_synth_vg OUT [--n_train 800]
        [--n_val 48] [--n_test 48] [--height 600] [--width 1000] [--seed 0]
"""

import argparse
import json
import os

import numpy as np
from PIL import Image

COLORS = [(220, 40, 40), (40, 200, 40), (40, 80, 220),
          (230, 220, 50), (200, 60, 200), (60, 210, 210)]
CLASS_NAMES = ["red", "green", "blue", "yellow", "magenta", "cyan"]
# rel.json convention: rel_categories[0] is the dropped background slot
REL_NAMES = ["__background__", "left_of", "above", "overlap", "near"]


def _iou(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    ar = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ar, 1)


def _relations(boxes, W, H):
    """Geometric predicate ids (1-based into REL_NAMES) for box pairs."""
    rels = []
    near_thresh = 0.2 * (W + H) / 2
    for i, a in enumerate(boxes):
        for j, b in enumerate(boxes):
            if i == j:
                continue
            cax, cay = (a[0] + a[2]) / 2, (a[1] + a[3]) / 2
            cbx, cby = (b[0] + b[2]) / 2, (b[1] + b[3]) / 2
            if _iou(a, b) > 0.1:
                rels.append([i, j, 3])
            elif a[2] < b[0] and abs(cay - cby) < (a[3] - a[1]):
                rels.append([i, j, 1])
            elif a[3] < b[1] and abs(cax - cbx) < (a[2] - a[0]):
                rels.append([i, j, 2])
            elif (abs(cax - cbx) + abs(cay - cby)) < near_thresh:
                rels.append([i, j, 4])
    return rels


def make_split(out, split, n, H, W, rng):
    images, annotations = [], []
    rels = {}
    ann_id = 1
    for i in range(n):
        img_id = i + 1
        img = rng.integers(80, 130, (H, W, 3)).astype(np.uint8)
        k = int(rng.integers(3, 8))
        boxes, classes = [], []
        for _ in range(k):
            w = int(rng.integers(W // 10, W // 3))
            h = int(rng.integers(H // 10, H // 3))
            x = int(rng.integers(0, W - w))
            y = int(rng.integers(0, H - h))
            c = int(rng.integers(0, len(COLORS)))
            col = np.array(COLORS[c]) + rng.integers(-20, 20, 3)
            img[y:y + h, x:x + w] = np.clip(col, 0, 255)
            boxes.append([x, y, x + w, y + h])
            classes.append(c)
        fn = f"{split}_{i}.jpg"
        Image.fromarray(img, "RGB").save(
            os.path.join(out, "images", fn), quality=90)
        images.append({"id": img_id, "file_name": fn,
                       "width": W, "height": H})
        for (x1, y1, x2, y2), c in zip(boxes, classes):
            annotations.append({
                "id": ann_id, "image_id": img_id,
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                # category_id is 1-based; VGDataset subtracts 1
                "category_id": c + 1,
                "area": (x2 - x1) * (y2 - y1), "iscrowd": 0})
            ann_id += 1
        rl = _relations(boxes, W, H)
        if rl:
            rels[str(img_id)] = rl
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": c + 1, "name": n_}
                           for c, n_ in enumerate(CLASS_NAMES)]}
    with open(os.path.join(out, f"{split}.json"), "w") as f:
        json.dump(coco, f)
    return rels


def make_synth_vg(out: str, n_train: int = 800, n_val: int = 48,
                  n_test: int = 48, height: int = 600, width: int = 1000,
                  seed: int = 0) -> None:
    """Write the three splits, their images and rel.json under ``out``."""
    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    rng = np.random.default_rng(seed)
    rel = {"rel_categories": REL_NAMES}
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        rel[split] = make_split(out, split, n, height, width, rng)
    with open(os.path.join(out, "rel.json"), "w") as f:
        json.dump(rel, f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--n_train", type=int, default=800)
    ap.add_argument("--n_val", type=int, default=48)
    ap.add_argument("--n_test", type=int, default=48)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--width", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    make_synth_vg(args.out, args.n_train, args.n_val, args.n_test,
                  args.height, args.width, args.seed)
    print(f"wrote {args.out}: {args.n_train}/{args.n_val}/{args.n_test} "
          f"images at {args.height}x{args.width}")


if __name__ == "__main__":
    main()
