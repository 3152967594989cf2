"""Batching data loader with parallel preprocessing: the port's own copy of
``egtr_tpu/data/loader.py``.

Replaces the reference's torch ``DataLoader(collate_fn, num_workers=4)`` +
``DistributedSampler`` pair (train_egtr.py:624-640). Groups samples into
shape buckets, pads targets, decodes/augments on a thread pool (PIL decode
and resize release the GIL), and prefetches so host preprocessing overlaps
the card's work. Batches are dicts of numpy arrays, the same arrays the JAX
package's loader yields; ``trainer.to_device`` moves them to the card.

Several processes (``process_index`` of ``process_count``) iterate the SAME
seeded global index order and take their contiguous ``batch_size /
process_count`` slice of each global batch, deriving each batch's bucket
from the dataset's metadata-only size bounds (``nominal_size``) so that all
agree on the batch's shape. This module takes them as plain arguments; the
port's trainer runs one process.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from .transforms import Sample, collate, default_buckets, pick_bucket


class Loader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool,
                 max_gt: int, num_rel_labels: int,
                 buckets: Optional[Sequence[Tuple[int, int]]] = None,
                 seed: int = 42, drop_last: bool = False,
                 prefetch: int = 2, num_workers: int = 4,
                 process_index: int = 0, process_count: int = 1,
                 fixed_bucket: Optional[Tuple[int, int]] = None):
        if batch_size % max(process_count, 1) != 0:
            raise ValueError(
                f"batch_size {batch_size} must divide evenly over "
                f"{process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.max_gt = max_gt
        self.num_rel_labels = num_rel_labels
        self.buckets = tuple(buckets) if buckets else default_buckets(
            getattr(dataset, "max_size", 1333))
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = max(num_workers, 1)
        self.process_index = process_index
        self.process_count = max(process_count, 1)
        if fixed_bucket is None and self.process_count > 1:
            # All processes must agree on each batch's array shape. If the
            # dataset reports a deterministic per-sample size bound from
            # metadata alone (nominal_size) and crop augmentation is off
            # (crops change aspect ratio past the bound), every process
            # derives the same per-batch bucket from the shared global index
            # stream; otherwise pin the largest bucket.
            if not hasattr(dataset, "nominal_size") or getattr(
                    dataset, "use_crop", False):
                fixed_bucket = max(self.buckets, key=lambda b: b[0] * b[1])
        self.fixed_bucket = fixed_bucket
        self._epoch = 0
        self._clamped = 0  # samples downscaled to fit an agreed bucket
        # Fail fast on a bucket list that cannot cover the dataset's resize
        # protocol: shortest-side resize bounds each dim by max_size, and a
        # batch mixing portrait+landscape needs a bucket containing the
        # joint (max_h, max_w) — up to (max_size, max_size).
        ms = getattr(dataset, "max_size", None)
        if buckets and ms and fixed_bucket is None and not any(
                bh >= ms and bw >= ms for bh, bw in self.buckets):
            warnings.warn(
                f"bucket list {self.buckets} has no square >=({ms},{ms}) "
                "safety bucket: a batch mixing portrait and landscape "
                "images will raise at collate time. Add a square max-size "
                "bucket unless the dataset's orientations are homogeneous.",
                stacklevel=2)

    @property
    def init_shape(self) -> Tuple[int, int]:
        """(H, W) bound of every batch, from the bucket set alone, so that a
        caller never consumes the iterator for a shape probe (that would
        advance the epoch and change the shuffle order)."""
        if self.fixed_bucket is not None:
            return self.fixed_bucket
        return max(self.buckets, key=lambda b: b[0] * b[1])

    def dummy_batch(self) -> dict:
        """A zero batch with the loader's exact output structure and its
        ``init_shape`` bucket, without touching the iterator."""
        s = Sample(image=np.zeros((1, 1, 3), np.float32),
                   boxes=np.zeros((0, 4), np.float32),
                   class_labels=np.zeros((0,), np.int32),
                   rel=np.zeros((0, 3), np.int32),
                   orig_size=(1, 1), size=(1, 1))
        per_process = self.batch_size // self.process_count
        batch = collate([s] * per_process, self.init_shape, self.max_gt,
                        self.num_rel_labels)
        batch["valid"] = np.ones(per_process, bool)
        return batch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _fit_to_bucket(self, s, bucket):
        """Downscale a decoded sample that exceeds an already-agreed bucket.

        Only reachable when dataset metadata disagrees with the decoded
        image (VG's image_data width/height is wrong for a handful of
        images): the bucket was derived from metadata before decode, other
        processes already committed to it, so the only safe move is to
        shrink this sample to fit. Boxes are stored normalized, so a pure
        rescale leaves them exact; only ``size`` shifts."""
        h, w = s.image.shape[:2]
        H, W = bucket
        if h <= H and w <= W:
            return s
        scale = min(H / h, W / w)
        nh, nw = max(int(h * scale), 1), max(int(w * scale), 1)
        img = np.stack([
            np.asarray(Image.fromarray(s.image[:, :, c], mode="F")
                       .resize((nw, nh), Image.BILINEAR))
            for c in range(s.image.shape[2])], axis=-1)
        self._clamped += 1
        warnings.warn(
            f"sample {s.image_id}: decoded size {h}x{w} exceeds the "
            f"metadata-derived bucket {H}x{W}; downscaled to {nh}x{nw} "
            "(dataset metadata disagrees with the decoded image)")
        return dataclasses.replace(s, image=img, size=(nh, nw))

    def _make_batch(self, batch_idxs):
        global_idxs, idxs, valid = batch_idxs
        samples = [self.dataset[i] for i in idxs]
        if self.fixed_bucket is not None:
            bucket = self.fixed_bucket
            samples = [self._fit_to_bucket(s, bucket) for s in samples]
        elif self.process_count > 1:
            # per-batch bucket agreed across processes: derived from the
            # GLOBAL batch's metadata size bounds, identical everywhere
            sizes = [self.dataset.nominal_size(i) for i in global_idxs]
            bucket = pick_bucket(max(h for h, _ in sizes),
                                 max(w for _, w in sizes), self.buckets)
            samples = [self._fit_to_bucket(s, bucket) for s in samples]
        else:
            # one bucket for the whole batch: the max over samples
            hs = max(s.image.shape[0] for s in samples)
            ws = max(s.image.shape[1] for s in samples)
            bucket = pick_bucket(hs, ws, self.buckets)
        batch = collate(samples, bucket, self.max_gt, self.num_rel_labels)
        batch["valid"] = valid
        return batch

    def _index_batches(self):
        """Yields (global_idxs, process_idxs, process_valid); every process
        sees the identical global stream and takes its contiguous slice.

        A trailing partial batch: with ``drop_last`` it is dropped;
        otherwise it is PADDED to the full batch size by repeating the
        last index, so every loaded image is still evaluated exactly once
        — the pad rows carry ``valid=False``; evaluators skip them and
        the eval criterion masks them out of the validation loss. (The
        reference's DistributedSampler pads by wrap-around, then evaluates
        duplicates; this keeps the padding but marks it.)"""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        per_process = self.batch_size // self.process_count
        for i in range(0, len(order), self.batch_size):
            idxs = order[i:i + self.batch_size]
            valid = np.ones(self.batch_size, bool)
            if len(idxs) < self.batch_size:
                if self.drop_last:
                    return
                valid[len(idxs):] = False
                idxs = np.concatenate(
                    [idxs, np.repeat(idxs[-1:],
                                     self.batch_size - len(idxs))])
            lo = self.process_index * per_process
            if self.process_count > 1:
                yield (idxs, idxs[lo:lo + per_process],
                       valid[lo:lo + per_process])
            else:
                yield idxs, idxs, valid

    def __iter__(self) -> Iterator[dict]:
        self._epoch += 1
        if self.prefetch <= 0:
            for idxs in self._index_batches():
                yield self._make_batch(idxs)
            return

        # thread-pool preprocessing with an ordered bounded window: up to
        # (prefetch + num_workers) batches in flight, yielded in order
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    window = self.prefetch + self.num_workers
                    futures = []
                    for idxs in self._index_batches():
                        futures.append(pool.submit(self._make_batch, idxs))
                        if len(futures) >= window:
                            q.put(futures.pop(0).result())
                    for f in futures:
                        q.put(f.result())
            except BaseException as e:  # surfaced to the consumer, re-raised
                q.put(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
