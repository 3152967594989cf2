"""Native (C++) host-side evaluation kernels, built at first use and bound
with ctypes: the port's counterpart of ``egtr_tpu/native``.

``bbox_kernels.cpp`` (the port's own copy of the JAX package's source) holds
the "+1 pixel" box IoU of the reference's Cython kernel and the scene-graph
triplet matcher that ``evaluation/sg_eval.py`` runs for every image. It is
compiled with ``g++`` into ``build/`` at the repository root, under a name
keyed by a hash of the source and the flags, to a private name and then
renamed, so a process building at the same time never loads a half-written
library. Nothing is written beside the sources.

There is no fallback: a missing compiler or a failed build raises with the
compiler's output. ``sg_eval._compute_pred_matches_plain``, a numpy loop, is
the matcher's plain version; the evaluator never takes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "bbox_kernels.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# -ffp-contract=off: no fused multiply-adds, so the IoUs are numpy's, bit for
# bit, on every host
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbbox_kernels-{key}.so"


def build() -> Path:
    """Compile the library unless this source is built already; returns its
    path."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native evaluation "
                           f"kernels ({SOURCE}) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE} (exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def get_lib() -> ctypes.CDLL:
    """The library, built and loaded at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            dp = ctypes.POINTER(ctypes.c_double)
            ip = ctypes.POINTER(ctypes.c_int64)
            up = ctypes.POINTER(ctypes.c_uint8)
            lib.bbox_overlaps_plus1.argtypes = [dp, ctypes.c_int64, dp,
                                                ctypes.c_int64, dp]
            lib.bbox_overlaps_plus1.restype = None
            lib.triplet_matches.argtypes = [
                ip, dp, ctypes.c_int64, ip, dp, ctypes.c_int64,
                ctypes.c_double, ctypes.c_int, up]
            lib.triplet_matches.restype = None
            _lib = lib
    return _lib


def _rows(arr, dtype, width: int) -> np.ndarray:
    """A C-contiguous [n, width] copy (or view) the C side can read."""
    out = np.ascontiguousarray(arr, dtype=dtype)
    if out.size % width:
        raise ValueError(f"expected rows of {width} values, got shape "
                         f"{np.shape(arr)}")
    return out.reshape(-1, width)


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def bbox_overlaps(boxes, query_boxes) -> np.ndarray:
    """[n,4] x [k,4] xyxy -> [n,k] float64 IoU (+1 convention)."""
    boxes = _rows(boxes, np.float64, 4)
    query = _rows(query_boxes, np.float64, 4)
    out = np.empty((len(boxes), len(query)), np.float64)
    get_lib().bbox_overlaps_plus1(
        _ptr(boxes, ctypes.c_double), len(boxes),
        _ptr(query, ctypes.c_double), len(query), _ptr(out, ctypes.c_double))
    return out


def triplet_matches(gt_triplets, gt_boxes, pred_triplets, pred_boxes,
                    iou_thresh: float = 0.5, phrdet: bool = False
                    ) -> np.ndarray:
    """Dense [n_gt, n_pred] uint8 match matrix: equal (subject class,
    predicate, object class) and both boxes at IoU >= ``iou_thresh`` (with
    ``phrdet``, the union boxes)."""
    gt_t = _rows(gt_triplets, np.int64, 3)
    gt_b = _rows(gt_boxes, np.float64, 8)
    pr_t = _rows(pred_triplets, np.int64, 3)
    pr_b = _rows(pred_boxes, np.float64, 8)
    if len(gt_t) != len(gt_b) or len(pr_t) != len(pr_b):
        raise ValueError(f"{len(gt_t)} gt triplets with {len(gt_b)} box "
                         f"pairs, {len(pr_t)} predicted with {len(pr_b)}")
    out = np.empty((len(gt_t), len(pr_t)), np.uint8)
    get_lib().triplet_matches(
        _ptr(gt_t, ctypes.c_int64), _ptr(gt_b, ctypes.c_double), len(gt_t),
        _ptr(pr_t, ctypes.c_int64), _ptr(pr_b, ctypes.c_double), len(pr_t),
        float(iou_thresh), int(phrdet), _ptr(out, ctypes.c_uint8))
    return out
