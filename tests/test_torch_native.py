"""The port's native C++ evaluation kernels against the JAX package's and
against numpy (mirrors ``tests/test_native.py``).

The port builds its own copy of the source into ``build/`` at the repository
root and writes nothing under ``egtr_tpu/``; its ``sg_eval`` takes the native
matcher by default and the numpy loop only when asked by name.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from egtr_tpu import native as jax_native
from egtr_tpu.evaluation import sg_eval as jax_sg
from egtr_tpu_torch import native
from egtr_tpu_torch.evaluation import sg_eval

REPO = Path(__file__).resolve().parents[1]


def random_boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


# what the JAX package's own loader writes beside its source (a test of it
# may run at the same time in another worker)
JAX_OWN = ("native/_bbox_kernels.so", "native/_bbox_kernels.so.tmp")


def _tree(root: Path):
    return {str(p.relative_to(root)): p.stat().st_mtime_ns
            for p in root.rglob("*") if "__pycache__" not in p.parts
            and str(p.relative_to(root)) not in JAX_OWN}


def test_library_builds_under_build_and_nothing_under_egtr_tpu(
        tmp_path, monkeypatch):
    """A fresh build lands in the build directory under its hashed name;
    the JAX package's tree is the same file for file, mtime for mtime."""
    assert native.BUILD_DIR == REPO / "build"
    assert native.library_path().parent == REPO / "build"
    assert native.library_path().name.startswith("libbbox_kernels-")
    before = _tree(REPO / "egtr_tpu")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    path = native.build()
    assert path.parent == tmp_path / "build" and path.exists()
    assert os.listdir(tmp_path / "build") == [path.name]
    assert _tree(REPO / "egtr_tpu") == before
    # the library the evaluator loads is the one built from the port's source
    assert native.get_lib() is not None
    assert native.library_path().exists()


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" void f() { this is not C++; }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build()
    assert os.listdir(tmp_path / "build") == []


def test_bbox_overlaps_matches_jax_native_and_numpy(rng):
    a = random_boxes(rng, 23)
    b = random_boxes(rng, 17)
    # touching, disjoint and identical boxes
    a[:3] = [[0, 0, 9, 9], [0, 0, 9, 9], [50, 50, 60, 60]]
    b[:3] = [[10, 0, 19, 9], [0, 0, 9, 9], [200, 200, 210, 210]]
    ours = native.bbox_overlaps(a, b)
    np.testing.assert_array_equal(ours, sg_eval.bbox_overlaps_plus1(a, b))
    np.testing.assert_allclose(ours, jax_native.bbox_overlaps(a, b),
                               rtol=1e-12)
    assert ours.shape == (23, 17) and ours.dtype == np.float64
    with pytest.raises(ValueError, match="rows of 4"):
        native.bbox_overlaps(np.zeros(6), b)


def _matches_by_loop(gt_trip, gt_boxes, pred_trip, pred_boxes, phrdet):
    """The numpy loop of the port's sg_eval, as a dense matrix."""
    pred_to_gt = sg_eval._compute_pred_matches_plain(
        gt_trip, pred_trip, gt_boxes, pred_boxes, 0.5, phrdet)
    dense = np.zeros((len(gt_trip), len(pred_trip)), np.uint8)
    for p, gs in enumerate(pred_to_gt):
        dense[gs, p] = 1
    return dense


@pytest.mark.parametrize("phrdet", [False, True])
def test_triplet_matches_equals_the_plain_loop(rng, phrdet):
    n_gt, n_pred = 6, 40
    gt_trip = rng.integers(0, 5, (n_gt, 3))
    pred_trip = rng.integers(0, 5, (n_pred, 3))
    # some predictions equal to a gt triplet, their boxes a little off
    pred_trip[:n_gt] = gt_trip
    gt_boxes = np.concatenate(
        [random_boxes(rng, n_gt), random_boxes(rng, n_gt)], 1)
    pred_boxes = np.concatenate(
        [random_boxes(rng, n_pred), random_boxes(rng, n_pred)], 1)
    pred_boxes[:n_gt] = gt_boxes + rng.normal(0, 2, gt_boxes.shape)

    dense = native.triplet_matches(gt_trip, gt_boxes, pred_trip, pred_boxes,
                                   0.5, phrdet)
    assert dense.dtype == np.uint8 and dense.shape == (n_gt, n_pred)
    assert dense.sum() > 0
    np.testing.assert_array_equal(
        dense, _matches_by_loop(gt_trip, gt_boxes, pred_trip, pred_boxes,
                                phrdet))
    np.testing.assert_array_equal(
        dense, jax_native.triplet_matches(gt_trip, gt_boxes, pred_trip,
                                          pred_boxes, 0.5, phrdet))


def test_sg_eval_takes_the_native_path(rng, monkeypatch):
    """The evaluator's matching goes through the native kernel, and gives
    the recalls of the numpy loop and of the JAX evaluator."""
    calls = []
    real = native.triplet_matches

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(native, "triplet_matches", counting)
    gt_rels = np.array([[0, 1, 2], [1, 2, 0], [2, 0, 1]])
    gt_boxes = random_boxes(rng, 3)
    gt_classes = np.array([1, 2, 3])
    pred_rels = np.concatenate([gt_rels, rng.integers(0, 3, (20, 3))])
    pred_boxes = gt_boxes + rng.normal(0, 1, gt_boxes.shape)
    args = (gt_rels, gt_boxes, gt_classes, pred_rels, pred_boxes, gt_classes)
    fast = sg_eval.evaluate_recall(*args)
    assert len(calls) == 1
    with monkeypatch.context() as plain_path:
        plain_path.setattr(sg_eval, "_compute_pred_matches",
                           sg_eval._compute_pred_matches_plain)
        plain = sg_eval.evaluate_recall(*args)
    assert len(calls) == 1
    assert fast == plain == jax_sg.evaluate_recall(*args)
    assert any(fast)

    entry_gt = {"gt_relations": gt_rels, "gt_boxes": gt_boxes,
                "gt_classes": gt_classes}
    entry = {"pred_boxes": pred_boxes, "pred_classes": gt_classes,
             "obj_scores": np.ones(3), "pred_rel_inds": pred_rels,
             "rel_scores": rng.uniform(size=(len(pred_rels), 3))}
    results = []
    for plain_loop, evaluator in (
            (False, sg_eval.SceneGraphEvaluator(multiple_preds=True)),
            (True, sg_eval.SceneGraphEvaluator(multiple_preds=True)),
            (False, jax_sg.SceneGraphEvaluator(multiple_preds=True))):
        with monkeypatch.context() as plain_path:
            if plain_loop:
                plain_path.setattr(sg_eval, "_compute_pred_matches",
                                   sg_eval._compute_pred_matches_plain)
            evaluator.evaluate_entry(entry_gt, entry)
        results.append(evaluator.aggregate())
    assert len(calls) == 2
    assert results[0] == results[1] == results[2]
    assert results[0]["R@20"] > 0
