"""Open Images V6 in the port against the JAX package, on the CPU.

- ``OIDataset`` against JAX's, sample for sample (pixels, boxes, labels,
  relations and the size bounds), the train split's filters and its
  ``filter_multiple_rels`` draws included; ``oi_get_statistics`` equal.
  The fixture mirrors ``tests/test_data_oi.py``'s.
- ``OIEvaluator`` against JAX's on the same recorded entries, the cases of
  ``tests/test_eval.py`` (end to end, the +1-pixel box widening, the top-k
  fast path, a protocol-sized Q with fewer images): every metric to 1e-12
  (the native IoU's accepted delta), the per-image state equal, and
  ``merge_state`` of two halves equal to one evaluator.
- The three drivers with ``--dataset open_images`` at a tiny width:
  ``train_egtr`` then ``evaluate_egtr`` on its artifact, whose ``oi/*``
  metrics must be the training driver's, and ``pretrain_detr``.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from egtr_tpu.data.open_images import OIDataset as JaxOIDataset
from egtr_tpu.data.open_images import oi_get_statistics as jax_statistics
from egtr_tpu.evaluation.oi_eval import OIEvaluator as JaxOIEvaluator
from egtr_tpu_torch.data import open_images as oi_mod
from egtr_tpu_torch.data.open_images import OIDataset, oi_get_statistics
from egtr_tpu_torch.evaluation.oi_eval import OIEvaluator
from chip_smoke import write_synth_oi

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def free_disk(tmp_path):
    """A test's checkpoints and artifacts hold a ResNet-50 backbone's
    weights (and moments), hundreds of MB: remove them after it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def oi_dir(tmp_path_factory):
    """tests/test_data_oi.py's set (a repeated triple, a second predicate on
    one pair), plus an image with more boxes than the queries the train
    split keeps and a test split."""
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("oi")
    (d / "images").mkdir()
    (d / "annotations").mkdir()
    annos = []
    for i in range(6):
        fn = f"im{i}"
        Image.fromarray(rng.integers(0, 255, (120, 160, 3), dtype=np.uint8),
                        "RGB").save(d / "images" / f"{fn}.jpg")
        annos.append({
            "img_fn": fn,
            "bbox": [[10, 10, 40, 50], [60, 20, 100, 80], [5, 5, 20, 20]],
            "det_labels": [0, 1, 2],
            "rel": [[0, 1, 1], [0, 1, 1], [0, 1, 2], [1, 2, 0]],
        })
    annos[5]["bbox"].append([30, 30, 90, 100])
    annos[5]["det_labels"].append(1)
    for split, part in (("train", annos), ("val", annos[:2]),
                        ("test", annos[2:5])):
        with open(d / "annotations" / f"vrd-{split}-anno.json", "w") as f:
            json.dump(part, f)
    with open(d / "annotations" / "categories_dict.json", "w") as f:
        json.dump({"obj": ["a", "b", "c"], "rel": ["r0", "r1", "r2"]}, f)
    return str(d)


DATASETS = {
    # the train split: augmentation, 3 queries (image 5 dropped), repeated
    # triples dropped, one predicate drawn per pair
    "train": dict(split="train", train_aug=True, filter_multiple_rels=True,
                  num_object_queries=3, seed=7),
    "train_all_rels": dict(split="train", filter_duplicate_rels=False),
    "val": dict(split="val"),
}


@pytest.mark.parametrize("case", sorted(DATASETS))
def test_oi_dataset_matches_jax(oi_dir, case):
    kw = dict(DATASETS[case])
    split = kw.pop("split")
    ours = OIDataset(oi_dir, split, size=128, max_size=256, **kw)
    theirs = JaxOIDataset(oi_dir, split, size=128, max_size=256, **kw)
    assert len(ours) == len(theirs) and ours.num_classes() == 3
    assert ours.targets == theirs.targets
    np.testing.assert_array_equal(oi_get_statistics(ours),
                                  jax_statistics(theirs))
    ours.precache_sizes()
    for i in range(len(ours)):
        assert ours.nominal_size(i) == theirs.nominal_size(i)
        a, b = ours[i], theirs[i]
        for field in ("image", "boxes", "class_labels", "rel"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field), err_msg=field)
        assert (a.orig_size, a.size, a.image_id) == (b.orig_size, b.size,
                                                     b.image_id)
    if case == "train":
        assert len(ours) == 5
        # one predicate per (subject, object) pair, drawn in item order
        assert all(len({tuple(r[:2]) for r in ours[i].rel})
                   == len(ours[i].rel) for i in range(len(ours)))


def _entries(rng, n_images, Q, R, C, n_gt=4, n_rel=3):
    out = []
    so = np.indices((Q, Q)).reshape(2, -1).T
    for _ in range(n_images):
        boxes = rng.uniform(0, 300, (Q, 4))
        boxes[:, 2:] = boxes[:, :2] + rng.uniform(20, 80, (Q, 2))
        classes = rng.integers(0, C, Q)
        gt_rel = np.stack([rng.integers(0, n_gt, n_rel),
                           rng.integers(0, n_gt, n_rel),
                           rng.integers(0, R, n_rel)], 1)
        out.append((
            {"gt_boxes": boxes[:n_gt], "gt_classes": classes[:n_gt],
             "gt_relations": gt_rel},
            {"pred_boxes": boxes, "pred_classes": classes,
             "obj_scores": rng.uniform(0.3, 1, Q), "sbj_obj_inds": so,
             "pred_scores": rng.uniform(0, 1, (Q * Q, R))}))
    return out


def _widening_entry():
    """tests/test_eval.py's +1-pixel case: IoU 0.474 clean, 0.500 widened."""
    return [({"gt_boxes": np.array([[0.0, 0.0, 9.0, 10.0]]),
              "gt_classes": np.array([1]),
              "gt_relations": np.array([[0, 0, 0]])},
             {"pred_boxes": np.array([[0.0, 0.0, 19.0, 10.0],
                                      [100.0, 100.0, 120.0, 120.0]]),
              "pred_classes": np.array([1, 0]),
              "obj_scores": np.array([0.9, 0.1]),
              "sbj_obj_inds": np.indices((2, 2)).reshape(2, -1).T,
              "pred_scores": np.full((4, 1), 0.5)})]


EVALUATIONS = {
    # (R, C, entries)
    "end_to_end": (4, 5, lambda rng: _entries(rng, 1, 6, 4, 5, 3, 2)),
    "plus1_widening": (1, 2, lambda rng: _widening_entry()),
    "topk_fast_path": (6, 7, lambda rng: _entries(rng, 5, 40, 6, 7)),
    # the protocol's Q and R, fewer images than tests/test_eval.py's 300
    "protocol_q": (30, 10, lambda rng: _entries(rng, 6, 200, 30, 10, 5, 8)),
}


@pytest.mark.parametrize("case", sorted(EVALUATIONS))
def test_oi_evaluator_matches_jax(case):
    R, C, make = EVALUATIONS[case]
    entries = make(np.random.default_rng(3))
    rels, classes = [f"r{i}" for i in range(R)], [f"c{i}" for i in range(C)]
    ours, theirs = OIEvaluator(rels, classes), JaxOIEvaluator(rels, classes)
    halves = OIEvaluator(rels, classes), OIEvaluator(rels, classes)
    for i, (gt, pred) in enumerate(entries):
        ours(gt, pred)
        theirs(gt, pred)
        halves[i % 2](gt, pred)
    for a, b in zip(ours.state(), theirs.state()):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert len(a["det_scores_top"]) <= ours.topk
        assert "pred_scores" not in a
    got, want = ours.aggregate_metrics(), theirs.aggregate_metrics()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
    assert np.isfinite(got["score"])
    if case == "plus1_widening":
        assert got["bbox/AP50"] == 1.0 and got["bbox/AP"] < 1.0
    if case == "end_to_end":
        assert got["microR@50"] > 0
    # merge_state: two evaluators' states merged equal one evaluator's
    # entries in the merged order
    merged = OIEvaluator(rels, classes)
    merged.merge_state(halves[0].state())
    merged.merge_state(halves[1].state())
    order = OIEvaluator(rels, classes)
    for gt, pred in entries[0::2] + entries[1::2]:
        order(gt, pred)
    assert merged.aggregate_metrics() == order.aggregate_metrics()


@pytest.fixture
def tiny_oi(monkeypatch):
    """The drivers at a tiny width on small images: 1+1 layers of d_model
    64, 12 queries, DETR scales of 48 rows, test images resized to 48."""
    from egtr_tpu_torch import config as config_mod
    from egtr_tpu_torch.data import loader as loader_mod
    from egtr_tpu_torch.data import transforms as transforms_mod

    real_cfg, real_ds = config_mod.EgtrConfig, oi_mod.OIDataset

    class SmallOI(real_ds):
        def __init__(self, *a, size=800, max_size=1333, **kw):
            super().__init__(*a, size=48, max_size=80, **kw)

    class TinyConfig(real_cfg):
        def __init__(self, **kw):
            super().__init__(**{**kw, **dict(
                d_model=64, encoder_layers=1, decoder_layers=1,
                encoder_ffn_dim=64, decoder_ffn_dim=64,
                compute_dtype="float32")})

    monkeypatch.setattr(config_mod, "EgtrConfig", TinyConfig)
    monkeypatch.setattr(oi_mod, "OIDataset", SmallOI)
    monkeypatch.setattr(transforms_mod, "DETR_TRAIN_SCALES", (48,))
    monkeypatch.setattr(loader_mod, "default_buckets",
                        lambda max_size=1333: ((48, 80), (80, 48), (80, 80)))


def test_oi_drivers_end_to_end_on_cpu(tmp_path, tiny_oi):
    """train_egtr, evaluate_egtr on its artifact and pretrain_detr with
    ``--dataset open_images``: the labels of the set (601 and 30), finite
    losses, the ``oi/*`` test metrics equal between the two SGG drivers,
    the detector's COCO metrics."""
    from egtr_tpu_torch.scripts import evaluate_egtr, pretrain_detr, train_egtr

    data, out = str(tmp_path / "oi"), str(tmp_path / "run")
    write_synth_oi(data, n_train=2, n_val=1, n_test=2, height=48, width=80)
    common = ["--dataset", "open_images", "--data_path", data, "--device",
              "cpu", "--batch_size", "1", "--accumulate", "2",
              "--max_epochs", "1", "--max_epochs_finetune", "1",
              "--num_workers", "1", "--num_queries", "12",
              "--max_gt_boxes", "8", "--seed", "0"]
    model = train_egtr.main(common + ["--output_path", out, "--from_scratch",
                                      "true", "--max_gt_rels", "16"])
    assert (model.config.num_labels, model.config.num_rel_labels) == (601, 30)
    with open(os.path.join(out, "metrics_test.json")) as f:
        trained = json.load(f)
    oi = {k: v for k, v in trained.items() if k.startswith("oi/")}
    assert {"oi/score", "oi/w_rel_mAP", "oi/w_phr_mAP", "oi/microR@50",
            "oi/bbox/AP"} <= set(oi)
    assert all(np.isfinite(v) for v in oi.values())
    assert not any(k.startswith("coco/") for k in trained)
    evaluated = evaluate_egtr.main([
        "--dataset", "open_images", "--data_path", data, "--device", "cpu",
        "--artifact_path", os.path.join(out, "artifact"),
        "--compute_dtype", "float32"])
    assert {k: evaluated[k] for k in oi} == oi
    detector = pretrain_detr.main(common + ["--output_path",
                                            str(tmp_path / "pre")])
    assert detector.config.num_labels == 601
    with open(tmp_path / "pre" / "metrics_test.json") as f:
        detected = json.load(f)
    assert detected and all(k.startswith("coco/") and np.isfinite(v)
                            for k, v in detected.items())
