"""The port's evaluation driver (``egtr_tpu_torch/scripts/evaluate_egtr.py``)
against the JAX package's (``scripts/evaluate_egtr.py``), on the CPU.

One tiny float32 model's weights are made in JAX (noise-filled), saved as a
JAX artifact and carried into a port artifact through ``state_dict_from_jax``.
Both drivers evaluate the same synthetic Visual Genome test split, whose
ground truth is planted from the model's own ranking (triplets at ranks 1,
30 and 75 of each image's graph-constrained list, and one the model never
predicts), so that R@20, R@50 and R@100 each count different triplets. Each
image's top-k triplets are compared first, then the metrics JSON: R@K and
mR@K must be equal.
"""

import json
import os
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egtr_tpu.config import EgtrConfig as JaxConfig
from egtr_tpu.data import loader as jax_loader_mod
from egtr_tpu.evaluation import sg_eval as jax_sg
from egtr_tpu.models.egtr import EgtrModel as JaxEgtrModel
from egtr_tpu.train.checkpoint import save_pretrained as jax_save_pretrained
from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.data import loader as loader_mod
from egtr_tpu_torch.data.loader import Loader
from egtr_tpu_torch.data.visual_genome import VGDataset
from egtr_tpu_torch.evaluation import runner
from egtr_tpu_torch.evaluation import sg_eval
from egtr_tpu_torch.evaluation.postprocess import (rescale_boxes_np,
                                                   sgg_postprocess)
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.scripts import evaluate_egtr
from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg
from egtr_tpu_torch.train.checkpoint import save_pretrained
from egtr_tpu_torch.utils.convert import state_dict_from_jax
from chip_smoke import recorded_entries
from test_torch_model import TINY, jax_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
HW = (64, 96)
BUCKETS = ((64, 96), (96, 96))
# the synthetic set's 6 classes and 4 predicates
CFG = dict(TINY, num_labels=6, num_rel_labels=4, max_gt_boxes=8)
N_TEST = 4
PLANTED_RANKS = (1, 30, 75)
ARGS = ["--min_size", str(HW[0]), "--max_size", str(HW[1]),
        "--compute_dtype", "float32"]


def _jax_driver():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import evaluate_egtr as jax_evaluate_egtr
    finally:
        sys.path.pop(0)
    return jax_evaluate_egtr


def _plant_ground_truth(data, model, cfg):
    """Rewrite the test split's objects and relations from the model's own
    graph-constrained ranking of each image."""
    ds = VGDataset(data, "test", size=HW[0], max_size=HW[1])
    loader = Loader(ds, 1, shuffle=False, max_gt=cfg.max_gt_boxes,
                    num_rel_labels=cfg.num_rel_labels)
    with open(os.path.join(data, "test.json")) as f:
        coco = json.load(f)
    with open(os.path.join(data, "rel.json")) as f:
        rel = json.load(f)
    annotations, rel["test"] = [], {}
    for batch in loader:
        with torch.no_grad():
            out = model(torch.from_numpy(batch["pixel_values"]),
                        torch.from_numpy(batch["pixel_mask"]))
            post = sgg_postprocess(
                out["logits"], out["pred_boxes"], out["pred_rel"],
                out["pred_connectivity"], num_labels=cfg.num_labels,
                top_k=100)
        image_id = int(batch["image_id"][0])
        boxes = rescale_boxes_np(post["pred_boxes"][0].numpy(),
                                 batch["orig_size"][0])
        classes = post["pred_classes"][0].numpy()
        pairs = post["single_inds"][0].numpy()
        preds = post["single_rel_vec"][0].numpy().argmax(1)
        triplets = [(*pairs[r], preds[r]) for r in PLANTED_RANKS]
        # the rank-0 pair under a predicate the model does not rank first
        triplets.append((*pairs[0], (preds[0] + 1) % cfg.num_rel_labels))
        objects = sorted({q for s, o, _ in triplets for q in (s, o)})
        for q in objects:
            x1, y1, x2, y2 = (float(v) for v in boxes[q])
            annotations.append({
                "id": len(annotations) + 1, "image_id": image_id,
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "category_id": int(classes[q]) + 1, "area": 1.0,
                "iscrowd": 0})
        rel["test"][str(image_id)] = [
            [objects.index(s), objects.index(o), int(p) + 1]
            for s, o, p in triplets]
    coco["annotations"] = annotations
    with open(os.path.join(data, "test.json"), "w") as f:
        json.dump(coco, f)
    with open(os.path.join(data, "rel.json"), "w") as f:
        json.dump(rel, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers over the planted split: (their prediction entries, their
    metrics JSON, the paths)."""
    root = tmp_path_factory.mktemp("evaluate")
    data = str(root / "vg")
    make_synth_vg(data, n_train=1, n_val=1, n_test=N_TEST, height=HW[0],
                  width=HW[1], seed=0)
    jcfg, cfg = JaxConfig(**CFG), EgtrConfig(**CFG)
    params = jax_params(JaxEgtrModel(jcfg), 11,
                        jnp.zeros((1, *HW, 3), jnp.float32))
    jax_art, port_art = root / "jax" / "artifact", root / "port" / "artifact"
    jax_save_pretrained(str(jax_art), jcfg, params)
    state_dict = state_dict_from_jax(params, cfg)
    save_pretrained(str(port_art), cfg, state_dict)
    model = EgtrModel(cfg)
    model.load_state_dict(state_dict, strict=True)
    _plant_ground_truth(data, model.eval(), cfg)

    mp = pytest.MonkeyPatch()
    entries = {}
    try:
        for mod in (loader_mod, jax_loader_mod):
            mp.setattr(mod, "default_buckets", lambda max_size=1333: BUCKETS)
        mp.setattr(sys, "argv", ["evaluate_egtr.py", "--data_path", data,
                                 "--artifact_path", str(jax_art), *ARGS])
        with recorded_entries(jax_sg.SceneGraphEvaluator) as entries["jax"]:
            _jax_driver().main()
        with recorded_entries(sg_eval.SceneGraphEvaluator) as entries["port"]:
            returned = evaluate_egtr.main([
                "--data_path", data, "--artifact_path", str(port_art),
                "--device", "cpu", *ARGS])
    finally:
        mp.undo()
    metrics = {}
    for name in ("jax", "port"):
        with open(root / name / "metrics_test.json") as f:
            metrics[name] = json.load(f)
    return types.SimpleNamespace(entries=entries, metrics=metrics,
                                 returned=returned, data=data,
                                 port_art=str(port_art))


def test_top_k_triplets_match_jax(runs):
    jax_entries, port_entries = runs.entries["jax"], runs.entries["port"]
    assert len(jax_entries) == len(port_entries) == N_TEST
    for ours, ref in zip(port_entries, jax_entries):
        np.testing.assert_array_equal(ours["pred_classes"],
                                      np.asarray(ref["pred_classes"]))
        # the ranked pairs, their predicate scores and boxes in pixels
        np.testing.assert_array_equal(ours["pred_rel_inds"],
                                      np.asarray(ref["pred_rel_inds"]))
        np.testing.assert_allclose(ours["rel_scores"],
                                   np.asarray(ref["rel_scores"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ours["pred_boxes"],
                                   np.asarray(ref["pred_boxes"]),
                                   rtol=1e-4, atol=1e-3)


def test_metrics_match_jax(runs):
    keys = [f"single/{m}@{k}" for m in ("R", "mR") for k in (20, 50, 100)]
    ours, ref = runs.metrics["port"], runs.metrics["jax"]
    assert {k: ours[k] for k in keys} == {k: ref[k] for k in keys}
    assert {k: runs.returned[k] for k in keys} == {k: ours[k] for k in keys}
    # the planted ranks: at least one triplet of four within 20 (another
    # pair of the same classes and boxes may match too), more within 50,
    # never the fourth
    assert 0 < ours["single/R@20"] < ours["single/R@50"] <= ours[
        "single/R@100"] < 1
    assert 0 < ours["single/mR@20"] < ours["single/mR@100"] < 1
    assert ours["args"]["device"] == "cpu"


def test_run_fps_on_the_cpu(runs, monkeypatch):
    monkeypatch.setattr(loader_mod, "default_buckets",
                        lambda max_size=1333: BUCKETS)
    result = evaluate_egtr.main([
        "--data_path", runs.data, "--artifact_path", runs.port_art,
        "--device", "cpu", "--infer_only", "true", *ARGS])
    for key in ("fps", "strict_sync_fps", "chained_ms_per_image",
                "device_ms_per_image", "host_rtt_ms"):
        assert np.isfinite(result[key]) and result[key] > 0, key
    # on the CPU the device is the host: its busy time is the chained time
    assert result["device_ms_per_image"] == result["chained_ms_per_image"]
    assert result["device_idle_share"] == 0.0
    assert result["images"] == N_TEST
    assert (result["device"], result["timer"]) == ("cpu", "host_clock")
    assert "tunnel_rtt_ms" in result["host_rtt_note"]


def _batches(n, bsz=1):
    return [{"pixel_values": np.zeros((bsz, 8, 8, 3), np.float32),
             "pixel_mask": np.ones((bsz, 8, 8), bool)} for _ in range(n)]


def _fake_infer(pv, pm):
    return pv.sum() * torch.ones((pv.shape[0], 4), dtype=torch.int64)


def test_run_fps_counts_images():
    """A single batch is enough (warm-up and decomposition reuse it),
    max_images cuts the loop, an empty loader raises."""
    one = evaluate_egtr.run_fps(_fake_infer, _batches(1), "cpu",
                                decomp_iters=2)
    assert one["images"] == 1
    cut = evaluate_egtr.run_fps(_fake_infer, _batches(10, bsz=2), "cpu",
                                max_images=6, decomp_iters=2)
    assert cut["images"] == 6 and cut["fps"] > 0
    with pytest.raises(SystemExit, match="no batches"):
        evaluate_egtr.run_fps(_fake_infer, [], "cpu", decomp_iters=1)


def test_overrides_reach_the_config(runs, monkeypatch):
    seen = []

    def fake_evaluate_sgg(model, cfg, *args, **kw):
        seen.append((model, cfg))
        return {}

    monkeypatch.setattr(runner, "evaluate_sgg", fake_evaluate_sgg)
    base = ["--data_path", runs.data, "--artifact_path", runs.port_art,
            "--device", "cpu", *ARGS]
    evaluate_egtr.main(base)
    evaluate_egtr.main(base + ["--msda_window", "16", "--msda_band", "point",
                               "--msda_int8", "true", "--logit_adjustment",
                               "true"])
    (model0, cfg0), (model1, cfg1) = seen
    assert (cfg0.msda_window, cfg0.msda_band, cfg0.msda_int8) == (
        0, "tile", False)
    assert (cfg1.msda_window, cfg1.msda_band, cfg1.msda_int8) == (
        16, "point", True)
    assert cfg1.logit_adjustment and not cfg0.logit_adjustment
    assert cfg0.dropout == cfg1.dropout == 0.0
    assert model1.config == cfg1 and not model1.training
    # the weights are the artifact's
    for a, b in zip(model0.state_dict().values(),
                    model1.state_dict().values()):
        assert torch.equal(a, b)


def test_refusals(runs, monkeypatch):
    base = ["--data_path", runs.data, "--artifact_path", runs.port_art]
    with pytest.raises(NotImplementedError, match="open_images"):
        evaluate_egtr.main(base + ["--device", "cpu", "--dataset",
                                   "open_images"])
    # the card by default: no silent CPU path
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_egtr.main(base)
