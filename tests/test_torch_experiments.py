"""The port's trained-offsets experiment (``egtr_tpu_torch/scripts/
exp_trained_offsets.py``) and window-deltas script against the JAX
package's (``scripts/exp_trained_offsets.py``,
``scripts/exp_window_deltas_cpu.py``), on the CPU at a tiny width.

- ``build``: the same config, field for field.
- ``_clamp_fracs`` on the same numpy offsets and weights: within 1e-6;
  the same fractions when the bands' weighted means are summed in another
  order.
- ``_offset_stats`` on noise-filled JAX params bridged into the port: the
  percentiles within 1e-5 relative (float32 forwards that differ in
  summation order), the fractions within 1e-3 (a sample within round-off
  of a band edge or a half-band may fall on the other side).
- ``sweep`` on a test split whose ground truth is planted from the exact
  model's ranking: R@K and mR@K equal to JAX's ``cmd_sweep`` for the exact
  and a windowed variant, the outputs' deltas to the exact path within
  1e-4; the token grammar and keys; the incremental skip.
- ``train``: the resume and ``--init_from`` refusals name the fields JAX's
  name; the state directory keeps the steps orbax keeps for the script's
  save pattern; a 3-step run with the clock patched writes the run header,
  the artifact and the state, and ``--resume`` continues its step count.
- The window-deltas report on bridged float32 params: within 1e-4 of the
  JAX script's deltas (its ``run`` per variant, jitted once each).

The JAX side runs its windowed configurations through its matmul oracle,
what ``msda_impl="auto"`` takes on the CPU (tests/test_torch_window.py holds
it to the Pallas kernels).
"""

import json
import os
import shutil
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egtr_tpu.config import EgtrConfig as JaxConfig
from egtr_tpu.models.egtr import EgtrModel as JaxEgtrModel
from egtr_tpu.train import checkpoint as jax_checkpoint
from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.data.loader import Loader
from egtr_tpu_torch.data.visual_genome import VGDataset
from egtr_tpu_torch.evaluation.postprocess import (rescale_boxes_np,
                                                   sgg_postprocess)
from egtr_tpu_torch.models.detr import level_shapes
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.scripts import exp_trained_offsets as exp
from egtr_tpu_torch.scripts import exp_window_deltas
from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg
from egtr_tpu_torch.train import checkpoint
from egtr_tpu_torch.train.checkpoint import save_pretrained
from egtr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_model import TINY, jax_apply, jax_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# landscape images the resize keeps: one (96, 144) bucket, levels of 12, 6,
# 3 and 2 rows, so a window of 8 bands level 0
HW = (96, 144)
SIZE_ARGS = ["--size", str(HW[0]), "--max_size", str(HW[1])]
# the synthetic set's 6 classes and 4 predicates, float32
CFG = dict(TINY, num_labels=6, num_rel_labels=4, max_gt_boxes=16,
           max_gt_rels=64)
PLANTED_RANKS = (1, 30, 75)
CLAMP_ATOL = 1e-6
PERCENTILE_RTOL = 1e-5
FRACTION_ATOL = 1e-3
DELTA_ATOL = 1e-4


@pytest.fixture(autouse=True)
def free_disk(tmp_path):
    """A test's checkpoints and artifacts hold a ResNet-50 backbone's
    weights (and moments), hundreds of MB: remove them after it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax_script(name):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(scope="module")
def jax_exp():
    return _jax_script("exp_trained_offsets")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("exp") / "vg")
    make_synth_vg(path, n_train=2, n_val=1, n_test=3, height=HW[0],
                  width=HW[1], seed=0)
    return path


def _args(cmd, data, out, *extra):
    return exp.parse_args([cmd, "--data_path", data, "--out", str(out),
                           *SIZE_ARGS, "--device", "cpu", *extra])


# --------------------------------------------------------------------------
# build, the refusals, retention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--tiny"], [], ["--window", "16", "--band", "point"]])
def test_build_config_matches_jax(jax_exp, data, tmp_path, extra):
    args = _args("train", data, tmp_path, "--batch", "1", *extra)
    cfg, model, loader, fg, _ = exp.build(args)
    jcfg, _, jloader, jfg, _ = jax_exp.build(args)
    assert cfg.to_json() == jcfg.to_json()
    assert loader.buckets == jloader.buckets == ((96, 144),)
    np.testing.assert_array_equal(fg, jfg)
    assert isinstance(model, EgtrModel)


def _refusal(fn, args):
    with pytest.raises(SystemExit) as e:
        fn(args)
    return str(e.value)


def test_resume_refusal_names_the_fields_jax_names(jax_exp, data,
                                                   tmp_path):
    """A resume whose flags would build another config is refused, naming
    the same fields in both packages."""
    cfg, *_ = exp.build(_args("train", data, tmp_path, "--tiny"))
    os.makedirs(tmp_path / "artifact")
    cfg.save(str(tmp_path / "artifact" / "config.json"))
    args = _args("train", data, tmp_path, "--tiny", "--resume", "--window",
                 "8", "--band", "point")
    ours = _refusal(exp.cmd_train, args)
    assert ours == _refusal(jax_exp.cmd_train, args)
    assert "['msda_window', 'msda_band']" in ours
    # flags that build the same config resume (here: no state to resume)
    args = _args("train", data, tmp_path, "--tiny", "--resume")
    assert _refusal(exp.cmd_train, args) == (
        f"--resume: no state checkpoint under {tmp_path}/state")


def test_init_from_refusal_names_the_fields_jax_names(jax_exp, data,
                                                      tmp_path, monkeypatch):
    """An adaptation run may change the msda_* fields only; the artifact's
    other differing fields are named."""
    cfg, model, *_ = exp.build(_args("train", data, tmp_path, "--tiny"))
    drifted = cfg.replace(num_queries=8, dropout=0.2, msda_window=8)
    art = tmp_path / "init"
    save_pretrained(str(art), drifted, model.state_dict())
    # the JAX side reads the artifact's config; its weights are not reached
    monkeypatch.setattr(jax_checkpoint, "load_pretrained", lambda d: (
        JaxConfig.load(os.path.join(d, "config.json")), None))
    args = _args("train", data, tmp_path / "out", "--tiny", "--init_from",
                 str(art))
    ours = _refusal(exp.cmd_train, args)
    assert ours == _refusal(jax_exp.cmd_train, args)
    assert "['num_queries', 'dropout']" in ours


@pytest.mark.parametrize("steps,ckpt_every", [(7, 2), (6, 3), (5, 500)])
def test_state_retention_matches_orbax(tmp_path, steps, ckpt_every):
    """The script's saves, with no metrics, into managers keeping 2: every
    ``ckpt_every`` steps, then the final step unless it was just saved."""
    ref = jax_checkpoint.CheckpointManager(str(tmp_path / "orbax"),
                                           max_to_keep=2)
    ours = checkpoint.CheckpointManager(str(tmp_path / "port"),
                                        max_to_keep=2)
    saves = [s for s in range(1, steps + 1) if s % ckpt_every == 0]
    if not saves or saves[-1] != steps:
        saves.append(steps)
    for s in saves:
        ref.save(s, {"x": np.full((2,), s, np.float32)}, force=True)
        ours.save(s, {"x": torch.full((2,), float(s))})
        assert ours.all_steps() == sorted(ref._mngr.all_steps())
        assert ours.latest_step() == ref.latest_step() == s
    assert len(ours.all_steps()) == min(2, len(saves))


# --------------------------------------------------------------------------
# train, resume, adapt, offsets on the CPU
# --------------------------------------------------------------------------

class FakeClock:
    """``time`` for the script: ``time()`` one second later at each call."""

    def __init__(self):
        self.now = 0.0

    def time(self):
        self.now += 1.0
        return self.now

    strftime = staticmethod(__import__("time").strftime)
    gmtime = staticmethod(__import__("time").gmtime)


def _log(out):
    with open(os.path.join(out, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_resume_adapt_and_offsets_on_cpu(jax_exp, data, tmp_path,
                                               monkeypatch):
    """3 steps over two epochs of 2 images (one second a clock call: the
    first step starts the clock, each step and each later epoch reads it
    once), a resume of 2 more, an adaptation run under window 8 with one
    band per point, and the offsets of its artifact."""
    monkeypatch.setattr(exp, "time", FakeClock())
    out = tmp_path / "exact"
    common = ["--tiny", "--batch", "1", "--ckpt_every", "2"]
    result = exp.main(["train", "--data_path", data, "--out", str(out),
                       *SIZE_ARGS, "--device", "cpu", "--train_seconds", "4",
                       *common])
    assert (result["start_step"], result["step"]) == (0, 3)
    assert len(result["losses"]) == 3 and all(map(np.isfinite,
                                                  result["losses"]))
    header, = _log(out)
    assert header["run_header"] and header["start_step"] == 0
    assert not header["resume"] and header["args"]["device"] == "cpu"
    assert sorted(os.listdir(out / "artifact")) == ["config.json",
                                                    "weights.pt"]
    mngr = checkpoint.CheckpointManager(str(out / "state"), max_to_keep=2)
    assert mngr.all_steps() == [2, 3]
    payload = mngr.restore()
    assert payload["loop"]["step"] == 3
    adam = [s["step"] for s in payload["optimizer"].values()]
    assert adam and all(float(s) == 3 for s in adam)

    monkeypatch.setattr(exp, "time", FakeClock())
    exp.main(["train", "--data_path", data, "--out", str(out), *SIZE_ARGS,
              "--device", "cpu", "--train_seconds", "2", "--resume",
              *common])
    headers = [r for r in _log(out) if r.get("run_header")]
    assert [(h["resume"], h["start_step"]) for h in headers] == [
        (False, 0), (True, 3)]
    assert mngr.all_steps() == [4, 5]
    payload = mngr.restore()
    assert payload["loop"]["step"] == 5
    assert all(float(s["step"]) == 5 for s in payload["optimizer"].values())

    monkeypatch.setattr(exp, "time", FakeClock())
    adapt = tmp_path / "adapt"
    exp.main(["train", "--data_path", data, "--out", str(adapt),
              *SIZE_ARGS, "--device", "cpu", "--train_seconds", "1",
              "--init_from", str(out / "artifact"), "--window", "8",
              "--band", "point", *common])
    cfg = EgtrConfig.load(str(adapt / "artifact" / "config.json"))
    assert (cfg.msda_window, cfg.msda_band) == (8, "point")
    # fresh moments: the adaptation's state counts its own steps
    assert checkpoint.CheckpointManager(str(adapt / "state")).all_steps(
        ) == [1]

    result = exp.main(["offsets", "--data_path", data, "--out", str(adapt),
                       *SIZE_ARGS, "--device", "cpu"])
    with open(adapt / "offset_stats.json") as f:
        stats = json.load(f)
    assert stats == result["stats"]
    # the offsets and weights the statistics were drawn from, per layer
    assert len(result["offsets"]) == len(result["weights"]) == 2
    assert tuple(result["offsets"][0].shape[2:]) == (8, 4, 4, 2)
    assert stats["clamp_frac_win8_point"] > 0
    assert stats["clamp_frac_win16_tile"] == 0.0  # no level taller than 16
    assert all(np.isfinite(v) for v in stats.values())


# --------------------------------------------------------------------------
# clamp fractions and offset statistics against JAX
# --------------------------------------------------------------------------

def test_clamp_fracs_match_jax(jax_exp):
    """Two layers of raster queries over levels taller than every window,
    offsets of a few to tens of pixels."""
    rng = np.random.default_rng(5)
    shapes = ((40, 24), (20, 12), (10, 6), (5, 3))
    Q = sum(h * w for h, w in shapes)
    B, H, L, P = 1, 2, 4, 4
    offs, aws = [], []
    for scale in (3.0, 12.0):
        offs.append((scale * rng.standard_normal((B, Q, H, L, P, 2))
                     ).astype(np.float32))
        logits = rng.standard_normal((B, Q, H, L * P))
        aw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        aws.append(aw.reshape(B, Q, H, L, P).astype(np.float32))
    ref = jax_exp._clamp_fracs(offs, aws, shapes, 32)
    ours = exp._clamp_fracs(offs, aws, shapes, 32)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert abs(ours[key] - ref[key]) <= CLAMP_ATOL, key
    assert ours["clamp_frac_win8_tile"] > ours["clamp_frac_win32_tile"] > 0


def test_clamp_fracs_do_not_depend_on_the_summation_order(monkeypatch):
    """The tile band's weighted mean is a sum whose order a device picks:
    summed in another order (each tile's queries reversed), the clamp
    fractions stay the same. A 40x32 level, tiles of four rows whose
    samples sit two rows outside them, weights symmetric about the tile's
    centre and one nudged up by 2^-20: every tile's mean lies within
    float32 round-off of a tie between two bands that clamp different
    samples."""
    from egtr_tpu_torch.ops import msda_window

    h, w = 40, 32
    y = np.arange(h * w) // w
    rng = np.random.default_rng(3)
    off = np.zeros((1, h * w, 1, 1, 1, 2), np.float32)
    off[0, :, 0, 0, 0, 1] = np.where(y % 4 < 2, -2.0, 2.0)
    u = rng.uniform(0.5, 1.0, (h // 4, 2, w)).astype(np.float32)
    aw = np.concatenate([u[:, 0], u[:, 1], u[:, 1], u[:, 0]], 1)
    aw[:, 3 * w] *= np.float32(1 + 2.0 ** -20)
    aw = aw.reshape(1, h * w, 1, 1, 1)
    ours = exp._clamp_fracs([off], [aw], ((h, w),), 32)
    real = msda_window.window_rows

    def reversed_tiles(iy, aw, h, win, TQ, per_point=False):
        B, H, P, Qp = iy.shape

        def flip(t):
            return t.reshape(*t.shape[:-1], Qp // TQ, TQ).flip(-1).reshape(
                t.shape)

        bidx, *rest = real(flip(iy), flip(aw), h, win, TQ, per_point)
        return (bidx, *[flip(t.expand(B, H, P, Qp)) for t in rest])

    monkeypatch.setattr(msda_window, "window_rows", reversed_tiles)
    assert exp._clamp_fracs([off], [aw], ((h, w),), 32) == ours
    assert ours["clamp_frac_win8_tile"] > 0


class _JittedApply:
    """A flax module whose ``apply`` is jitted once with its keywords
    (``_offset_stats`` calls it eagerly: a compile per op)."""

    def __init__(self, module):
        self.module = module

    def apply(self, params, *args, **kw):
        return jax.jit(lambda p, *a: self.module.apply(p, *a, **kw))(
            jax.tree_util.tree_map(jnp.asarray, params), *args)


def test_offset_stats_match_jax(jax_exp):
    """A 160x256 image: levels of 20, 10, 5 and 4 rows, so windows of 8 and
    16 band some."""
    cfg = EgtrConfig(**CFG)
    jcfg = JaxConfig(**CFG, msda_impl="gather")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 160, 256, 3)).astype(np.float32)
    batch = {"pixel_values": x, "pixel_mask": np.ones(x.shape[:3], bool)}
    jm = JaxEgtrModel(jcfg)
    params = jax_params(jm, 4, jnp.asarray(x))
    ref = jax_exp._offset_stats(_JittedApply(jm), jcfg, params, batch)
    model = EgtrModel(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    offs, aws = exp.encoder_sampling(model, cfg, batch, torch.device("cpu"))
    ours = exp._offset_stats(offs, aws, level_shapes(x.shape[1:3],
                                                   cfg.num_feature_levels),
                             cfg.d_model // cfg.encoder_attention_heads)
    assert list(ours) == list(ref)
    for key in ref:
        if "within" in key or "clamp" in key:
            assert abs(ours[key] - ref[key]) <= FRACTION_ATOL, key
        else:
            np.testing.assert_allclose(ours[key], ref[key],
                                       rtol=PERCENTILE_RTOL, err_msg=key)
    assert ref["clamp_frac_win16_point"] > 0


# --------------------------------------------------------------------------
# the sweep
# --------------------------------------------------------------------------

def test_token_grammar_and_keys():
    variants = exp.parse_windows("0,16, 16p,16pi,8p,", int8=True)
    assert variants == [(0, "tile", False), (16, "tile", False),
                        (16, "point", False), (16, "point", True),
                        (8, "point", False), (0, "tile", True),
                        (16, "tile", True)]
    assert [exp.variant_key(*v) for v in variants] == [
        "win0", "win16", "win16_pp", "win16_pp_int8", "win8_pp",
        "win0_int8", "win16_int8"]


def _plant_ground_truth(data, model, cfg):
    """Rewrite the test split's objects and relations from the model's own
    graph-constrained ranking of each image (PLANTED_RANKS), plus the
    rank-0 pair under a predicate the model does not rank first."""
    ds = VGDataset(data, "test", size=HW[0], max_size=HW[1])
    loader = Loader(ds, 1, shuffle=False, max_gt=cfg.max_gt_boxes,
                    num_rel_labels=cfg.num_rel_labels, buckets=(HW,))
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
def sweeps(jax_exp, tmp_path_factory):
    """Both packages' ``cmd_sweep`` over ``--windows 0,8p`` (batch 2 of 3
    test images: a padded second batch) on one float32 model, the JAX
    artifact saved by orbax, the port's its bridge."""
    root = tmp_path_factory.mktemp("sweep")
    data = str(root / "vg")
    make_synth_vg(data, n_train=2, n_val=1, n_test=3, height=HW[0],
                  width=HW[1], seed=1)
    cfg, jcfg = EgtrConfig(**CFG), JaxConfig(**CFG)
    params = jax_params(JaxEgtrModel(jcfg), 9,
                        jnp.zeros((1, *HW, 3), jnp.float32))
    jax_checkpoint.save_pretrained(str(root / "jax" / "artifact"), jcfg,
                                   params)
    state = state_dict_from_jax(params, cfg)
    save_pretrained(str(root / "port" / "artifact"), cfg, state)
    model = EgtrModel(cfg)
    model.load_state_dict(state, strict=True)
    _plant_ground_truth(data, model.eval(), cfg)
    reports = {}
    for name, fn in (("jax", jax_exp.cmd_sweep), ("port", exp.cmd_sweep)):
        fn(_args("sweep", data, root / name, "--windows", "0,8p",
                 "--batch", "2"))
        with open(root / name / "window_sweep.json") as f:
            reports[name] = json.load(f)
    yield types.SimpleNamespace(root=root, data=data, reports=reports)
    shutil.rmtree(root, ignore_errors=True)


def test_sweep_matches_jax(sweeps):
    ours, ref = sweeps.reports["port"], sweeps.reports["jax"]
    assert sorted(ours) == sorted(ref) == ["win0", "win8_pp",
                                           "win8_pp_vs_exact_outputs"]
    recall_keys = ("R@20", "R@50", "R@100", "mR@20", "mR@50", "mR@100")
    for key in ("win0", "win8_pp"):
        assert {k: ours[key][k] for k in recall_keys} == {
            k: ref[key][k] for k in recall_keys}, key
        assert ours[key]["compile_plus_eval_sec"] >= 0
    assert 0 < ours["win0"]["R@50"] < 1
    deltas, ref_deltas = (r["win8_pp_vs_exact_outputs"] for r in (ours, ref))
    assert sorted(deltas) == sorted(ref_deltas) == sorted(exp.KEYS)
    for out_key, row in deltas.items():
        for stat in ("max_abs", "mean_abs", "max_rel_of_scale"):
            assert abs(row[stat] - ref_deltas[out_key][stat]) <= DELTA_ATOL, (
                out_key, stat)
    assert deltas["logits"]["max_abs"] > 0


def test_sweep_is_incremental(sweeps, monkeypatch):
    """A rerun measures nothing again; a variant not yet in the report is
    measured; the exact variant is measured again when its cached raw
    outputs are gone."""
    out = sweeps.root / "port"
    measured = []
    real = exp._sweep_eval

    def spy(model, cfg, *args):
        measured.append((cfg.msda_window, cfg.msda_band, cfg.msda_int8))
        return real(model, cfg, *args)

    monkeypatch.setattr(exp, "_sweep_eval", spy)
    exp.cmd_sweep(_args("sweep", sweeps.data, out, "--windows", "0,8p",
                        "--batch", "2"))
    assert measured == []
    exp.cmd_sweep(_args("sweep", sweeps.data, out, "--windows", "0,8pi",
                        "--batch", "2"))
    assert measured == [(8, "point", True)]
    os.remove(out / "exact_raw0.npz")
    exp.cmd_sweep(_args("sweep", sweeps.data, out, "--windows", "0,8p",
                        "--batch", "2"))
    assert measured == [(8, "point", True), (0, "tile", False)]
    with open(out / "window_sweep.json") as f:
        report = json.load(f)
    assert "win8_pp_int8_vs_exact_outputs" in report
    assert report["win0"] == sweeps.reports["port"]["win0"]


# --------------------------------------------------------------------------
# window deltas
# --------------------------------------------------------------------------

def test_window_deltas_match_jax():
    """272x96: levels of 34, 17, 9 and 5 rows, so a window of 16 bands two
    and a window of 8 three. The JAX script's ``run`` per variant: one
    jitted apply of the same params."""
    cfg = exp_window_deltas.base_config(**TINY, compute_dtype="float32")
    jcfg = JaxConfig(**{k: getattr(cfg, k) for k in (
        *TINY, "compute_dtype")})
    x = np.random.default_rng(0).standard_normal(
        (1, 272, 96, 3)).astype(np.float32)
    jm = JaxEgtrModel(jcfg)
    params = jax_params(jm, 6, jnp.asarray(x))

    def jax_run(c):
        out = jax_apply(JaxEgtrModel(c), params, jnp.asarray(x))
        return {k: np.asarray(out[k], np.float64)
                for k in exp_window_deltas.KEYS}

    exact = jax_run(jcfg)
    ours = exp_window_deltas.deltas(
        cfg, state_dict_from_jax(params, cfg), torch.from_numpy(x),
        torch.device("cpu"))
    assert list(ours) == [name for name, _ in exp_window_deltas.VARIANTS]
    for name, kw in exp_window_deltas.VARIANTS:
        out = jax_run(jcfg.replace(**kw))
        for k in exp_window_deltas.KEYS:
            d = np.abs(out[k] - exact[k])
            scale = float(np.abs(exact[k]).max()) or 1.0
            ref = {"max_abs": float(d.max()),
                   "max_rel_of_scale": float(d.max() / scale)}
            for stat, value in ref.items():
                assert abs(ours[name][k][stat] - value) <= DELTA_ATOL, (
                    name, k, stat)
        assert ours[name]["logits"]["max_abs"] > 0


def test_window_deltas_main_needs_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp_window_deltas.main([str(tmp_path / "out.json")])
