"""The port's checkpoints, training loop, evaluation runner and training
driver against the JAX package's, on the CPU.

- Retention: the same validation-loss sequences through orbax (the JAX
  package's ``CheckpointManager``) and the port's manager keep, delete and
  report the same steps.
- ``merge_pretrained``: the same freshly initialized parameters as the JAX
  function on a bridged tree with a mismatched ``class_embed``.
- ``fit`` (one epoch, then a resume) and ``two_phase_fit`` on a 2+2-layer
  float32 model without dropout, 64x96 images, against the JAX package's
  jitted train and eval steps driven in the loop's own order (the JAX
  ``fit`` itself would compile its programs anew for every call).
- ``evaluate_sgg`` against the JAX runner on the same bridged weights.
- The driver end to end with ``--device cpu`` at a tiny width.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egtr_tpu.config import EgtrConfig as JaxConfig
from egtr_tpu.data.loader import Loader as JaxLoader
from egtr_tpu.data.transforms import Sample as JaxSample
from egtr_tpu.evaluation.oi_eval import OIEvaluator as JaxOIEvaluator
from egtr_tpu.evaluation.runner import evaluate_sgg as jax_evaluate_sgg
from egtr_tpu.models.egtr import EgtrModel as JaxEgtrModel
from egtr_tpu.train import checkpoint as jax_checkpoint
from egtr_tpu.train import optim as jax_optim
from egtr_tpu.train import train_step as jax_train_step
from egtr_tpu.utils.convert import convert_backbone_state_dict
from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.data.loader import Loader
from egtr_tpu_torch.data.transforms import Sample
from egtr_tpu_torch.evaluation.oi_eval import OIEvaluator
from egtr_tpu_torch.evaluation.runner import evaluate_sgg
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.train import checkpoint
from egtr_tpu_torch.train.optim import make_optimizer, param_label
from egtr_tpu_torch.train.trainer import fit, two_phase_fit
from egtr_tpu_torch.utils.convert import (backbone_state_dict_from_timm,
                                          state_dict_from_jax)
from test_torch_model import TINY, jax_params

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore:Some donated buffers")

CFG = dict(TINY, max_gt_boxes=6, max_gt_rels=8)
LRS = dict(lr=2e-4, lr_backbone=2e-5, lr_initialized=2e-3)
HW = (64, 96)
SEED = 3
REL_NAMES = [f"p{i}" for i in range(CFG["num_rel_labels"])]


# --------------------------------------------------------------------------
# retention
# --------------------------------------------------------------------------

SEQUENCES = {
    # worse every epoch: orbax keeps the three best, the oldest ones
    "worsening": [1.0, 2.0, 3.0, 4.0, 5.0],
    "improving": [5.0, 4.0, 3.0, 2.0, 1.0],
    "ties": [2.0, 1.0, 1.0, 3.0, 1.0, 2.0],
    "mixed": [3.0, 1.5, 4.0, 1.0, 2.5, 0.5, 6.0],
}


@pytest.fixture(autouse=True)
def free_disk(tmp_path):
    """A test's checkpoints and artifacts hold a ResNet-50 backbone's
    weights (and moments), hundreds of MB: remove them after it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_retention_matches_orbax(tmp_path, name):
    """After every save: the steps kept, latest_step and best_step."""
    ref = jax_checkpoint.CheckpointManager(str(tmp_path / "orbax"))
    ours = checkpoint.CheckpointManager(str(tmp_path / "port"))
    for step, loss in enumerate(SEQUENCES[name], start=1):
        ref.save(step, {"x": np.full((2,), step, np.float32)},
                 metrics={"validation_loss": loss})
        ours.save(step, {"x": torch.full((2,), float(step))},
                  metrics={"validation_loss": loss})
        assert ours.all_steps() == sorted(ref._mngr.all_steps())
        assert ours.latest_step() == ref.latest_step()
        assert ours.best_step() == ref.best_step()
    if name == "worsening":
        # the defect the port reproduces: the newest epochs are gone
        assert ours.all_steps() == [1, 2, 3]
        assert (ours.latest_step(), ours.best_step()) == (3, 1)
    latest = ours.latest_step()
    assert float(ours.restore()["x"][0]) == latest
    restored = ref.restore({"x": np.zeros((2,), np.float32)})
    assert float(restored["x"][0]) == latest


def test_checkpoint_save_rules(tmp_path):
    ours = checkpoint.CheckpointManager(str(tmp_path), max_to_keep=2)
    assert ours.latest_step() is None and ours.best_step() is None
    assert ours.restore() is None
    ours.save(3, {"x": torch.ones(1)}, {"validation_loss": 1.0})
    for step in (2, 3):
        with pytest.raises(ValueError, match="not above the latest"):
            ours.save(step, {"x": torch.ones(1)}, {"validation_loss": 0.5})
    ours.save(4, {"x": torch.ones(1)}, {"validation_loss": 0.5})
    assert ours.all_steps() == [3, 4] and ours.best_step() == 4
    # without metrics a checkpoint ranks below any loss: saved, then dropped
    ours.save(5, {"x": torch.ones(1)})
    assert ours.all_steps() == [3, 4] and ours.latest_step() == 4
    # a checkpoint left half written (no metrics file) is not a step
    os.makedirs(tmp_path / "7")
    assert ours.all_steps() == [3, 4]


# --------------------------------------------------------------------------
# artifacts and merging
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    """Noise-filled JAX params of the tiny model (shapes only, no init)."""
    jm = JaxEgtrModel(JaxConfig(**CFG))
    return jax_params(jm, SEED, jnp.zeros((1, *HW, 3), jnp.float32))


def _jax_path_to_port(path: str) -> str:
    """A JAX param path ("params/.../kernel") in the port's "/"-joined
    state_dict naming (the bridge of utils/convert.py)."""
    parts = path.removeprefix("params/").split("/")
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return "/".join(parts)


def test_merge_pretrained_matches_jax(params):
    """A detector artifact with another label space (class_embed mismatched)
    and without the relation head: the same entries stay fresh, so the
    optimizer puts the same parameters into the lr_initialized group."""
    cfg = EgtrConfig(**CFG)
    init = params
    loaded = jax.tree_util.tree_map(lambda x: np.asarray(x) + 1.0, init)
    loaded = {"params": dict(loaded["params"])}
    loaded["params"]["model"] = dict(loaded["params"]["model"])
    loaded["params"]["model"]["class_embed_0"] = {
        "kernel": np.zeros((CFG["d_model"], 3), np.float32),
        "bias": np.zeros((3,), np.float32)}
    del loaded["params"]["relation_head"]
    jmerged, jinit = jax_checkpoint.merge_pretrained(init, loaded)

    init_sd = state_dict_from_jax(init, cfg)
    loaded_sd = state_dict_from_jax(loaded, cfg)
    merged, fresh = checkpoint.merge_pretrained(init_sd, loaded_sd)
    assert set(merged) == set(init_sd)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jmerged),
                              cfg)
    for name in merged:
        torch.testing.assert_close(merged[name], ref[name], rtol=0, atol=0)
    jax_fresh = [_jax_path_to_port(p) for p in jinit]
    assert "model/class_embed_0/weight" in fresh
    assert "relation_head" in jax_fresh
    names = list(init_sd)
    ours = {n: param_label(n, fresh) for n in names}
    theirs = {n: param_label(n, jax_fresh) for n in names}
    assert ours == theirs
    assert sum(v == "initialized" for v in ours.values()) == sum(
        n.startswith(("relation_head.", "model.class_embed_0."))
        and param_label(n, None) != "frozen" for n in names)


def test_pretrained_artifact_round_trip(tmp_path, params):
    cfg = EgtrConfig(**CFG)
    sd = state_dict_from_jax(params, cfg)
    checkpoint.save_pretrained(str(tmp_path / "artifact"), cfg, sd)
    assert sorted(os.listdir(tmp_path / "artifact")) == ["config.json",
                                                         "weights.pt"]
    cfg2, sd2 = checkpoint.load_pretrained(str(tmp_path / "artifact"))
    assert cfg2 == cfg and set(sd2) == set(sd)
    for k in sd:
        assert torch.equal(sd[k], sd2[k])
    EgtrModel(cfg2).load_state_dict(sd2, strict=True)


def test_backbone_from_timm_matches_jax(params):
    """A raw timm ResNet state dict (the JAX tree's backbone in torch
    layouts and names, plus the classifier) lands on the same entries with
    the same values as the JAX converter's tree through the bridge."""
    cfg = EgtrConfig(**CFG)
    bb = params["params"]["model"]["backbone"]
    raw = {}
    for block, leaves in bb.items():
        for leaf, sub in leaves.items():
            if not isinstance(sub, dict):
                name = {"kernel": "weight"}.get(leaf, leaf)
                value = np.asarray(sub)
                if leaf == "kernel":
                    value = value.transpose(3, 2, 0, 1)
                raw[f"{block}.{name}"] = value
                continue
            for k, v in sub.items():
                name = {"kernel": "weight"}.get(k, k)
                v = np.asarray(v)
                if k == "kernel":
                    v = v.transpose(3, 2, 0, 1)
                torch_block = block.replace("_", ".", 1) if block.startswith(
                    "layer") else block
                torch_leaf = {"downsample_conv": "downsample.0",
                              "downsample_bn": "downsample.1"}.get(leaf, leaf)
                raw[f"{torch_block}.{torch_leaf}.{name}"] = v
    raw["fc.weight"] = np.zeros((10, 2048), np.float32)
    ours = backbone_state_dict_from_timm(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in raw.items()})
    ref = state_dict_from_jax(convert_backbone_state_dict(raw), cfg)
    assert set(ours) == set(ref)
    assert len(ours) == sum(n.startswith("model.backbone.") for n in
                            state_dict_from_jax(params, cfg)
                            if "position" not in n)
    for k in ref:
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="no recognizable"):
        backbone_state_dict_from_timm({"fc.weight": torch.zeros(1)})


# --------------------------------------------------------------------------
# the loop against the JAX steps
# --------------------------------------------------------------------------

class Scenes:
    """Fixed little 64x96 scenes with boxes and relations, as ``Sample``s
    of either package."""

    def __init__(self, n, seed, sample_cls):
        rng = np.random.default_rng(seed)
        self.samples = []
        for i in range(n):
            k = int(rng.integers(2, 5))
            cxcy = rng.uniform(0.3, 0.7, (k, 2))
            wh = rng.uniform(0.1, 0.4, (k, 2))
            rel = np.array([[0, 1, int(rng.integers(0, 5))],
                            [k - 1, 0, int(rng.integers(0, 5))]], np.int32)
            self.samples.append(sample_cls(
                image=rng.standard_normal((*HW, 3)).astype(np.float32),
                boxes=np.concatenate([cxcy, wh], 1).astype(np.float32),
                class_labels=rng.integers(0, CFG["num_labels"], k).astype(
                    np.int32),
                rel=rel, orig_size=(480, 720), size=HW, image_id=10 + i))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def loaders(loader_cls, sample_cls, batch_size=2):
    kw = dict(max_gt=CFG["max_gt_boxes"], num_rel_labels=CFG["num_rel_labels"],
              buckets=(HW,), prefetch=0, shuffle=False)
    return (loader_cls(Scenes(4, 0, sample_cls), batch_size, drop_last=True,
                       **kw),
            loader_cls(Scenes(3, 1, sample_cls), batch_size, **kw))


MAIN_EPOCHS, FINETUNE_EPOCHS = 2, 1


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def jax_loop(params):
    """The JAX package's loop (``egtr_tpu/train/trainer.py:fit`` and
    ``two_phase_fit``) on its jitted steps: the validation loss of every
    epoch, the parameters after each, the best main epoch by orbax's rule,
    and the finetune from it at lr_scale 0.1 with a fresh optimizer."""
    jcfg = JaxConfig(**CFG)
    jm = JaxEgtrModel(jcfg)
    tx = jax_optim.make_optimizer(**LRS, weight_decay=1e-4, grad_clip=0.1)
    step = jax_train_step.make_train_step(jm, jcfg, tx)
    eval_step = jax.jit(jax_train_step.make_eval_step(jm, jcfg))
    train_loader, val_loader = loaders(JaxLoader, JaxSample)

    def phase(start, epochs, lr_scale):
        state = jax_train_step.create_state(
            jax.tree_util.tree_map(jnp.asarray, start), tx)
        rng = jax.random.PRNGKey(SEED)
        losses, snapshots = [], []
        for _ in range(epochs):
            for batch in train_loader:
                rng, key = jax.random.split(rng)
                state, _ = step(state, batch, key, lr_scale)
            total = [float(eval_step(state.params, b)[1]["total_loss"])
                     for b in val_loader]
            losses.append(sum(total) / len(total))
            snapshots.append(_np(state.params))
        return losses, snapshots

    main_losses, main_params = phase(params, MAIN_EPOCHS, 1.0)
    # orbax's best: highest -loss, the later of equal ones
    best = max(range(MAIN_EPOCHS), key=lambda e: (-main_losses[e], e))
    ft_losses, ft_params = phase(main_params[best], FINETUNE_EPOCHS, 0.1)
    return {"main_losses": main_losses, "main_params": main_params,
            "best": best + 1, "ft_losses": ft_losses,
            "ft_params": ft_params}


def _val_losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return ([r["validation_total_loss"] for r in records
             if r["phase"] == "val"],
            [r for r in records if r["phase"] == "train"])


# float32 CPU, summation order: the validation loss to 1e-4. Parameters:
# Adam moves an element by at most about lr per step; where a gradient is
# at round-off its direction is noise, so an element may differ by up to
# 2 lr per step, and the bulk agrees far closer (median below 1% of lr)
LOSS_RTOL = 1e-4


def _assert_params_close(model, ref_tree, cfg, steps, lr_scale=1.0):
    ref = state_dict_from_jax(ref_tree, cfg)
    labels = make_optimizer(model, **LRS).labels
    group_lr = {"main": LRS["lr"], "backbone": LRS["lr_backbone"],
                "initialized": LRS["lr_initialized"]}
    rel_errs = []
    for name, p in model.state_dict().items():
        lr = group_lr.get(labels.get(name, "frozen"))
        if lr is None:
            torch.testing.assert_close(p, ref[name], rtol=0, atol=0)
            continue
        diff = (p - ref[name]).abs().numpy()
        bound = 2.0 * lr * lr_scale * steps
        assert diff.max() <= bound + 1e-6, (name, diff.max(), bound)
        rel_errs.append(diff.ravel() / (lr * lr_scale))
    assert np.median(np.concatenate(rel_errs)) < 1e-2


def test_fit_one_epoch_then_resume_matches_jax(tmp_path, params, jax_loop):
    cfg = EgtrConfig(**CFG)
    init = state_dict_from_jax(params, cfg)
    log_dir = str(tmp_path / "run")
    kw = dict(log_dir=log_dir, **LRS, init_params=init, seed=SEED,
              log_every=1, device="cpu", patience=5)
    train_loader, val_loader = loaders(Loader, Sample)
    fit(EgtrModel(cfg), cfg, train_loader=train_loader, val_loader=val_loader,
        max_epochs=1, **kw)
    ckpt = checkpoint.CheckpointManager(os.path.join(log_dir, "checkpoints"))
    assert ckpt.all_steps() == [1]
    # a relaunch: a new model and new loaders, the same log_dir
    train_loader, val_loader = loaders(Loader, Sample)
    model = fit(EgtrModel(cfg), cfg, train_loader=train_loader,
                val_loader=val_loader, max_epochs=MAIN_EPOCHS, **kw)
    losses, train_records = _val_losses(log_dir)
    np.testing.assert_allclose(losses, jax_loop["main_losses"],
                               rtol=LOSS_RTOL)
    assert [r["step"] for r in train_records] == [1, 2, 3, 4]
    assert all(r["step_seconds"] > 0 for r in train_records)
    assert ckpt.all_steps() == [1, 2]
    payload = ckpt.restore(2)
    assert payload["loop"]["step"] == 4
    assert set(payload) == {"model", "optimizer", "loop", "generator"}
    # the AdamW moments came back: every trainable parameter has 4 steps
    assert {float(s["step"]) for s in payload["optimizer"].values()} == {4.0}
    _assert_params_close(model, jax_loop["main_params"][-1], cfg, steps=4)
    # relaunching once more takes no step
    fit(EgtrModel(cfg), cfg, train_loader=train_loader, val_loader=val_loader,
        max_epochs=MAIN_EPOCHS, **kw)
    assert _val_losses(log_dir)[0] == losses


def test_two_phase_fit_matches_jax(tmp_path, params, jax_loop, capsys):
    cfg = EgtrConfig(**CFG)
    log_dir = str(tmp_path / "run")
    train_loader, val_loader = loaders(Loader, Sample)
    model = two_phase_fit(
        EgtrModel(cfg), cfg, log_dir=log_dir, train_loader=train_loader,
        val_loader=val_loader, **LRS, max_epochs=MAIN_EPOCHS,
        max_epochs_finetune=FINETUNE_EPOCHS, patience=5,
        init_params=state_dict_from_jax(params, cfg), seed=SEED,
        log_every=1, device="cpu")
    assert (f"finetune from best main epoch {jax_loop['best']}"
            in capsys.readouterr().out)
    main, _ = _val_losses(os.path.join(log_dir, "main"))
    finetune, records = _val_losses(os.path.join(log_dir, "finetune"))
    np.testing.assert_allclose(main, jax_loop["main_losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(finetune, jax_loop["ft_losses"],
                               rtol=LOSS_RTOL)
    assert len(records) == 2 * FINETUNE_EPOCHS
    _assert_params_close(model, jax_loop["ft_params"][-1], cfg,
                         steps=4 + 2 * FINETUNE_EPOCHS)


def test_two_phase_fit_without_a_main_checkpoint_warns(tmp_path, params):
    cfg = EgtrConfig(**CFG)
    train_loader, val_loader = loaders(Loader, Sample)
    with pytest.warns(UserWarning, match="no best main-phase checkpoint"):
        two_phase_fit(EgtrModel(cfg), cfg, log_dir=str(tmp_path), **LRS,
                      train_loader=train_loader, val_loader=val_loader,
                      max_epochs=0, max_epochs_finetune=0,
                      init_params=state_dict_from_jax(params, cfg),
                      device="cpu")


def test_evaluate_sgg_matches_jax(params):
    """The same bridged weights and batches: the same R@K, mR@K (both
    evaluator modes) and COCO metrics."""
    jcfg = JaxConfig(**CFG)
    cfg = EgtrConfig(**CFG)
    _, jloader = loaders(JaxLoader, JaxSample)
    _, loader = loaders(Loader, Sample)
    kw = dict(coco_eval=True, eval_multiple_preds=True)
    want = jax_evaluate_sgg(JaxEgtrModel(jcfg), jcfg,
                            jax.tree_util.tree_map(jnp.asarray, params),
                            jloader, REL_NAMES, **kw)
    model = EgtrModel(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    got = evaluate_sgg(model, cfg, loader, REL_NAMES, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    # every image has relations, so every recall is a number
    assert all(np.isfinite(got[f"{mode}/R@{k}"]) for k in (20, 50, 100)
               for mode in ("single", "multiple"))
    # the Open Images evaluator on the same weights and batches: rel_full
    # over all Q^2 pairs, the same oi/* metrics
    classes = [f"c{i}" for i in range(CFG["num_labels"])]
    want = jax_evaluate_sgg(JaxEgtrModel(jcfg), jcfg,
                            jax.tree_util.tree_map(jnp.asarray, params),
                            jloader, REL_NAMES, eval_single_preds=False,
                            oi_evaluator=JaxOIEvaluator(REL_NAMES, classes))
    got = evaluate_sgg(model, cfg, loader, REL_NAMES, eval_single_preds=False,
                       oi_evaluator=OIEvaluator(REL_NAMES, classes))
    assert set(got) == set(want) and "oi/score" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


# --------------------------------------------------------------------------
# the driver
# --------------------------------------------------------------------------

DRIVER_TINY = dict(d_model=64, encoder_layers=2, decoder_layers=2,
                   encoder_ffn_dim=128, decoder_ffn_dim=128,
                   compute_dtype="float32")


@pytest.fixture
def tiny_driver(monkeypatch):
    """The driver at a tiny width and image size: a 2+2-layer d_model 64
    model, DETR scales of 48/64 rows, test images resized to 48 rows, and
    buckets to match."""
    from egtr_tpu_torch import config as config_mod
    from egtr_tpu_torch.data import loader as loader_mod
    from egtr_tpu_torch.data import transforms as transforms_mod
    from egtr_tpu_torch.data import visual_genome as vg_mod

    real_cfg, real_ds = config_mod.EgtrConfig, vg_mod.VGDataset

    class SmallVG(real_ds):
        def __init__(self, *a, size=800, max_size=1333, **kw):
            super().__init__(*a, size=48, max_size=96, **kw)

    class TinyConfig(real_cfg):
        def __init__(self, **kw):
            super().__init__(**{**kw, **DRIVER_TINY})

    monkeypatch.setattr(config_mod, "EgtrConfig", TinyConfig)
    monkeypatch.setattr(vg_mod, "VGDataset", SmallVG)
    monkeypatch.setattr(transforms_mod, "DETR_TRAIN_SCALES", (48, 64))
    monkeypatch.setattr(loader_mod, "default_buckets",
                        lambda max_size=1333: ((96, 160), (160, 96),
                                               (160, 160)))


def test_driver_end_to_end_on_cpu(tmp_path, tiny_driver, capsys):
    from egtr_tpu_torch.scripts import train_egtr
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg

    data, out = str(tmp_path / "vg"), str(tmp_path / "run")
    make_synth_vg(data, n_train=4, n_val=2, n_test=2, height=48, width=80,
                  seed=0)
    argv = ["--data_path", data, "--output_path", out, "--from_scratch",
            "true", "--batch_size", "1", "--accumulate", "2", "--max_epochs",
            "1", "--max_epochs_finetune", "1", "--num_workers", "2",
            "--seed", "0", "--device", "cpu", "--num_queries", "10",
            "--max_gt_boxes", "8", "--max_gt_rels", "16", "--log_every", "1"]
    model = train_egtr.main(argv)
    for phase in ("main", "finetune"):
        losses, records = _val_losses(os.path.join(out, phase))
        assert len(losses) == 1 and np.isfinite(losses).all()
        assert len(records) == 2
        assert all(np.isfinite(r["total_loss"]) for r in records)
    assert sorted(os.listdir(os.path.join(out, "artifact"))) == [
        "config.json", "weights.pt"]
    with open(os.path.join(out, "metrics_test.json")) as f:
        metrics = json.load(f)
    for k in (20, 50, 100):
        assert np.isfinite(metrics[f"single/R@{k}"])
        assert np.isfinite(metrics[f"single/mR@{k}"])
    assert np.isfinite(metrics["coco/AP"])
    # the artifact reloads into the same forward, bit for bit
    cfg, sd = checkpoint.load_pretrained(os.path.join(out, "artifact"))
    assert (cfg.num_labels, cfg.num_rel_labels, cfg.d_model) == (6, 4, 64)
    reloaded = EgtrModel(cfg)
    reloaded.load_state_dict(sd, strict=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 96, 160, 3)).astype(np.float32))
    with torch.no_grad():
        a, b = model.eval()(x), reloaded.eval()(x)
    for key in ("logits", "pred_boxes", "pred_rel"):
        assert torch.equal(a[key], b[key])
    # a relaunch on the same output path resumes and takes no step
    capsys.readouterr()
    train_egtr.main(argv)
    assert "resumed from epoch 1" in capsys.readouterr().out
    for phase in ("main", "finetune"):
        assert len(_val_losses(os.path.join(out, phase))[1]) == 2


class ReachedFit(Exception):
    """Raised by a stand-in for ``two_phase_fit``: the driver built its data
    and model and was about to train."""


# the first two options were refused until the port took them; they keep
# their cases' ids and now reach the fit with the option in effect
@pytest.mark.parametrize("argv,error", [
    pytest.param(["--dataset", "open_images"], ReachedFit,
                 id="argv0-NotImplementedError"),
    pytest.param(["--use_remat", "true"], ReachedFit,
                 id="argv1-NotImplementedError"),
    (["--dp", "2"], SystemExit),
])
def test_driver_refusals(tmp_path, tiny_driver, argv, error, capsys,
                         monkeypatch):
    from egtr_tpu_torch.scripts import train_egtr
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg
    from egtr_tpu_torch.train import trainer as trainer_mod
    from chip_smoke import write_synth_oi

    def reached(model, cfg, **kwargs):
        raise ReachedFit(model, cfg)

    monkeypatch.setattr(trainer_mod, "two_phase_fit", reached)
    data = str(tmp_path / "vg")
    make_synth_vg(data, n_train=1, n_val=1, n_test=1, height=48, width=80)
    # the Open Images layout beside it (annotations/, images/)
    write_synth_oi(data, n_train=1, n_val=1, n_test=1, height=48, width=80)
    with pytest.raises(error) as info:
        train_egtr.main(["--data_path", data, "--output_path",
                         str(tmp_path / "run"), "--device", "cpu", *argv])
    if error is ReachedFit:
        model, cfg = info.value.args
        if "open_images" in argv:
            assert (cfg.num_labels, cfg.num_rel_labels) == (601, 30)
        else:
            assert cfg.use_remat and cfg.remat_policy == "dots"
            assert model.model.encoder_layer_0.remat == "dots"


# --------------------------------------------------------------------------
# a relaunch replays epoch 0's randomness, in both packages
# --------------------------------------------------------------------------


def test_relaunch_replays_epoch_zero_in_both_packages(tmp_path, monkeypatch):
    """A defect of the JAX package that the port keeps on purpose (ROADMAP
    queue 3): the loader's epoch counter and the dataset's augmentation
    generator start afresh in every process and are not in the checkpoint,
    so the first epoch after a resume sees epoch 0's image order and
    augmentation again. Each package's ``fit`` runs one epoch, then a
    relaunch with new loaders resumes for a second; an uninterrupted
    two-epoch run shuffles its second epoch differently. The train and eval
    steps are stand-ins that record each batch."""
    from egtr_tpu.data import loader as jax_loader_mod
    from egtr_tpu.data import transforms as jax_transforms_mod
    from egtr_tpu.data.visual_genome import VGDataset as JaxVGDataset
    from egtr_tpu.train import trainer as jax_trainer
    from egtr_tpu_torch.data import loader as loader_mod
    from egtr_tpu_torch.data import transforms as transforms_mod
    from egtr_tpu_torch.data.visual_genome import VGDataset
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg
    from egtr_tpu_torch.train import trainer as port_trainer

    data = str(tmp_path / "vg")
    make_synth_vg(data, n_train=6, n_val=1, n_test=1, height=48, width=80,
                  seed=0)
    for mod in (jax_transforms_mod, transforms_mod):
        monkeypatch.setattr(mod, "DETR_TRAIN_SCALES", (48, 64))
    for mod in (jax_loader_mod, loader_mod):
        monkeypatch.setattr(mod, "default_buckets", lambda max_size=1333: (
            (96, 160), (160, 96), (160, 160)))
    seen = {"jax": [], "port": []}

    def jax_train_step(*args, **kw):
        def step(state, batch, rng, lr_scale=1.0):
            seen["jax"].append((batch["image_id"].tolist(),
                                float(batch["pixel_values"].sum())))
            return state, {}
        return step

    def port_train_step(*args, **kw):
        def step(batch, generator, lr_scale=1.0):
            seen["port"].append((batch["image_id"].tolist(),
                                 float(batch["pixel_values"].sum())))
            return {}
        return step

    monkeypatch.setattr(jax_trainer, "make_train_step", jax_train_step)
    monkeypatch.setattr(jax_trainer, "make_eval_step", lambda *a, **kw: (
        lambda params, batch: (None, {"total_loss": 1.0})))
    monkeypatch.setattr(port_trainer, "make_train_step", port_train_step)
    monkeypatch.setattr(port_trainer, "make_eval_step", lambda *a, **kw: (
        lambda batch: (None, {"total_loss": torch.tensor(1.0)})))

    def run(package, log_dir, max_epochs):
        """One process's run: a new dataset and loader, as a relaunch
        makes them; returns the batches its train steps saw."""
        vg, loader, fit_ = ((JaxVGDataset, jax_loader_mod.Loader,
                             jax_trainer.fit) if package == "jax" else
                            (VGDataset, Loader, port_trainer.fit))
        train = loader(vg(data, "train", train_aug=True, seed=0), 2,
                       shuffle=True, max_gt=8, num_rel_labels=4,
                       drop_last=True, seed=0, num_workers=1)
        val = loader(vg(data, "val", size=48, max_size=80), 1,
                     shuffle=False, max_gt=8, num_rel_labels=4)
        if package == "jax":
            kw = dict(init_params={"params": {"w": jnp.zeros(1)}})
            model, cfg = None, JaxConfig()
        else:
            model, cfg = torch.nn.Linear(1, 1), EgtrConfig()
            kw = dict(init_params=model.state_dict(), device="cpu")
        start = len(seen[package])
        fit_(model, cfg, train_loader=train, val_loader=val,
             log_dir=str(log_dir), max_epochs=max_epochs, seed=0,
             log_every=1000, **kw)
        return seen[package][start:]

    ids = {}
    for package in ("jax", "port"):
        first = run(package, tmp_path / package / "relaunched", 1)
        resumed = run(package, tmp_path / package / "relaunched", 2)
        assert len(first) == len(resumed) == 3
        # the same images in the same order, augmented the same way
        assert resumed == first, package
        straight = run(package, tmp_path / package / "straight", 2)
        assert straight[:3] == first
        assert [b[0] for b in straight[3:]] != [b[0] for b in first]
        ids[package] = [b[0] for b in first + straight]
    assert ids["port"] == ids["jax"]
