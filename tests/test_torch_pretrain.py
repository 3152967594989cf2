"""Detector pretraining: the port's ``fit(task="detection")`` against the JAX
package's detection step, and the pretraining driver
(``egtr_tpu_torch/scripts/pretrain_detr.py``) end to end on the CPU.

- One accumulated optimizer step (A=2 over a batch of 4) of a tiny float32
  ``DeformableDetrBase`` (2+2 layers, d_model 64, dropout 0, auxiliary
  losses) from the same bridged weights: the loss terms, ``grad_norm`` and
  the updated parameters within ``test_torch_train._check_update``'s
  tolerance, then the validation loss after the step.
- ``pretrain_detr.main --device cpu`` at a tiny width, then
  ``train_egtr.main --pretrained`` on its artifact: every detector leaf comes
  from the artifact, and the freshly initialized paths are the relation
  head's and the frequency-bias tables'.
- The options with no counterpart on one device are refused.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egtr_tpu.config import EgtrConfig as JaxConfig
from egtr_tpu.models.detr import DeformableDetrBase as JaxDetrBase
from egtr_tpu.train import optim as jax_optim
from egtr_tpu.train import train_step as jax_train_step
from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.models.detr import DeformableDetrBase
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.train import checkpoint
from egtr_tpu_torch.train import trainer as trainer_mod
from egtr_tpu_torch.train.optim import make_optimizer
from egtr_tpu_torch.train.trainer import fit
from egtr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_model import jax_params
from test_torch_train import CFG, _check_update, make_batch, to_np_tree
from test_torch_trainer import _val_losses, tiny_driver  # noqa: F401

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore:Some donated buffers")

# the detection groups of test_torch_train's learning rates (no relation
# head, so no lr_initialized group, as pretrain_detr passes None)
LRS = dict(lr=2e-3, lr_backbone=2e-4, lr_initialized=None)


@pytest.fixture(scope="module")
def jax_detection_step():
    """The JAX side: the bridged starting weights, the accumulated step's
    metrics and parameters, its averaged gradients, and the validation loss
    after it."""
    jcfg = JaxConfig(**CFG)
    model = JaxDetrBase(jcfg)
    batch, val_batch = make_batch(0, 4), make_batch(1, 2)
    params = jax_params(model, 2, jnp.asarray(batch["pixel_values"][:1]))
    tx = jax_optim.make_optimizer(**LRS)
    step = jax_train_step.make_train_step(model, jcfg, tx, task="detection",
                                          accum_steps=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    rng = jax.random.PRNGKey(0)
    mbs = jax_train_step.split_microbatches(batch, 2)
    grads = [to_np_tree(step.grads_mb(jparams, mb, key)[0]) for mb, key in
             zip(mbs, jax.random.split(rng, 2))]
    state = jax_train_step.create_state(jparams, tx)
    state, metrics = step(state, batch, rng)
    eval_step = jax_train_step.make_eval_step(model, jcfg, task="detection")
    _, val_losses = eval_step(state.params, val_batch)
    return {"params": params, "batch": batch, "val_batch": val_batch,
            "grads": jax.tree_util.tree_map(lambda a, b: 0.5 * (a + b),
                                            *grads),
            "new_params": to_np_tree(state.params),
            "metrics": to_np_tree(metrics),
            "val_total": float(val_losses["total_loss"])}


def test_detection_fit_step_matches_jax(tmp_path, jax_detection_step):
    ref = jax_detection_step
    cfg = EgtrConfig(**CFG)
    init = state_dict_from_jax(ref["params"], cfg)
    model = DeformableDetrBase(cfg)
    model.load_state_dict(init, strict=True)
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    labels = make_optimizer(model, **LRS).labels
    assert set(labels.values()) == {"main", "backbone", "frozen"}
    # one epoch of one accumulated step, then the validation batch
    model = fit(DeformableDetrBase(cfg), cfg, train_loader=[ref["batch"]],
                val_loader=[ref["val_batch"]], log_dir=str(tmp_path),
                task="detection", **LRS, max_epochs=1, accum_steps=2,
                init_params=init, log_every=1, device="cpu")
    val, records = _val_losses(str(tmp_path))
    (record,) = records
    assert set(ref["metrics"]) <= set(record)
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(record[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    _check_update(model, old, state_dict_from_jax(ref["new_params"], cfg),
                  state_dict_from_jax(ref["grads"], cfg), labels)
    np.testing.assert_allclose(val, [ref["val_total"]], rtol=1e-4)


def _chain_argv(data, out):
    return ["--data_path", data, "--output_path", out, "--batch_size", "1",
            "--accumulate", "2", "--max_epochs", "1",
            "--max_epochs_finetune", "1", "--num_workers", "1", "--seed",
            "0", "--device", "cpu", "--num_queries", "10", "--max_gt_boxes",
            "8", "--log_every", "1"]


def test_pretrain_then_train_egtr_on_cpu(tmp_path, tiny_driver,  # noqa: F811
                                         monkeypatch):
    from egtr_tpu_torch.scripts import pretrain_detr, train_egtr
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg

    data, pre, out = (str(tmp_path / d) for d in ("vg", "pre", "run"))
    make_synth_vg(data, n_train=4, n_val=2, n_test=2, height=48, width=80,
                  seed=0)
    detector = pretrain_detr.main(_chain_argv(data, pre)
                                  + ["--precompile", "true"])
    assert isinstance(detector, DeformableDetrBase) and not detector.training
    for phase in ("main", "finetune"):
        losses, records = _val_losses(os.path.join(pre, phase))
        assert len(losses) == 1 and np.isfinite(losses).all()
        assert len(records) == 2
        assert all(np.isfinite(r["total_loss"]) for r in records)
        assert "loss_ce" in records[0] and "loss_rel" not in records[0]
    with open(os.path.join(pre, "metrics_test.json")) as f:
        metrics = json.load(f)
    assert metrics and all(k.startswith("coco/") for k in metrics)
    assert np.isfinite(metrics["coco/AP"])
    cfg, artifact = checkpoint.load_pretrained(os.path.join(pre, "artifact"))
    assert cfg.auxiliary_loss and (cfg.num_labels, cfg.d_model) == (6, 64)
    detector_sd = detector.state_dict()
    assert sorted(artifact) == sorted(f"model.{k}" for k in detector_sd)

    # the chain: train_egtr merges the artifact into a fresh EGTR init
    seen = {}
    real = trainer_mod.two_phase_fit

    def spy(model, cfg, **kw):
        seen.update(kw)
        return real(model, cfg, **kw)

    monkeypatch.setattr(trainer_mod, "two_phase_fit", spy)
    train_egtr.main(_chain_argv(data, out)
                    + ["--pretrained", os.path.join(pre, "artifact")])
    fresh = EgtrModel(cfg.replace(num_queries=10)).state_dict()
    expect = {n.replace(".", "/") for n in fresh
              if n.startswith("relation_head.")
              or n in ("rel_dist", "triplet_dist")}
    assert set(seen["initialized_paths"]) == expect
    for name, value in artifact.items():
        assert torch.equal(seen["init_params"][name], value), name
    assert all(n in artifact or n.replace(".", "/") in expect for n in fresh)


@pytest.mark.parametrize("argv,error", [
    (["--dataset", "open_images"], "open_images"),
    (["--dp", "2"], "one process on one device"),
    (["--mp", "2"], "one process on one device"),
    (["--use_remat", "true"], "use_remat"),
])
def test_pretrain_refusals(tmp_path, tiny_driver, argv, error):  # noqa: F811
    from egtr_tpu_torch.scripts import pretrain_detr
    from egtr_tpu_torch.scripts.make_synth_vg import make_synth_vg

    data = str(tmp_path / "vg")
    make_synth_vg(data, n_train=1, n_val=1, n_test=1, height=48, width=80)
    with pytest.raises(NotImplementedError, match=error):
        pretrain_detr.main(["--data_path", data, "--output_path",
                            str(tmp_path / "run"), "--device", "cpu", *argv])


def test_pretrain_defaults_to_the_card(tmp_path, monkeypatch):
    from egtr_tpu_torch.scripts import pretrain_detr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain_detr.main(["--data_path", str(tmp_path), "--output_path",
                            str(tmp_path / "run")])
