"""The port's reference-checkpoint converter against the JAX package's.

A reference-named state dict (``build_reference_named_state_dict`` of
``tests/test_convert.py``: the keys of the reference's
``DetrForSceneGraphGeneration.state_dict()``) goes
through JAX's ``convert_detr_state_dict`` and the bridge
``state_dict_from_jax``, and straight through the port's
``convert_detr_state_dict``: the two must agree leaf by leaf, bit for bit,
and load into the port's model with ``strict=True``. A tiny float32 forward
through both packages' converted weights, and the reference-artifact dry
run through the port's ``load_artifact``, follow.
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egtr_tpu.config import EgtrConfig as JaxConfig
from egtr_tpu.models.egtr import EgtrModel as JaxEgtrModel
from egtr_tpu.utils.convert import \
    convert_detr_state_dict as jax_convert_detr_state_dict
from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.scripts.evaluate_egtr import (_latest_epoch_ckpt,
                                                  load_artifact)
from egtr_tpu_torch.utils.convert import (convert_detr_state_dict,
                                          state_dict_from_jax, strip_prefix)
from test_convert import VARIANTS, build_reference_named_state_dict
from test_torch_model import ATOL, COMPARED, RTOL, TINY, jax_apply, to_np

torch.set_num_threads(1)

SMALL = dict(num_queries=12, num_labels=7, num_rel_labels=5,
             encoder_layers=2, decoder_layers=2)
FULL = dict(num_queries=200, num_labels=150, num_rel_labels=50)


def _both_ways(kw, seed):
    """(the reference state dict, the port's cfg, the JAX path's state dict,
    the port's direct one)."""
    sd = build_reference_named_state_dict(JaxConfig(**kw),
                                          np.random.default_rng(seed))
    cfg = EgtrConfig(**kw)
    via_jax = state_dict_from_jax(jax_convert_detr_state_dict(sd, JaxConfig(
        **kw)), cfg)
    return sd, cfg, via_jax, convert_detr_state_dict(sd, cfg)


def _assert_bit_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype == torch.float32, name
        assert a[name].is_contiguous() and b[name].is_contiguous(), name
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("variant", ["box_refine", "shared_heads",
                                     "learned_posemb", "resnet101"])
def test_conversion_equals_the_jax_path(variant):
    _, cfg, via_jax, direct = _both_ways({**SMALL, **VARIANTS[variant]}, 0)
    _assert_bit_equal(direct, via_jax)
    EgtrModel(cfg).load_state_dict(direct, strict=True)


def test_conversion_equals_the_jax_path_at_full_width():
    """ResNet-50, d_model 256, 6+6 layers, 200 queries, 150/50 labels, box
    refinement: the released checkpoint's layout. A conversion only."""
    sd, cfg, via_jax, direct = _both_ways(dict(FULL, with_box_refine=True),
                                          1)
    assert cfg.d_model == 256 and cfg.encoder_layers == 6
    _assert_bit_equal(direct, via_jax)
    EgtrModel(cfg).load_state_dict(direct, strict=True)
    # the relation head's raw parameters are the reference weights
    # transposed; every other leaf keeps the reference layout
    np.testing.assert_array_equal(
        direct["relation_head.rel_predictor_gate_kernel"].numpy(),
        sd["rel_predictor_gate.weight"].T)
    np.testing.assert_array_equal(
        direct["model.backbone.layer3_5.conv2.weight"].numpy(),
        sd["model.backbone.conv_encoder.model.layer3.5.conv2.weight"])


def test_lightning_prefix_stripped():
    cfg = EgtrConfig(**SMALL)
    sd = build_reference_named_state_dict(cfg, np.random.default_rng(2))
    lightning = {f"model.{k}": torch.from_numpy(v) for k, v in sd.items()}
    assert strip_prefix(lightning).keys() == sd.keys()
    _assert_bit_equal(convert_detr_state_dict(lightning, cfg),
                      convert_detr_state_dict(sd, cfg))


def test_refusals():
    two_stage = {**SMALL, **VARIANTS["two_stage"]}
    sd = build_reference_named_state_dict(JaxConfig(**two_stage),
                                          np.random.default_rng(3))
    with pytest.raises(NotImplementedError, match="two_stage"):
        convert_detr_state_dict(sd, EgtrConfig(**two_stage))
    # a two-stage checkpoint under a config that does not say so
    with pytest.raises(NotImplementedError, match="two_stage"):
        convert_detr_state_dict(sd, EgtrConfig(**SMALL))
    deep = build_reference_named_state_dict(
        EgtrConfig(**SMALL, backbone="resnet101"), np.random.default_rng(4))
    with pytest.raises(ValueError, match="block counts"):
        convert_detr_state_dict(deep, EgtrConfig(**SMALL))
    # a layer the config does not have is named, not dropped
    sd = build_reference_named_state_dict(EgtrConfig(**SMALL),
                                          np.random.default_rng(5))
    sd["model.encoder.layers.2.fc1.bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="encoder.layers.2.fc1.bias"):
        convert_detr_state_dict(sd, EgtrConfig(**SMALL))


def test_converted_forward_matches_jax():
    """A tiny float32 model: the same reference weights converted by each
    package, one forward each, within test_torch_model's tolerance."""
    kw = dict(TINY, with_box_refine=True)
    jcfg, cfg = JaxConfig(**kw), EgtrConfig(**kw)
    sd = build_reference_named_state_dict(jcfg, np.random.default_rng(6))
    x = np.random.default_rng(7).standard_normal((1, 64, 96, 3)).astype(
        np.float32)
    ref = jax_apply(JaxEgtrModel(jcfg), jax_convert_detr_state_dict(sd, jcfg),
                    jnp.asarray(x))
    model = EgtrModel(cfg)
    model.load_state_dict(convert_detr_state_dict(sd, cfg), strict=True)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x))
    for key in COMPARED:
        np.testing.assert_allclose(to_np(out[key]), np.asarray(ref[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)


def _hf_config(cfg):
    return {"architectures": ["DetrForSceneGraphGeneration"],
            "id2label": {str(i): f"c{i}" for i in range(cfg.num_labels)},
            "d_model": cfg.d_model, "encoder_layers": cfg.encoder_layers,
            "decoder_layers": cfg.decoder_layers,
            "encoder_ffn_dim": cfg.encoder_ffn_dim,
            "decoder_ffn_dim": cfg.decoder_ffn_dim,
            "encoder_attention_heads": cfg.encoder_attention_heads,
            "decoder_attention_heads": cfg.decoder_attention_heads,
            "num_queries": cfg.num_queries, "with_box_refine": True,
            "num_rel_labels": cfg.num_rel_labels, "smoothing": 1e-14,
            "model_type": "deformable_detr"}


ARGS = types.SimpleNamespace(num_queries=12, logit_adjustment=False,
                             logit_adj_tau=0.3, compute_dtype="float32")


def _forward(cfg, sd):
    model = EgtrModel(cfg)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        return model.eval()(torch.zeros((1, 64, 64, 3)))


def test_reference_artifact_ingestion_dry_run(tmp_path):
    """A reference artifact directory (HF config.json with id2label,
    Lightning checkpoints/epoch=NN-*.ckpt with the model. prefix): the
    newest epoch by number loads, converted, strict, and runs; the same
    checkpoint by its path, and a bare pytorch_model.bin, too."""
    cfg = EgtrConfig(**SMALL, with_box_refine=True)
    art = tmp_path / "egtr__artifact"
    (art / "checkpoints").mkdir(parents=True)
    with open(art / "config.json", "w") as f:
        json.dump(_hf_config(cfg), f)
    sds = {}
    for epoch in (2, 10, 3):   # 10 is newest by number, not by name
        sd = build_reference_named_state_dict(cfg, np.random.default_rng(
            epoch))
        sds[epoch] = sd
        torch.save({"state_dict": {f"model.{k}": torch.from_numpy(v)
                                   for k, v in sd.items()},
                    "epoch": epoch, "hparams": {"lr": 2e-6}},
                   art / "checkpoints" /
                   f"epoch={epoch:02d}-validation_loss=1.2{epoch}.ckpt")
    newest = _latest_epoch_ckpt(str(art / "checkpoints"))
    assert newest.endswith("epoch=10-validation_loss=1.210.ckpt")

    loaded_cfg, sd = load_artifact(str(art), ARGS)
    assert loaded_cfg.num_labels == 7           # from id2label
    assert loaded_cfg.num_rel_labels == 5 and loaded_cfg.with_box_refine
    assert loaded_cfg.dropout == 0.0
    assert loaded_cfg.compute_dtype == "float32"
    _assert_bit_equal(sd, convert_detr_state_dict(sds[10], loaded_cfg))
    out = _forward(loaded_cfg, sd)
    assert torch.isfinite(out["pred_boxes"]).all()
    assert out["pred_rel"].shape[-1] == 5
    # one checkpoint by its path: the config one directory up
    _, by_path = load_artifact(newest, ARGS)
    _assert_bit_equal(by_path, sd)

    # the HF save_pretrained layout: no Lightning wrapper, no prefix
    bin_dir = tmp_path / "egtr__bin"
    bin_dir.mkdir()
    with open(bin_dir / "config.json", "w") as f:
        json.dump(_hf_config(cfg), f)
    torch.save({k: torch.from_numpy(v) for k, v in sds[3].items()},
               bin_dir / "pytorch_model.bin")
    bin_cfg, bin_sd = load_artifact(str(bin_dir), ARGS)
    _assert_bit_equal(bin_sd, convert_detr_state_dict(sds[3], bin_cfg))
    assert torch.isfinite(_forward(bin_cfg, bin_sd)["logits"]).all()

    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_artifact(str(tmp_path / "empty"), ARGS)
