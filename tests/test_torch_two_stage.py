"""``two_stage`` and ``use_remat`` in the port against the JAX package, on
the CPU.

Two-stage: the forward at d_model 64 (``tests/test_two_stage.py``'s config)
and at d_model 256 with 1+1 layers, on a padded batch of two whose second
image holds fewer valid tokens than there are proposals, so that the
proposal top-k meets ties (masked tokens all share one logit). The proposal
indices are compared first, then the outputs.

One float32 train step of a two-stage model with rematerialized layers
(``use_remat=True``, dropout 0) in JAX is the reference of the port's step
without remat and under both policies: loss terms, the ``_enc`` ones
included, and every gradient. At dropout 0.1 the port's gradients under
``"full"`` and ``"dots"`` equal, bit for bit, those without remat, and the
MSDA op runs once per layer under ``"dots"`` and twice under ``"full"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egtr_tpu.config import EgtrConfig as JaxConfig
from egtr_tpu.models.egtr import EgtrModel as JaxEgtrModel
from egtr_tpu.train import optim as jax_optim
from egtr_tpu.train import train_step as jax_train_step
from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.models import layers as port_layers
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.models.layers import init_params
from egtr_tpu_torch.ops import criterion
from egtr_tpu_torch.train.optim import make_optimizer
from egtr_tpu_torch.train.train_step import make_train_step
from egtr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_model import (ATOL, RTOL, jax_apply, jax_params,
                              port_from_jax, to_np)
from test_torch_train import LRS, make_batch, to_np_tree, to_torch

torch.set_num_threads(1)

# tests/test_two_stage.py's config
TWO_STAGE = dict(
    d_model=64, encoder_layers=1, decoder_layers=2, encoder_ffn_dim=64,
    decoder_ffn_dim=64, num_queries=12, num_labels=5, num_rel_labels=4,
    max_gt_boxes=3, two_stage=True, two_stage_num_proposals=12,
    with_box_refine=True, auxiliary_loss=True, dropout=0.0)
WIDE = dict(TWO_STAGE, d_model=256, encoder_layers=1, decoder_layers=1,
            encoder_ffn_dim=1024, decoder_ffn_dim=1024,
            two_stage_num_proposals=40)
FORWARD = {"d64": TWO_STAGE, "d256": WIDE}
COMPARED = ("logits", "pred_boxes", "enc_outputs_class",
            "enc_outputs_coord_logits", "pred_rel", "pred_connectivity")
# the train step's config: test_torch_train's batch (6 boxes, 8 relations)
STEP = dict(TWO_STAGE, num_labels=7, num_rel_labels=5, max_gt_boxes=6,
            max_gt_rels=8, use_remat=True)


def _padded_pair(seed, valid_hw=(16, 16)):
    """Two 64x96 images, the second valid only in its top-left corner:
    at 16x16 pixels 2x2 + 1 + 1 + 1 = 7 valid tokens."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    mask = np.ones(x.shape[:3], bool)
    mask[1, valid_hw[0]:] = False
    mask[1, :, valid_hw[1]:] = False
    x[1][~mask[1]] = 0.0
    return x, mask


@pytest.mark.parametrize("width", sorted(FORWARD))
def test_two_stage_forward_matches_jax(width):
    kw = FORWARD[width]
    k = kw["two_stage_num_proposals"]
    x, mask = _padded_pair(0)
    jm = JaxEgtrModel(JaxConfig(**kw))
    params = jax_params(jm, 1, jnp.asarray(x[:1]))
    ref = jax_apply(jm, params, jnp.asarray(x), jnp.asarray(mask))
    cfg = EgtrConfig(**kw)
    model = port_from_jax(EgtrModel(cfg), params, cfg)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(mask))

    # the proposals first: lax.top_k's order, ties (the second image's
    # masked tokens) to the lower index
    jidx = np.asarray(jax.lax.top_k(ref["enc_outputs_class"][..., 0], k)[1])
    np.testing.assert_array_equal(out["proposal_indices"].numpy(), jidx)
    scores = np.asarray(ref["enc_outputs_class"][1, :, 0])
    tied = scores[jidx[1]] == scores[jidx[1]].min()
    assert tied.sum() > 1, "the second image's proposals meet no tie"
    assert out["init_reference_points"].shape == (2, k, 4)
    for key in COMPARED:
        assert out[key].shape == ref[key].shape, key
        # masked and invalid tokens' boxes are +inf on both sides
        np.testing.assert_allclose(to_np(out[key]), np.asarray(ref[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)


@pytest.fixture(scope="module")
def remat_reference():
    """JAX's two-stage model with rematerialized layers: gradients and loss
    terms of one float32 microbatch of 2 at 64x96 (dropout 0)."""
    jcfg = JaxConfig(**STEP)
    jm = JaxEgtrModel(jcfg)
    batch = make_batch(0, 2)
    # test_torch_train's weights seed: at seeds 3 and 4 a ReLU input or an
    # MSDA sample lands within float32 round-off of its kink, in the
    # one-stage model as well, and one leaf's gradient takes the other
    # subgradient (up to 1.4e-2 of its largest entry)
    params = jax_params(jm, 1, jnp.asarray(batch["pixel_values"][:1]))
    # an accumulating step exposes its per-microbatch gradients
    step = jax_train_step.make_train_step(
        jm, jcfg, jax_optim.make_optimizer(**LRS), accum_steps=2)
    grads, total, losses = to_np_tree(step.grads_mb(
        jax.tree_util.tree_map(jnp.asarray, params), batch,
        jax.random.PRNGKey(0)))
    return {"params": params, "batch": batch, "grads": grads,
            "total": total, "losses": losses}


@pytest.mark.parametrize("remat", ["off", "full", "dots"])
def test_two_stage_train_step_matches_jax_remat(remat, remat_reference):
    """The port's step, without remat and under each policy, against JAX's
    rematerialized one: every loss term (the proposals' ``_enc`` losses and
    their weights included) and every gradient, as test_torch_train holds
    the one-stage step."""
    ref = remat_reference
    cfg = EgtrConfig(**STEP).replace(use_remat=remat != "off",
                                     remat_policy="full" if remat == "off"
                                     else remat)
    model = EgtrModel(cfg)
    model.load_state_dict(state_dict_from_jax(ref["params"], cfg),
                          strict=True)
    opt = make_optimizer(model, **LRS)
    metrics = make_train_step(model, cfg, opt)(to_torch(ref["batch"]))
    enc = {f"{k}_enc" for k in ("loss_ce", "loss_bbox", "loss_giou",
                                "cardinality_error")}
    assert enc <= set(ref["losses"])
    assert set(metrics) == set(ref["losses"]) | {"total_loss", "grad_norm"}
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(metrics[k].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(metrics["total_loss"].numpy(), ref["total"],
                               rtol=1e-4)
    # the total, JAX's weighted sum, holds the _enc terms' weights
    jgrads = state_dict_from_jax(ref["grads"], cfg)
    jnorm = np.sqrt(sum(float((g.double() ** 2).sum())
                        for g in jgrads.values()))
    np.testing.assert_allclose(metrics["grad_norm"].numpy(), jnorm, rtol=1e-4)
    for name, p in model.named_parameters():
        expect = jgrads[name] / jnorm * 0.1 if jnorm > 0.1 else jgrads[name]
        scale = max(float(expect.abs().max()), 1e-6)
        err = float((p.grad - expect).abs().max()) / scale
        assert err < 1e-3, (name, err)
    assert float(jgrads["model.enc_output.weight"].abs().max()) > 0


def _step_at_dropout(cfg, batch, calls):
    """Forward + backward of a model in train() mode at the config's dropout,
    its masks from a seeded generator: (total, gradients, the generator's
    state after); ``calls`` holds the MSDA calls of the backward."""
    model = EgtrModel(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(5)
    out = model.train()(batch["pixel_values"], batch["pixel_mask"], g)
    total, _ = criterion.sgg_criterion(out, batch["labels"], cfg, True,
                                       generator=g)
    calls.clear()
    total.backward()
    return total, {n: p.grad for n, p in model.named_parameters()}, \
        g.get_state()


@pytest.fixture(scope="module")
def at_dropout():
    """The step without remat at dropout 0.1, and a spy that counts the
    MSDA op's calls."""
    calls = []
    real = port_layers.ms_deform_attn

    def spy(*args, **kwargs):
        calls.append(None)
        return real(*args, **kwargs)

    port_layers.ms_deform_attn = spy
    try:
        batch = to_torch(make_batch(1, 2))
        base = EgtrConfig(**dict(STEP, two_stage=False, use_remat=False,
                                 dropout=0.1))
        yield base, batch, calls, _step_at_dropout(base, batch, calls), \
            len(calls)
    finally:
        port_layers.ms_deform_attn = real


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_at_dropout_equals_no_remat(policy, at_dropout):
    """At dropout 0.1 the recompute redraws the first run's masks from the
    step generator: gradients and loss bit-equal to the step without remat,
    the generator left where that step leaves it. The backward recomputes
    each layer's MSDA op under "full" and none under "dots"."""
    base, batch, calls, (total0, grads0, state0), base_calls = at_dropout
    assert base_calls == 0
    total, grads, state = _step_at_dropout(
        base.replace(use_remat=True, remat_policy=policy), batch, calls)
    layers = base.encoder_layers + base.decoder_layers
    assert len(calls) == (layers if policy == "full" else 0)
    assert torch.equal(total, total0)
    assert torch.equal(state, state0)
    for name, g in grads0.items():
        assert (g is None) == (grads[name] is None), name
        assert g is None or torch.equal(g, grads[name]), name
