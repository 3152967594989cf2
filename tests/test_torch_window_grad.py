"""The port's windowed (banded) MSDA gradient against the JAX package's, on
the CPU.

The plain banded backward (``msda.msda_bwd_win_plain``, what the CUDA
kernels K7-K10 are held against on the card) and the windowed autograd op
that runs it are held against ``jax.vjp`` of ``msda_pallas_win`` /
``msda_pallas_win_q`` with the banded backward kernels in interpret mode
(JAX ``impl="pallas"``, as tests/test_msda.py runs them); the "matmul" path's
gradient through its clamp against ``jax.vjp`` of the JAX matmul path; and
one whole-model microbatch gradient (``grads_mb``) of a windowed 2+2-layer
model against the port's. The JAX side is jitted once per case.

Band ties: the band indices are compared first, exactly (a tie in the
weighted mean would move a whole tile's band); the seeds keep the means off
the ties. Sampling points are drawn off the integer grid and off the clamp's
bounds, where the two frameworks' subgradients may differ.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egtr_tpu.config import EgtrConfig as JaxConfig
from egtr_tpu.models.egtr import EgtrModel as JaxEgtrModel
from egtr_tpu.ops import msda_pallas as jax_pallas
from egtr_tpu.ops import msda_window as jax_window
from egtr_tpu.ops.msda import ms_deform_attn as jax_msda
from egtr_tpu.train import optim as jax_optim
from egtr_tpu.train import train_step as jax_train_step
from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.ops import msda, msda_window
from egtr_tpu_torch.ops.criterion import sgg_criterion
from egtr_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_model import TINY, jax_params
from test_torch_window import raster_inputs

torch.set_num_threads(1)

# the CPU backend cannot reuse the donated train state; irrelevant here
pytestmark = pytest.mark.filterwarnings("ignore:Some donated buffers")

WIN = 8
# h = 19 with window 8: bands start at rows 0, 4, 8 and 12, and the last one
# overhangs the level by a row; (6, 4) is an exact level
SHAPES = ((19, 16), (6, 4))

# Tolerances, as |err| <= atol * max(1, max|ref|) + rtol * |ref| per output.
# float32: both sides sum the same products in another order. bfloat16: both
# round the same products (dT, the x hats) to bf16 and sum in float32;
# dvalue and daw are rounded once to bf16 from sums taken in another order
# (one bf16 step, 2**-8; allow two); dloc stays float32 but sums bf16-exact
# products of magnitude up to |V||g| * level size, where a different order
# of a cancelling sum moves the last bits of the largest entries.
TOL = {"float32": {"dvalue": (1e-5, 1e-4), "dloc": (2e-5, 1e-4),
                   "daw": (1e-5, 1e-4)},
       "bfloat16": {"dvalue": (2e-3, 2 * 2.0 ** -8), "dloc": (2e-4, 1e-4),
                    "daw": (2e-3, 2 * 2.0 ** -8)}}


def assert_grads_close(got, ref, dtype):
    for name, a, b in zip(("dvalue", "dloc", "daw"), got, ref):
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        assert a.shape == b.shape, name
        atol, rtol = TOL[dtype][name]
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=atol * max(1.0, np.abs(b).max()),
                                   err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_vjp(impl, band, int8, dtype):
    def vjp(v, l, a, g):
        fn = lambda v, l, a: jax_msda(v, SHAPES, l, a, impl=impl,  # noqa
                                      window=WIN, query_segments=SHAPES,
                                      band=band, int8=int8)
        return jax.vjp(fn, v, l, a)[1](g)
    return jax.jit(vjp)


def grad_inputs(seed, dtype):
    """Raster inputs (batch 2) with offsets of up to 3 pixels: within the
    window on most samples, clamped on some; and an output gradient."""
    value, loc, aw = raster_inputs(seed, SHAPES, B=2, max_offset_px=3.0)
    g = np.random.default_rng(seed + 1).standard_normal(
        (2, loc.shape[1], 16)).astype(np.float32)
    td = getattr(torch, dtype)
    tv, ta, tg = (torch.from_numpy(x).to(td) for x in (value, aw, g))
    return tv, torch.from_numpy(loc), ta, tg


def port_grads(tv, tl, ta, tg, impl="auto", band="point", int8=False):
    leaves = [x.clone().requires_grad_() for x in (tv, tl, ta)]
    out = msda.ms_deform_attn(leaves[0], SHAPES, leaves[1], leaves[2],
                              impl=impl, window=WIN, query_segments=SHAPES,
                              band=band, int8=int8)
    assert out.grad_fn is not None
    return torch.autograd.grad(out, leaves, tg)


def jax_grads(tv, tl, ta, tg, impl="pallas", band="point", int8=False):
    dtype = str(tv.dtype).split(".")[-1]
    jd = getattr(jnp, dtype)
    return _jax_vjp(impl, band, int8, dtype)(
        jnp.asarray(tv.float().numpy(), jd), jnp.asarray(tl.numpy()),
        jnp.asarray(ta.float().numpy(), jd), jnp.asarray(tg.float().numpy(), jd))


def jax_band_indices(tl, ta, band):
    locT, awT = jax_pallas._rows_t(jnp.asarray(tl.numpy()),
                                   jnp.asarray(ta.float().numpy()))
    segs = jax_window.segment_bounds(tl.shape[1], SHAPES)
    h, w = SHAPES[0]
    return np.asarray(jax_pallas._win_level_rows(
        locT[:, :, 0, 0], locT[:, :, 0, 1], awT[:, :, 0], h, w, WIN, segs,
        jax_window.query_tile(WIN, 8, w), band == "point")[0])


@pytest.mark.parametrize("band,dtype,int8", [
    ("tile", "float32", False), ("tile", "bfloat16", False),
    ("point", "float32", False), ("point", "bfloat16", False),
    ("point", "bfloat16", True), ("tile", "float32", True)])
def test_windowed_grad_matches_jax_vjp(band, dtype, int8):
    """The windowed autograd op (its backward is the plain banded backward on
    the CPU) against jax.vjp of msda_pallas_win(_q): one banded level with an
    overhanging last band and clamped samples, one exact level, batch 2.
    With int8 the gradient is the one without int8 (straight-through)."""
    tv, tl, ta, tg = grad_inputs(11, dtype)
    # the band choice first, exactly
    locT, awT = msda.rows_t(tl, ta)
    segs = msda_window.segment_bounds(tl.shape[1], SHAPES)
    bidx, _, _, _, _, inband, in_img = msda.win_level_rows(
        locT, awT, 0, *SHAPES[0], WIN, segs, 8, band == "point")
    np.testing.assert_array_equal(bidx.numpy(), jax_band_indices(tl, ta, band))
    # the share of the in-image samples whose row is clamped to the band
    clamped = (in_img & ~inband).sum().item() / in_img.sum().item()
    assert 0.05 < clamped < 0.9, clamped
    assert (bidx == len(msda_window.band_starts(19, WIN)) - 1).any()

    got = port_grads(tv, tl, ta, tg, band=band, int8=int8)
    assert [g.dtype for g in got] == [tv.dtype, torch.float32, ta.dtype]
    # the op's backward is the explicit plain banded backward
    explicit = msda._windowed_backward(tv, tl, ta, tg, SHAPES, WIN, SHAPES,
                                       band, False)
    for a, b in zip(got, explicit):
        assert torch.equal(a, b)
    assert_grads_close(got, jax_grads(tv, tl, ta, tg, band=band, int8=int8),
                       dtype)


@pytest.mark.parametrize("band", ["tile", "point"])
def test_windowed_matmul_grad_matches_jax(band):
    """impl="matmul": autograd through the clamp into the exact op's
    explicit backward, against JAX autodiff of its matmul path (float32,
    summation order). It is the banded function in float32, so the banded
    backward agrees with it to round-off as well."""
    tv, tl, ta, tg = grad_inputs(13, "float32")
    got = port_grads(tv, tl, ta, tg, impl="matmul", band=band)
    assert_grads_close(got, jax_grads(tv, tl, ta, tg, impl="matmul",
                                      band=band), "float32")
    banded = port_grads(tv, tl, ta, tg, impl="plain", band=band)
    for a, b in zip(got, banded):
        torch.testing.assert_close(
            a, b, rtol=1e-4, atol=1e-5 * max(1.0, b.abs().max().item()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("band", ["tile", "point"])
def test_int8_window_grads_equal_window_grads(band, dtype):
    """Straight-through (msda_pallas.py:1348): the int8 windowed forward has
    exactly the windowed backward."""
    tv, tl, ta, tg = grad_inputs(15, dtype)
    with_int8 = port_grads(tv, tl, ta, tg, band=band, int8=True)
    without = port_grads(tv, tl, ta, tg, band=band)
    for a, b in zip(with_int8, without):
        assert torch.equal(a, b)


def test_banded_backward_reach():
    """One sample per case, read through band 1 (rows 4..11) of a 24-row
    level: its value gradient lands on the absolute rows 4 + y, and a corner
    whose band-local row lies outside [0, 8) gets nothing. In the last band
    (rows 16..23 of 21) rows 21..23 do not exist."""
    h, w, win, D = 24, 4, 8, 2
    segs = ((0, 1),)
    value = torch.ones((1, h * w, 1, D))
    g = torch.ones((1, 1, D))
    ix = torch.full((1, 1, 1, 128), 1.0)       # on column 1
    aw = torch.ones((1, 1, 1, 128))
    for h_level, band, y_local, rows in (
            (24, 1, 0.25, {4: 0.75, 5: 0.25}), (24, 1, -0.5, {4: 0.5}),
            (24, 1, 7.5, {11: 0.5}), (24, 1, 8.0, {}), (24, 1, -1.0, {}),
            (21, 4, 4.5, {20: 0.5})):
        bidx = torch.full((1, 1, 1), band, dtype=torch.int32)
        iy = torch.full((1, 1, 1, 128), y_local)
        dv, dix, diy, daw = msda.msda_bwd_win_plain(
            value[:, :h_level * w], bidx, ix, iy, aw, g, h_level, w, win,
            segs, 1)
        assert dv.shape == (1, h_level * w, 1, D)
        expect = torch.zeros((h_level, w))
        for r, weight in rows.items():
            expect[r, 1] = weight
        torch.testing.assert_close(dv[0, :, 0, 0].reshape(h_level, w), expect)
        # the padding rows stay zero
        assert not dix[..., 1:].any() and not daw[..., 1:].any()
        assert daw[0, 0, 0, 0] == pytest.approx(D * sum(rows.values()))


def test_banded_backward_without_clamp_is_the_exact_backward():
    """Where every sample lies inside its band the banded backward is the
    exact one on the absolute coordinate (float32 round-off)."""
    shapes = ((10, 256),)
    value, loc, aw = raster_inputs(17, shapes, max_offset_px=1.0)
    tv, tl, ta = (torch.from_numpy(x) for x in (value, loc, aw))
    tg = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (1, 2560, 16)).astype(np.float32))
    exact = msda.ms_deform_attn_plain_bwd(tv, shapes, tl, ta, tg)
    banded = msda._windowed_backward(tv, tl, ta, tg, shapes, 8, shapes,
                                     "tile", False)
    for a, b in zip(banded, exact):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=2e-5)


# --------------------------------------------------------------------------
# one whole-model microbatch
# --------------------------------------------------------------------------

# the adaptation recipe's band and window at the tiny size: two feature
# levels (half the kernels to compile on the JAX side), (16,12) and (8,6) on
# a 128x96 image, so a window of 8 bands level 0 of the encoder's
# self-attention and leaves level 1 exact
MODEL_CFG = dict(TINY, max_gt_boxes=6, max_gt_rels=8, msda_window=WIN,
                 msda_band="point", num_feature_levels=2)
HW = (128, 96)


def make_batch(seed, B):
    rng = np.random.default_rng(seed)
    G, R, C = (MODEL_CFG["max_gt_boxes"], MODEL_CFG["num_rel_labels"],
               MODEL_CFG["num_labels"])
    rel = np.zeros((B, G, G, R), np.float32)
    rel[:, 0, 1, 1] = 1.0
    rel[:, 2, 3, 4] = 1.0
    cxcy = rng.uniform(0.3, 0.7, (B, G, 2))
    wh = rng.uniform(0.1, 0.4, (B, G, 2))
    return {
        "pixel_values": rng.standard_normal((B, *HW, 3)).astype(np.float32),
        "pixel_mask": np.ones((B, *HW), bool),
        "labels": {
            "class_labels": rng.integers(0, C, (B, G)).astype(np.int32),
            "boxes": np.concatenate([cxcy, wh], -1).astype(np.float32),
            "num_boxes": np.full((B,), 4, np.int32),
            "rel": rel,
        },
    }


def test_windowed_microbatch_grads_match_jax():
    """grads_mb of a windowed 2+2-layer float32 model (window 8, one band
    per point, dropout 0; the JAX side runs the Pallas kernels in interpret
    mode) against the port's forward + criterion + backward on the same
    bridged weights: every loss term to 1e-4, every gradient to 1e-3 of its
    largest entry (a ResNet, 2+2 layers and the criterion, summation
    order). A band index that differed between the two packages would move
    a whole tile's clamp, far beyond these limits."""
    jcfg = JaxConfig(**MODEL_CFG, msda_impl="pallas")
    cfg = EgtrConfig(**MODEL_CFG, msda_impl="pallas")
    jm = JaxEgtrModel(jcfg)
    batch = make_batch(0, 2)
    mb = jax_train_step.split_microbatches(batch, 2)[0]
    params = jax_params(jm, 1, jnp.asarray(mb["pixel_values"]))
    tx = jax_optim.make_optimizer(lr=2e-3, lr_backbone=2e-4,
                                  lr_initialized=2e-2)
    step = jax_train_step.make_train_step(jm, jcfg, tx, accum_steps=2)
    grads, total, losses = jax.tree_util.tree_map(
        np.asarray, step.grads_mb(jax.tree_util.tree_map(jnp.asarray, params),
                                  mb, jax.random.PRNGKey(0)))

    model = EgtrModel(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    model.train()
    msda.band_index_log = log = []
    try:
        out = model(torch.from_numpy(np.array(mb["pixel_values"])),
                    torch.from_numpy(np.array(mb["pixel_mask"])))
    finally:
        msda.band_index_log = None
    labels = {k: torch.from_numpy(np.array(v))
              for k, v in mb["labels"].items()}
    port_total, port_losses = sgg_criterion(out, labels, cfg, train=True)
    port_total.backward()

    assert [lid for lid, _ in log] == [0] * cfg.encoder_layers
    assert all(b.dim() == 4 for _, b in log)
    for name, v in losses.items():
        if name.startswith("rel_gate_"):
            continue
        np.testing.assert_allclose(port_losses[name].detach().numpy(), v,
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(port_total.item(), total, rtol=1e-4)
    jgrads = state_dict_from_jax(grads, cfg)
    worst = 0.0
    for name, p in model.named_parameters():
        expect = jgrads[name]
        got = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(float(expect.abs().max()), 1e-6)
        err = float((got - expect).abs().max()) / scale
        worst = max(worst, err)
        assert err < 1e-3, (name, err)
    assert worst > 0.0
    # the sampling offsets of the encoder saw the banded backward
    offsets = model.model.encoder_layer_0.self_attn.sampling_offsets.weight
    assert offsets.grad.abs().max() > 0
