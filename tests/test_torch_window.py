"""The port's banded and int8 MSDA against the JAX package's, on the CPU.

Geometry (``msda_window.py``) is held to the JAX functions value for value;
``window_rows`` on the band indices exactly and on the rest to round-off; the
plain versions that stand beside the CUDA kernels K4 (int8 stage 1), K5 and
K6 (banded forward, one band per tile or per point) to the Pallas kernels in
interpret mode (JAX ``impl="pallas"``, as tests/test_msda.py runs them) and
the windowed matmul oracle to JAX ``impl="matmul"``. The JAX side is jitted.

Band ties: a band index is ``round()`` of a float32 mean that torch and XLA
sum in different orders, so a mean within an ulp of n + 0.5 would pick
another band for a whole tile. The seeds here keep the means off the ties;
the band indices are compared first, exactly, and only then the outputs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egtr_tpu.ops import msda_pallas as jax_pallas
from egtr_tpu.ops import msda_window as jax_window
from egtr_tpu.ops.msda import ms_deform_attn as jax_msda
from egtr_tpu_torch.ops import msda, msda_cuda
from egtr_tpu_torch.ops import msda_window as window

torch.set_num_threads(1)

# float32: summation order only (tests/test_msda.py:226)
ATOL, RTOL = 1e-5, 1e-4
# bfloat16 output: one rounding of a float32 sum taken in another order is a
# relative step of 2**-8; allow two
BF16_ATOL, BF16_RTOL = 1e-3, 2 * 2.0 ** -8

SHAPES = ((24, 16), (12, 8), (6, 4))
WIN = 8


def raster_inputs(seed, shapes=SHAPES, B=1, H=2, D=8, P=4, max_offset_px=1.0):
    """Encoder-like inputs (tests/test_msda.py:make_raster_inputs): the
    queries are the raster tokens of ``shapes``, reference points on their
    own pixel centres, offsets of at most ``max_offset_px``."""
    rng = np.random.default_rng(seed)
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = rng.standard_normal((B, S, H, D)).astype(np.float32)
    refs = []
    for (h, w) in shapes:
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        refs.append(np.stack([(xx.ravel() + 0.5) / w,
                              (yy.ravel() + 0.5) / h], -1))
    ref = np.concatenate(refs, 0)
    wh = np.array([[w, h] for (h, w) in shapes], np.float32)
    off = rng.uniform(-max_offset_px, max_offset_px,
                      (B, S, H, L, P, 2)).astype(np.float32)
    loc = ref[None, :, None, None, None, :] + off / wh[None, None, None, :,
                                                       None, :]
    aw = rng.uniform(0, 1, size=(B, S, H, L * P)).astype(np.float32)
    aw = (aw / aw.sum(-1, keepdims=True)).reshape(B, S, H, L, P)
    return value, loc.astype(np.float32), aw


def random_inputs(seed, shapes=SHAPES, B=2, Q=None, H=2, D=8, P=4):
    """Non-local samples that roam outside [0, 1]: most of them clamp."""
    rng = np.random.default_rng(seed)
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    Q = S if Q is None else Q
    value = rng.standard_normal((B, S, H, D)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, size=(B, Q, H, L, P, 2)).astype(np.float32)
    aw = rng.uniform(0, 1, size=(B, Q, H, L * P)).astype(np.float32)
    aw = (aw / aw.sum(-1, keepdims=True)).reshape(B, Q, H, L, P)
    return value, loc, aw


def t(*arrays, dtype=None):
    out = tuple(torch.from_numpy(np.asarray(a)) for a in arrays)
    return out if dtype is None else tuple(x.to(dtype) for x in out)


@functools.lru_cache(maxsize=None)
def _jitted(shapes, impl, window, band, int8):
    segs = shapes if window else None
    return jax.jit(lambda v, l, a: jax_msda(
        v, shapes, l, a, impl=impl, window=window, query_segments=segs,
        int8=int8, band=band))


def jax_op(value, shapes, loc, aw, impl="pallas", window=0, band="tile",
           int8=False, dtype=jnp.float32):
    out = _jitted(tuple(shapes), impl, window, band, int8)(
        jnp.asarray(value, dtype), jnp.asarray(loc), jnp.asarray(aw, dtype))
    return np.asarray(out.astype(jnp.float32))


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

GEOMETRY = [(h, w, win, D)
            for (h, w) in ((76, 126), (38, 63), (19, 32), (10, 16),
                           (100, 168), (50, 84), (25, 42), (13, 21),
                           (24, 16), (12, 8), (9, 1), (33, 300))
            for win in (2, 8, 16, 32)
            for D in (8, 32, 128)]


def test_geometry_matches_jax():
    for h, w, win, D in GEOMETRY:
        assert window.query_tile(win, D, w) == jax_window.query_tile(win, D, w)
        assert window.band_starts(h, win) == jax_window.band_starts(h, win)
        assert window.band_stride(win) == jax_window.band_stride(win)
        for n_bufs in (3, 8):
            assert window.fit_tile(win * D, n_bufs) == jax_window.fit_tile(
                win * D, n_bufs)
    # the serving bucket's tiles for window 16, D 32
    assert [window.query_tile(16, 32, w) for w in (126, 63, 32)] == [
        256, 128, 128]
    for Q, segs in ((20, None), (504, ((24, 16), (12, 8), (6, 4)))):
        assert window.segment_bounds(Q, segs) == jax_window.segment_bounds(
            Q, segs)
    with pytest.raises(ValueError, match="cover 504 queries"):
        window.segment_bounds(500, SHAPES)
    assert window.padded_starts(((0, 384), (384, 96), (480, 24)), 128) == (
        0, 384, 512, 640)


def test_segmenting_matches_jax():
    rng = np.random.default_rng(0)
    segs = window.segment_bounds(504, SHAPES)
    rows = rng.standard_normal((2, 3, 4, 504)).astype(np.float32)
    ours = window.segment_rows_t(torch.from_numpy(rows), segs, 128)
    ref = jax_window.segment_rows_t(jnp.asarray(rows), segs, 128)
    assert ours.shape == ref.shape == (2, 3, 4, 640)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        window.unsegment_rows(ours, segs, 128).numpy(),
        np.asarray(jax_window.unsegment_rows(ref, segs, 128)))
    np.testing.assert_array_equal(
        window.unsegment_cols(ours, segs, 128).numpy(), rows)


@pytest.mark.parametrize("per_point", [False, True], ids=["tile", "point"])
@pytest.mark.parametrize("case", ["raster", "random", "top_bottom"])
def test_window_rows_matches_jax(case, per_point):
    """bidx exactly; iy_band, iy_clamped, aw_eff to 1e-6; the masks exactly."""
    h, w, TQ = 24, 16, 128
    rng = np.random.default_rng(5)
    if case == "raster":
        _, loc, aw = raster_inputs(5, ((h, w),), H=2, max_offset_px=3.0)
        iy = loc[..., 1] * h - 0.5                           # [B,Q,H,1,P]
    elif case == "random":
        _, loc, aw = random_inputs(6, ((h, w),), B=2)
        iy = loc[..., 1] * h - 0.5
    else:
        # whole tiles hugging the first and the last rows, partly outside
        aw = rng.uniform(0.1, 1, (1, h * w, 2, 1, 4)).astype(np.float32)
        iy = rng.uniform(-1.5, 2.0, (1, h * w, 2, 1, 4)).astype(np.float32)
        iy[:, 128:] = rng.uniform(h - 3.0, h + 0.5, iy[:, 128:].shape)
    segs = window.segment_bounds(h * w, ((h, w),))
    iy_rows = np.ascontiguousarray(iy[:, :, :, 0].transpose(0, 2, 3, 1))
    aw_rows = np.ascontiguousarray(aw[:, :, :, 0].transpose(0, 2, 3, 1))
    ours = window.window_rows(
        window.segment_rows_t(torch.from_numpy(iy_rows), segs, TQ),
        window.segment_rows_t(torch.from_numpy(aw_rows), segs, TQ),
        h, WIN, TQ, per_point)
    ref = jax.jit(lambda a, b: jax_window.window_rows(
        jax_window.segment_rows_t(a, segs, TQ),
        jax_window.segment_rows_t(b, segs, TQ), h, WIN, TQ, per_point))(
            jnp.asarray(iy_rows), jnp.asarray(aw_rows))
    assert ours[0].dtype == torch.int32
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    if case != "random":  # uniform samples centre every tile's mean
        assert len(np.unique(ours[0].numpy())) > 1
    for a, b in zip(ours[1:4], ref[1:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    for a, b in zip(ours[4:], ref[4:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if case == "top_bottom":
        # the image-edge exception: no clamp above row 0 nor below row h-1
        iy_c = ours[2].numpy()
        assert iy_c.min() < 0 and iy_c.max() > h - 1


# --------------------------------------------------------------------------
# the banded plain forward (beside K5, K6) and the matmul oracle
# --------------------------------------------------------------------------

@pytest.mark.parametrize("band", ["tile", "point"])
@pytest.mark.parametrize("case", ["raster", "random"])
def test_banded_plain_matches_jax_pallas(case, band):
    make = raster_inputs if case == "raster" else random_inputs
    value, loc, aw = make(21, max_offset_px=3.0) if case == "raster" else make(22)
    ref = jax_op(value, SHAPES, loc, aw, "pallas", WIN, band)
    tv, tl, ta = t(value, loc, aw)
    msda.band_index_log = log = []
    try:
        out = msda.ms_deform_attn(tv, SHAPES, tl, ta, impl="auto", window=WIN,
                                  query_segments=SHAPES, band=band)
    finally:
        msda.band_index_log = None
    # levels (24,16) and (12,8) are banded, (6,4) is exact
    assert [lid for lid, _ in log] == [0, 1]
    assert log[0][1].dim() == (4 if band == "point" else 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    # and it is an approximation: the exact op differs where samples clamp
    exact = msda.ms_deform_attn_plain(tv, SHAPES, tl, ta)
    assert (out - exact).abs().max() > 1e-3


@pytest.mark.parametrize("band", ["tile", "point"])
def test_band_indices_match_jax(band):
    """The band choice of every banded level equals the JAX package's."""
    value, loc, aw = raster_inputs(23, max_offset_px=3.0)
    tv, tl, ta = t(value, loc, aw)
    msda.band_index_log = log = []
    try:
        msda.ms_deform_attn(tv, SHAPES, tl, ta, window=WIN,
                            query_segments=SHAPES, band=band)
    finally:
        msda.band_index_log = None
    locT, awT = jax_pallas._rows_t(jnp.asarray(loc), jnp.asarray(aw))
    segs = jax_window.segment_bounds(loc.shape[1], SHAPES)
    for lid, bidx in log:
        h, w = SHAPES[lid]
        ref = jax_pallas._win_level_rows(
            locT[:, :, lid, 0], locT[:, :, lid, 1], awT[:, :, lid], h, w, WIN,
            segs, jax_window.query_tile(WIN, 8, w), band == "point")[0]
        np.testing.assert_array_equal(bidx.numpy(), np.asarray(ref))


@pytest.mark.parametrize("band", ["tile", "point"])
def test_windowed_matmul_oracle_matches_jax(band):
    value, loc, aw = random_inputs(24)
    ref = jax_op(value, SHAPES, loc, aw, "matmul", WIN, band)
    tv, tl, ta = t(value, loc, aw)
    out = msda.ms_deform_attn(tv, SHAPES, tl, ta, impl="matmul", window=WIN,
                              query_segments=SHAPES, band=band)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    # the oracle never sees a band; the banded plain forward takes its hats
    # on the band-local coordinate: equal to float32 round-off
    banded = msda.ms_deform_attn(tv, SHAPES, tl, ta, impl="plain", window=WIN,
                                 query_segments=SHAPES, band=band)
    np.testing.assert_allclose(banded.numpy(), out.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("band", ["tile", "point"])
def test_banded_plain_matches_jax_bf16(band):
    value, loc, aw = raster_inputs(25, max_offset_px=3.0)
    tv, ta = t(value, aw, dtype=torch.bfloat16)
    (tl,) = t(loc)
    ref = jax_op(tv.float().numpy(), SHAPES, loc, ta.float().numpy(),
                 "pallas", WIN, band, dtype=jnp.bfloat16)
    out = msda.ms_deform_attn(tv, SHAPES, tl, ta, window=WIN,
                              query_segments=SHAPES, band=band)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=BF16_ATOL,
                               rtol=BF16_RTOL)


def test_inband_samples_are_exact():
    """tests/test_msda.py:198: a wide level whose tiles span two raster rows
    keeps every sample inside its band."""
    shapes = ((10, 256),)
    value, loc, aw = raster_inputs(26, shapes, max_offset_px=1.0)
    tv, tl, ta = t(value, loc, aw)
    exact = msda.ms_deform_attn_plain(tv, shapes, tl, ta)
    for impl in ("auto", "matmul"):
        out = msda.ms_deform_attn(tv, shapes, tl, ta, impl=impl, window=8,
                                  query_segments=shapes)
        np.testing.assert_allclose(out.numpy(), exact.numpy(), atol=ATOL,
                                   rtol=RTOL)


def test_per_point_bands_beat_tile():
    """tests/test_msda.py:279: constant per-point offsets of -12/-4/+4/+10
    rows stay exact with one band per point and must clamp with one band per
    tile."""
    h, w, H, D, P = 32, 256, 2, 8, 4
    shapes = ((h, w),)
    Q = h * w
    rng = np.random.default_rng(27)
    value = rng.standard_normal((1, Q, H, D)).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ref = np.stack([(xx.ravel() + 0.5) / w, (yy.ravel() + 0.5) / h], -1)
    off = np.zeros((1, Q, H, 1, P, 2), np.float32)
    off[..., 1] = np.array([-12.0, -4.0, 4.0, 10.0], np.float32) / h
    off[..., 0] = rng.uniform(-1, 1, (1, Q, H, 1, P)) / w
    loc = (ref[None, :, None, None, None, :] + off).astype(np.float32)
    aw = rng.uniform(0.1, 1, size=(1, Q, H, P)).astype(np.float32)
    aw = (aw / aw.sum(-1, keepdims=True)).reshape(1, Q, H, 1, P)
    tv, tl, ta = t(value, loc, aw)
    exact = msda.ms_deform_attn_plain(tv, shapes, tl, ta)
    point = msda.ms_deform_attn(tv, shapes, tl, ta, window=8,
                                query_segments=shapes, band="point")
    np.testing.assert_allclose(point.numpy(), exact.numpy(), atol=ATOL,
                               rtol=RTOL)
    tile = msda.ms_deform_attn(tv, shapes, tl, ta, window=8,
                               query_segments=shapes, band="tile")
    assert (tile - exact).abs().max() > 1e-3


@pytest.mark.parametrize("band", ["tile", "point"])
def test_narrow_level_small_window_is_exact(band):
    """tests/test_msda.py:377: the row-budget cap shrinks the tile on a
    narrow level so that sub-pixel offsets never clamp."""
    shapes = ((32, 64),)
    value, loc, aw = raster_inputs(28, shapes, max_offset_px=0.5)
    tv, tl, ta = t(value, loc, aw)
    out = msda.ms_deform_attn(tv, shapes, tl, ta, window=8,
                              query_segments=shapes, band=band)
    exact = msda.ms_deform_attn_plain(tv, shapes, tl, ta)
    np.testing.assert_allclose(out.numpy(), exact.numpy(), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("impl", ["auto", "matmul"])
def test_out_of_image_is_zero(impl):
    """tests/test_msda.py:395: the clamp must not resurrect a sample the
    exact path drops."""
    shapes = ((16, 16),)
    value = torch.from_numpy(np.random.default_rng(29).standard_normal(
        (1, 256, 1, 8)).astype(np.float32))
    loc = torch.full((1, 256, 1, 1, 1, 2), -5.0)
    aw = torch.ones((1, 256, 1, 1, 1))
    out = msda.ms_deform_attn(value, shapes, loc, aw, impl=impl, window=8,
                              query_segments=shapes)
    assert out.abs().max() <= 1e-7


def test_window_geq_height_is_the_exact_op():
    """tests/test_msda.py:410: no level is banded, so the call is the exact
    op, bit for bit, gradient included."""
    shapes = ((6, 9), (3, 5))
    value, loc, aw = random_inputs(30, shapes, B=1, Q=20)
    tv, tl, ta = t(value, loc, aw)
    exact = msda.ms_deform_attn(tv, shapes, tl, ta)
    out = msda.ms_deform_attn(tv, shapes, tl, ta, window=64,
                              query_segments=shapes)
    assert torch.equal(out, exact)
    leaf = tv.clone().requires_grad_()
    msda.ms_deform_attn(leaf, shapes, tl, ta, window=64,
                        query_segments=shapes).sum().backward()
    assert leaf.grad is not None and leaf.grad.abs().max() > 0


def test_overhanging_last_band_reads_zeros():
    """h = 21, window 8: the last band starts at row 16 and overhangs the
    level by three rows, which read as zero."""
    shapes = ((21, 16),)
    assert window.band_starts(21, 8)[-1] + 8 > 21
    value, loc, aw = random_inputs(31, shapes, B=1)
    ref = jax_op(value, shapes, loc, aw, "pallas", 8, "point")
    tv, tl, ta = t(value, loc, aw)
    out = msda.ms_deform_attn(tv, shapes, tl, ta, window=8,
                              query_segments=shapes, band="point")
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_band_local_reach():
    """A corner whose band-local row lies outside [0, win) is dropped even
    where the absolute row exists: the kernels cannot reach it."""
    h, w, win = 24, 4, 8
    value = torch.ones((1, h * w, 1, 2))
    segs = window.segment_bounds(h * w, ((h, w),))
    Qp = 128
    ix = torch.full((1, 1, 1, Qp), 1.0)
    aw = torch.ones((1, 1, 1, Qp))
    bidx = torch.ones((1, 1, 1), dtype=torch.int32)          # rows 4..11
    for y_local, expect in ((-0.5, 0.5), (0.0, 1.0), (7.0, 1.0), (7.5, 0.5),
                            (8.0, 0.0), (-1.0, 0.0)):
        iy = torch.full((1, 1, 1, Qp), y_local)
        out = msda.msda_fwd_win_plain(value, bidx, ix, iy, aw, h, w, win,
                                      segs, h * w)
        assert out.shape == (1, h * w, 2)
        torch.testing.assert_close(out, torch.full_like(out, expect))


# --------------------------------------------------------------------------
# int8 stage 1 (beside K4)
# --------------------------------------------------------------------------

def test_quantized_values_match_jax_bit_for_bit():
    value, _, _ = random_inputs(40)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        tv = torch.from_numpy(value).to(dtype)
        vq, scale = msda.quantize_levels(tv, SHAPES)
        assert vq.dtype == torch.int8 and vq.shape == tv.shape
        assert scale.shape == (2, 2, 3) and scale.dtype == torch.float32
        start = 0
        for lid, (h, w) in enumerate(SHAPES):
            level = jnp.asarray(tv[:, start:start + h * w].float().numpy(),
                                jdtype)
            one = jnp.ones((2, 2, 1, 1), jnp.float32)
            ref_q, _, _, ref_s = jax.jit(jax_pallas._quantize_level)(
                jax_pallas._vtt(level, h, w), one, one, one)
            ours = jax_pallas._vtt(
                jnp.asarray(vq[:, start:start + h * w].numpy()), h, w)
            np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref_q))
            # XLA may turn the division by 127 * 127 into a product with
            # its reciprocal: one float32 rounding
            np.testing.assert_allclose(
                scale[:, :, lid].numpy(), np.asarray(ref_s)[:, :, 0, 0],
                rtol=2e-7, atol=0)
            start += h * w
        assert int(vq.abs().max()) == 127


@pytest.mark.parametrize("window,band", [(0, "tile"), (WIN, "tile"),
                                         (WIN, "point")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_plain_matches_jax_pallas(window, band, dtype):
    """msda_pallas_q (window 0) and msda_pallas_win_q: the integer stage is
    the same, the float32 fold differs in summation order."""
    value, loc, aw = raster_inputs(41, max_offset_px=3.0)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    tv, ta = t(value, aw, dtype=td)
    (tl,) = t(loc)
    ref = jax_op(tv.float().numpy(), SHAPES, loc, ta.float().numpy(),
                 "pallas", window, band, int8=True, dtype=jd)
    out = msda.ms_deform_attn(tv, SHAPES, tl, ta, window=window,
                              query_segments=SHAPES if window else None,
                              int8=True, band=band)
    assert out.dtype == td
    tol = (dict(atol=ATOL, rtol=RTOL) if dtype == "float32"
           else dict(atol=BF16_ATOL, rtol=BF16_RTOL))
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)
    if window == 0:
        torch.testing.assert_close(
            out, msda.ms_deform_attn_plain_q(tv, SHAPES, tl, ta), atol=0,
            rtol=0)


def test_int8_quantizes_the_y_hats_on_a_flipped_level():
    """(96,130) with D=8 contracts y in the JAX kernel: there the y hats are
    the 7-bit ones, in float32 too."""
    shapes = ((96, 130), (3, 3))
    assert jax_pallas._orient(96, 130, 8) == "y" == msda._orient(96, 130, 8)
    value, loc, aw = random_inputs(42, shapes, B=1, Q=40, H=1)
    ref = jax_op(value, shapes, loc, aw, "pallas", int8=True)
    out = msda.ms_deform_attn(*t(value), shapes, *t(loc, aw), int8=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_int8_exactly_representable_inputs():
    """tests/test_msda.py:423: values that are multiples of the scale and
    coordinates that are multiples of 1/127 pixel quantize without loss."""
    rng = np.random.default_rng(43)
    shapes = ((12, 10),)
    B, Q, H, D, P = 1, 6, 2, 8, 4
    s = 0.03125
    value = (rng.integers(-127, 128, (B, 120, H, D)) * s).astype(np.float32)
    value[0, 0, :, 0] = 127 * s
    k = rng.integers(0, 127 * 12, (B, Q, H, 1, P, 2)).astype(np.float32)
    loc = ((k / 127.0 + 0.5) / np.array([10.0, 12.0], np.float32)).astype(
        np.float32)
    aw = rng.uniform(0, 1, size=(B, Q, H, P)).astype(np.float32)
    aw = (aw / aw.sum(-1, keepdims=True)).reshape(B, Q, H, 1, P)
    tv, tl, ta = t(value, loc, aw)
    exact = msda.ms_deform_attn(tv, shapes, tl, ta)
    q = msda.ms_deform_attn(tv, shapes, tl, ta, int8=True)
    np.testing.assert_allclose(q.numpy(), exact.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [0, WIN])
def test_int8_error_bound(window):
    """tests/test_msda.py:446: the quantization error stays small against
    the output scale."""
    value, loc, aw = random_inputs(44)
    tv, tl, ta = t(value, loc, aw)
    kw = dict(window=window, query_segments=SHAPES if window else None)
    exact = msda.ms_deform_attn(tv, SHAPES, tl, ta, **kw)
    q = msda.ms_deform_attn(tv, SHAPES, tl, ta, int8=True, **kw)
    assert (q - exact).abs().max() < 0.05 * exact.abs().max()
    assert (q - exact).abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_int8_gradients_are_the_exact_ops(dtype):
    """Straight-through (msda_pallas.py:1156): the int8 forward with the
    exact op's backward."""
    shapes = ((6, 9), (3, 5))
    value, loc, aw = random_inputs(45, shapes, B=1, Q=16)
    tv, ta = t(value, aw, dtype=dtype)
    (tl,) = t(loc)
    g = torch.from_numpy(np.random.default_rng(46).standard_normal(
        (1, 16, 16)).astype(np.float32)).to(dtype)
    grads = {}
    for int8 in (False, True):
        leaves = [x.clone().requires_grad_() for x in (tv, tl, ta)]
        out = msda.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2],
                                  int8=int8)
        torch.testing.assert_close(
            out, (msda.ms_deform_attn_plain_q if int8 else
                  msda.ms_deform_attn_plain)(tv, shapes, tl, ta),
            atol=0, rtol=0)
        grads[int8] = torch.autograd.grad(out, leaves, g)
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)
    ref = msda.ms_deform_attn_plain_bwd(tv, shapes, tl, ta, g)
    for a, b in zip(grads[True], ref):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# refusals and dispatch
# --------------------------------------------------------------------------

def test_refusals():
    value, loc, aw = random_inputs(50)
    tv, tl, ta = t(value, loc, aw)
    with pytest.raises(ValueError, match="even window"):
        msda.ms_deform_attn(tv, SHAPES, tl, ta, window=7,
                            query_segments=SHAPES)
    with pytest.raises(ValueError, match="requires query_segments"):
        msda.ms_deform_attn(tv, SHAPES, tl, ta, window=8)
    with pytest.raises(ValueError, match="'tile' or 'point'"):
        msda.ms_deform_attn(tv, SHAPES, tl, ta, window=8,
                            query_segments=SHAPES, band="row")
    for impl in ("matmul", "gather"):
        with pytest.raises(ValueError, match="int8 stage-1"):
            msda.ms_deform_attn(tv, SHAPES, tl, ta, impl=impl, int8=True)
    with pytest.raises(ValueError, match="gather path"):
        msda.ms_deform_attn(tv, SHAPES, tl, ta, impl="gather", window=8,
                            query_segments=SHAPES)
    with pytest.raises(ValueError, match="cover"):
        msda.ms_deform_attn(tv, SHAPES, tl[:, :100], ta[:, :100], window=8,
                            query_segments=SHAPES)


# int8 with "matmul" is refused. The reference: the explicit banded backward
# (what the autograd op runs), bit for bit; int8 has the gradient without
# int8 (straight-through). "matmul" differentiates through its clamp into
# the exact op's backward: in float32 the same function, so equal to
# round-off (ATOL relative to each gradient's largest entry, RTOL).
@pytest.mark.parametrize("impl,int8", [
    ("auto", False), ("auto", True), ("plain", False), ("plain", True),
    ("matmul", False)])
def test_gradient_of_a_windowed_call(impl, int8):
    value, loc, aw = random_inputs(51)
    tv, tl, ta = t(value, loc, aw)
    g = torch.from_numpy(np.random.default_rng(52).standard_normal(
        (2, 504, 16)).astype(np.float32))
    leaves = [x.clone().requires_grad_() for x in (tv, tl, ta)]
    out = msda.ms_deform_attn(leaves[0], SHAPES, leaves[1], leaves[2],
                              impl=impl, window=8, query_segments=SHAPES,
                              int8=int8)
    grads = torch.autograd.grad(out, leaves, g)
    ref = msda._windowed_backward(tv, tl, ta, g, SHAPES, 8, SHAPES, "tile",
                                  False)
    for a, b in zip(grads, ref):
        assert torch.isfinite(a).all() and a.abs().max() > 0
        if impl == "matmul":
            torch.testing.assert_close(
                a, b, rtol=RTOL, atol=ATOL * max(1.0, b.abs().max().item()))
        else:
            assert torch.equal(a, b)
    with torch.no_grad():
        again = msda.ms_deform_attn(tv, SHAPES, tl, ta, impl=impl, window=8,
                                    query_segments=SHAPES, int8=int8)
    assert again.grad_fn is None and torch.equal(again, out.detach())


def test_cpu_dispatch_launches_no_kernel():
    value, loc, aw = random_inputs(52)
    tv, tl, ta = t(value, loc, aw)
    names = ("msda_fwd", "msda_fwd_q", "msda_fwd_win", "msda_fwd_win_pp")
    before = [msda_cuda.launches[n] for n in names]
    for band in ("tile", "point"):
        for int8 in (False, True):
            msda.ms_deform_attn(tv, SHAPES, tl, ta, window=8,
                                query_segments=SHAPES, band=band, int8=int8)
    msda.ms_deform_attn(tv, SHAPES, tl, ta, int8=True)
    assert [msda_cuda.launches[n] for n in names] == before


def test_new_wrappers_refuse_cpu_tensors_and_bad_inputs():
    """The wrappers launch their kernel or raise: no fallback."""
    value, loc, aw = random_inputs(53, B=1)
    tv, tl, ta = t(value, loc, aw)
    vq, scale = msda.quantize_levels(tv, SHAPES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.msda_fwd_q(vq, scale, SHAPES, tl, ta)
    msda_cuda.check_inputs_q(vq, scale, SHAPES, tl, ta)
    with pytest.raises(TypeError, match="vq must be int8"):
        msda_cuda.check_inputs_q(tv, scale, SHAPES, tl, ta)
    with pytest.raises(ValueError, match="scale must be"):
        msda_cuda.check_inputs_q(vq, scale[:, :, :2], SHAPES, tl, ta)
    with pytest.raises(ValueError, match="levels must be"):
        msda_cuda._check_levels((0, 0), 3)
    with pytest.raises(ValueError, match="levels must be"):
        msda_cuda._check_levels((3,), 3)

    h, w = SHAPES[0]
    segs = window.segment_bounds(504, SHAPES)
    rows = torch.zeros((1, 2, 4, 640))
    bidx = torch.zeros((1, 2, 5), dtype=torch.int32)
    level = tv[:, :h * w]
    args = (level, bidx, rows, rows, rows, h, w, 8, segs, 504)
    for fn in (msda_cuda.msda_fwd_win, msda_cuda.msda_fwd_win_pp):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args)
    assert msda_cuda.check_inputs_win(*args, per_point=False) == 128
    pp = torch.zeros((1, 2, 4, 5), dtype=torch.int32)
    assert msda_cuda.check_inputs_win(level, pp, *args[2:],
                                      per_point=True) == 128
    bad = {
        "bidx must be int32": dict(bidx=bidx.long()),
        "bidx must be": dict(bidx=pp),
        "even window": dict(win=7),
        "window below its height": dict(win=24),
        "iy_band must be": dict(iy_band=rows[..., :512]),
        "do not give": dict(Q=500),
        "value_l must be": dict(value_l=tv[:, :100]),
        "float32, bfloat16 or int8": dict(value_l=level.double()),
    }
    names = ("value_l", "bidx", "ix", "iy_band", "aw_eff", "h", "w", "win",
             "segs", "Q")
    for match, change in bad.items():
        kw = dict(zip(names, args), per_point=False)
        kw.update(change)
        with pytest.raises((TypeError, ValueError), match=match):
            msda_cuda.check_inputs_win(**kw)


def test_new_sources_and_counters():
    """Six sources, eleven kernels: each exported function belongs to one
    library and has a launch count of its own."""
    assert sorted(msda_cuda.sources()) == ["msda_bwd", "msda_bwd_win",
                                           "msda_fwd", "msda_fwd_bp",
                                           "msda_fwd_q", "msda_fwd_win"]
    owners = {fn: lib for fn, (lib, _) in msda_cuda._FUNCTIONS.items()}
    assert owners["msda_fwd_q"] == "msda_fwd_q"
    assert owners["msda_fwd_win"] == owners["msda_fwd_win_pp"] == "msda_fwd_win"
    assert {owners[f"msda_bwd_win_{k}"] for k in (
        "rows", "rows_pp", "value", "value_pp")} == {"msda_bwd_win"}
    # K11's own kernel serves its float32 form alone (BP_ROUTES)
    assert owners["msda_fwd_bp"] == "msda_fwd_bp"
    assert "msda_fwd_bp_q" not in owners
    for fn, lib in owners.items():
        text = msda_cuda.sources()[lib].read_text()
        assert f'extern "C" int {fn}(' in text, fn
        # one C parameter per declared ctypes argument
        decl = text[text.index(f'extern "C" int {fn}('):]
        decl = decl[:decl.index(")")]
        assert decl.count(",") + 1 == len(msda_cuda._FUNCTIONS[fn][1]), fn
    for name in ("msda_fwd_q", "msda_fwd_win", "msda_fwd_win_pp",
                 "msda_bwd_win_rows", "msda_bwd_win_rows_pp",
                 "msda_bwd_win_value", "msda_bwd_win_value_pp",
                 "msda_fwd_bp"):
        assert isinstance(msda_cuda.launches[name], int)
