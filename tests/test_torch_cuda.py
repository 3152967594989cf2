"""The MSDA CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip without one. They cover
what chip_smoke.py's main-path shapes do not reach: head dims other than 32
(the kernels' channel loop), batches above 1, 1-wide levels, a level where
the forward's bf16 rounding moves to the y weights, samples on pixel centres
and outside the map, and the wrappers' refusals, for the forward kernel and
the two backward kernels; and for the int8 forward (K4) and the banded
forwards (K5, K6): windows of 8, 16 and 32, bands at the top and bottom edge
of a level, an overhanging last band, a level no taller than the window,
every value type, level subsets and float32 output of the exact kernel. On a
GPU machine without JAX, run them without the
suite's conftest (which imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.models.layers import init_params
from egtr_tpu_torch.ops import msda, msda_cuda

# float32: summation order only; bf16: two roundings of the output
TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 2 * 2.0 ** -8)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(device, dtype, B, Q, H, D, shapes, P=4, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    value = torch.randn((B, S, H, D), generator=g, device=device).to(dtype)
    loc = torch.rand((B, Q, H, L, P, 2), generator=g, device=device) * 1.4 - 0.2
    aw = torch.randn((B, Q, H, L * P), generator=g, device=device).softmax(-1)
    return value, loc, aw.reshape(B, Q, H, L, P).to(dtype)


CASES = {
    "d8_thin_levels": dict(B=2, Q=33, H=3, D=8,
                           shapes=((4, 1), (1, 5), (3, 3))),
    "d32_batch3": dict(B=3, Q=70, H=8, D=32, shapes=((9, 13), (5, 7))),
    "d64": dict(B=1, Q=40, H=2, D=64, shapes=((6, 9), (3, 5))),
    "d48": dict(B=1, Q=40, H=2, D=48, shapes=((6, 9), (3, 5))),
    # w > 128 >= h: in bf16 the y weights are rounded (JAX orient "y")
    "flipped_level": dict(B=1, Q=50, H=2, D=32, shapes=((100, 168), (3, 3))),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain(cuda, case, dtype):
    value, loc, aw = _inputs(cuda, dtype, **CASES[case])
    shapes = CASES[case]["shapes"]
    before = msda_cuda.launches
    out = msda_cuda.msda_fwd(value, shapes, loc, aw)
    assert msda_cuda.launches == before + 1
    ref = msda.ms_deform_attn_plain(value, shapes, loc, aw)
    assert out.dtype == dtype and out.shape == ref.shape
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


def test_kernel_on_pixel_centres(cuda):
    """A sample on a pixel centre returns that pixel exactly."""
    value = torch.randn((1, 16, 1, 32), device=cuda)
    loc = torch.tensor([(1 + 0.5) / 4, (2 + 0.5) / 4],
                       device=cuda).reshape(1, 1, 1, 1, 1, 2)
    aw = torch.ones((1, 1, 1, 1, 1), device=cuda)
    out = msda_cuda.msda_fwd(value, ((4, 4),), loc, aw)
    torch.testing.assert_close(out[0, 0], value[0, 9, 0], atol=0, rtol=0)


# backward, float32: summation order only (a warp reduction against a torch
# sum; atomics against scatter_add). bf16: daw and dvalue are rounded once to
# bf16 from float32 sums that differ in their order, so one bf16 step
# (2**-8 relative), allow two; dloc stays float32 but sums bf16-rounded
# products of magnitude up to |V||g|*size, so its absolute tolerance scales
# with the level size.
BWD_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-3, 2 * 2.0 ** -8)}


def _assert_bwd_close(got, ref, dtype):
    atol, rtol = BWD_TOL[dtype]
    for name, a, b in zip(("dvalue", "dloc", "daw"), got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = max(1.0, b.float().abs().max().item())
        torch.testing.assert_close(a.float(), b.float(), atol=atol * scale,
                                   rtol=rtol, msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_kernels_match_plain(cuda, case, dtype):
    """K2 and K3 against ms_deform_attn_plain_bwd; locations reach outside
    the map (the inputs roam over [-0.2, 1.2])."""
    value, loc, aw = _inputs(cuda, dtype, **CASES[case])
    shapes = CASES[case]["shapes"]
    g = torch.randn((value.shape[0], loc.shape[1],
                     value.shape[2] * value.shape[3]), device=cuda).to(dtype)
    before = (msda_cuda.bwd_rows_launches, msda_cuda.bwd_value_launches)
    got = msda_cuda.msda_bwd(value, shapes, loc, aw, g)
    assert (msda_cuda.bwd_rows_launches, msda_cuda.bwd_value_launches) == (
        before[0] + 1, before[1] + 1)
    ref = msda.ms_deform_attn_plain_bwd(value, shapes, loc, aw, g)
    _assert_bwd_close(got, ref, dtype)


def test_bwd_rows_is_deterministic_and_value_nearly(cuda):
    value, loc, aw = _inputs(cuda, torch.float32, **CASES["d32_batch3"])
    shapes = CASES["d32_batch3"]["shapes"]
    g = torch.randn((3, 70, 256), device=cuda)
    a = msda_cuda.msda_bwd(value, shapes, loc, aw, g)
    b = msda_cuda.msda_bwd(value, shapes, loc, aw, g)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    # float32 atomics: the order of the additions may change the last bits
    torch.testing.assert_close(a[0], b[0], atol=1e-5, rtol=1e-5)


def test_bwd_on_pixel_centres(cuda):
    """On the integer grid both hats' derivatives are 0 (sign(0) = 0 and the
    far corner lies outside the support): dloc is exactly 0, and dvalue
    lands on the one pixel."""
    value = torch.randn((1, 16, 1, 32), device=cuda)
    loc = torch.tensor([(1 + 0.5) / 4, (2 + 0.5) / 4],
                       device=cuda).reshape(1, 1, 1, 1, 1, 2)
    aw = torch.ones((1, 1, 1, 1, 1), device=cuda)
    g = torch.randn((1, 1, 32), device=cuda)
    dvalue, dloc, daw = msda_cuda.msda_bwd(value, ((4, 4),), loc, aw, g)
    assert torch.equal(dloc, torch.zeros_like(dloc))
    expect = torch.zeros_like(value)
    expect[0, 9, 0] = g[0, 0]
    torch.testing.assert_close(dvalue, expect, atol=0, rtol=0)
    torch.testing.assert_close(daw.reshape(()), (value[0, 9, 0] * g[0, 0]).sum(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "matmul"])
def test_autograd_op_on_the_card(cuda, impl):
    """ms_deform_attn under autograd: "auto" runs K1 forward and K2 + K3
    backward, "matmul" the plain pair; both give the plain gradients."""
    value, loc, aw = _inputs(cuda, torch.float32, **CASES["d32_batch3"])
    shapes = CASES["d32_batch3"]["shapes"]
    leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
    before = (msda_cuda.launches, msda_cuda.bwd_rows_launches,
              msda_cuda.bwd_value_launches)
    out = msda.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2],
                              impl=impl)
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, leaves, g)
    after = (msda_cuda.launches, msda_cuda.bwd_rows_launches,
             msda_cuda.bwd_value_launches)
    n = 1 if impl == "auto" else 0
    assert after == tuple(b + n for b in before)
    ref = msda.ms_deform_attn_plain_bwd(value, shapes, loc, aw, g)
    _assert_bwd_close(grads, ref, torch.float32)


def test_bwd_refusals(cuda):
    value, loc, aw = _inputs(cuda, torch.float32, 1, 5, 2, 8, ((3, 4),))
    g = torch.randn((1, 5, 16), device=cuda)
    with pytest.raises(ValueError, match="grad_output must be"):
        msda_cuda.msda_bwd_rows(value, ((3, 4),), loc, aw, g[:, :4])
    with pytest.raises(TypeError, match="value dtype"):
        msda_cuda.msda_bwd_value(value, ((3, 4),), loc, aw, g.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        msda_cuda.msda_bwd_rows(
            value, ((3, 4),), loc, aw,
            torch.randn((1, 16, 5), device=cuda).transpose(1, 2))
    with pytest.raises(ValueError, match="one device"):
        msda_cuda.msda_bwd(value, ((3, 4),), loc, aw, g.cpu())
    empty = msda_cuda.msda_bwd(value, ((3, 4),), loc[:, :0].contiguous(),
                               aw[:, :0].contiguous(), g[:, :0].contiguous())
    assert empty[0].shape == value.shape and not empty[0].any()
    assert empty[1].shape == (1, 0, 2, 1, 4, 2)


def test_kernel_refusals(cuda):
    value, loc, aw = _inputs(cuda, torch.float32, 1, 5, 2, 8, ((3, 4),))
    with pytest.raises(NotImplementedError, match="no backward"):
        msda_cuda.msda_fwd(value.requires_grad_(), ((3, 4),), loc, aw)
    value = value.detach()
    with pytest.raises(ValueError, match="contiguous"):
        msda_cuda.msda_fwd(value, ((3, 4),), loc.transpose(1, 2)
                           .contiguous().transpose(1, 2), aw)
    with pytest.raises(ValueError, match="one device"):
        msda_cuda.msda_fwd(value, ((3, 4),), loc.cpu(), aw)
    empty = msda_cuda.msda_fwd(value, ((3, 4),), loc[:, :0].contiguous(),
                               aw[:, :0].contiguous())
    assert empty.shape == (1, 0, 16)


def test_tiny_model_kernel_path_matches_plain(cuda):
    """A 2+2-layer float32 model with a padded batch of 2: the kernel path
    against the plain-MSDA path on the same weights (TF32 off)."""
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = EgtrConfig(d_model=64, encoder_layers=2, decoder_layers=2,
                         encoder_ffn_dim=128, decoder_ffn_dim=128,
                         num_queries=12, num_labels=7, num_rel_labels=5)
        model_k = init_params(EgtrModel(cfg), torch.Generator().manual_seed(0))
        with torch.no_grad():
            for name, p in model_k.named_parameters():
                if name.endswith(("sampling_offsets.weight",
                                  "attention_weights.weight")):
                    p.normal_(0.0, 0.1)
        model_p = EgtrModel(cfg.replace(msda_impl="matmul"))
        model_p.load_state_dict(model_k.state_dict())
        model_k, model_p = model_k.to(cuda).eval(), model_p.to(cuda).eval()
        x = torch.randn((2, 64, 96, 3), device=cuda)
        mask = torch.ones((2, 64, 96), dtype=torch.bool, device=cuda)
        mask[1, 40:] = False
        before = msda_cuda.launches
        with torch.inference_mode():
            out_k = model_k(x, mask)
            out_p = model_p(x, mask)
        assert msda_cuda.launches == before + 4
        for key in ("logits", "pred_boxes", "pred_rel", "pred_connectivity"):
            torch.testing.assert_close(out_k[key], out_p[key], atol=1e-4,
                                       rtol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


# --------------------------------------------------------------------------
# K4 (int8 stage 1), K5 and K6 (banded forward)
# --------------------------------------------------------------------------

COUNTERS = ("launches", "fwd_q_launches", "fwd_win_launches",
            "fwd_win_pp_launches", "bwd_rows_launches", "bwd_value_launches")


def _counts():
    return [getattr(msda_cuda, c) for c in COUNTERS]


def _assert_f32_close(out, ref):
    """The new kernels and their plain versions return float32 sums of the
    same rounded products: summation order only."""
    assert out.dtype == ref.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fwd_q_matches_plain(cuda, case, dtype):
    """K4; on the flipped level the y hats are the quantized ones."""
    value, loc, aw = _inputs(cuda, dtype, **CASES[case])
    shapes = CASES[case]["shapes"]
    vq, scale = msda.quantize_levels(value, shapes)
    vq_cpu, scale_cpu = msda.quantize_levels(value.cpu(), shapes)
    assert torch.equal(vq.cpu(), vq_cpu) and torch.equal(scale.cpu(), scale_cpu)
    before = _counts()
    out = msda_cuda.msda_fwd_q(vq, scale, shapes, loc, aw)
    assert _counts() == [b + (c == "fwd_q_launches")
                         for b, c in zip(before, COUNTERS)]
    _assert_f32_close(out, msda.msda_fwd_q_plain(vq, scale, shapes, loc, aw))
    last = (len(shapes) - 1,)
    _assert_f32_close(
        msda_cuda.msda_fwd_q(vq, scale, shapes, loc, aw, levels=last),
        msda.msda_fwd_q_plain(vq, scale, shapes, loc, aw, levels=last))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_exact_kernel_level_subset_and_f32_out(cuda, dtype):
    """K1 as a windowed call uses it: a subset of the levels, the float32
    sum written as it is."""
    value, loc, aw = _inputs(cuda, dtype, **CASES["d8_thin_levels"])
    shapes = CASES["d8_thin_levels"]["shapes"]
    for levels in ((2,), (0, 2), (1,)):
        out = msda_cuda.msda_fwd(value, shapes, loc, aw, levels=levels,
                                 out_dtype=torch.float32)
        ref = msda.ms_deform_attn_plain(value, shapes, loc, aw, levels=levels,
                                        out_dtype=torch.float32)
        _assert_f32_close(out, ref)
    parts = sum(msda_cuda.msda_fwd(value, shapes, loc, aw, levels=(l,),
                                   out_dtype=torch.float32) for l in range(3))
    whole = msda_cuda.msda_fwd(value, shapes, loc, aw,
                               out_dtype=torch.float32)
    torch.testing.assert_close(parts, whole, atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="levels must be"):
        msda_cuda.msda_fwd(value, shapes, loc, aw, levels=(3,))
    with pytest.raises(TypeError, match="out_dtype"):
        msda_cuda.msda_fwd(value, shapes, loc, aw, out_dtype=torch.float16)


def _raster(device, dtype, shapes, B, H, D, P=4, max_offset_px=3.0, seed=0):
    """Encoder-like inputs: queries are the raster tokens, offsets of a few
    pixels, so the first and last tiles sit at the top and bottom edges."""
    g = torch.Generator(device=device).manual_seed(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = torch.randn((B, S, H, D), generator=g, device=device).to(dtype)
    refs = []
    for h, w in shapes:
        yy, xx = torch.meshgrid(torch.arange(h, device=device),
                                torch.arange(w, device=device), indexing="ij")
        refs.append(torch.stack([(xx.reshape(-1) + 0.5) / w,
                                 (yy.reshape(-1) + 0.5) / h], -1))
    ref = torch.cat(refs)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                      device=device)
    off = (torch.rand((B, S, H, L, P, 2), generator=g, device=device) * 2
           - 1) * max_offset_px
    loc = ref[None, :, None, None, None, :] + off / wh[None, None, None, :,
                                                       None, :]
    aw = torch.randn((B, S, H, L * P), generator=g, device=device).softmax(-1)
    return value, loc.contiguous(), aw.reshape(B, S, H, L, P).to(dtype)


WIN_CASES = {
    # h = 21 with window 8: the last band starts at row 16 and overhangs
    "w8_d8_overhang": dict(window=8, B=2, H=3, D=8,
                           shapes=((21, 16), (11, 8), (6, 4))),
    "w16_d32_batch3": dict(window=16, B=3, H=2, D=32,
                           shapes=((40, 24), (20, 12), (10, 6))),
    "w32_d64": dict(window=32, B=1, H=2, D=64, shapes=((70, 20), (35, 10))),
    "w8_d48": dict(window=8, B=1, H=2, D=48, shapes=((24, 16), (12, 8))),
    # every level is within the window: no banded launch at all
    "w32_all_exact": dict(window=32, B=1, H=2, D=8, shapes=((24, 16), (12, 8))),
}


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("band", ["tile", "point"])
@pytest.mark.parametrize("case", sorted(WIN_CASES))
def test_windowed_op_kernels_match_plain(cuda, case, band, form):
    """The whole windowed call through the kernels (K5 or K6 per banded
    level, K1 or K4 once for the exact levels) against the same call through
    their plain versions, and the launch counts of that split."""
    kw = dict(WIN_CASES[case])
    window, shapes = kw.pop("window"), kw["shapes"]
    dtype = torch.float32 if form == "f32" else torch.bfloat16
    int8 = form == "int8"
    value, loc, aw = _raster(cuda, dtype, **kw)
    args = dict(window=window, query_segments=shapes, band=band, int8=int8)
    before = _counts()
    out = msda.ms_deform_attn(value, shapes, loc, aw, **args)
    got = dict(zip(COUNTERS, (a - b for a, b in zip(_counts(), before))))
    n_banded = sum(h > window for h, _ in shapes)
    expect = dict.fromkeys(COUNTERS, 0)
    if n_banded:
        expect["fwd_win_pp_launches" if band == "point"
               else "fwd_win_launches"] = n_banded
    if n_banded < len(shapes):
        expect["fwd_q_launches" if int8 else "launches"] = 1
    assert got == expect
    ref = msda.ms_deform_attn(value, shapes, loc, aw, impl="plain", **args)
    assert _counts()[:4] == [b + g for b, g in zip(before, got.values())][:4]
    assert out.dtype == ref.dtype == dtype
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    if form == "f32" and n_banded:
        # and against the oracle that never sees a band (in float32: in
        # bfloat16 the exact op rounds the y hats on a level where it
        # contracts y, the banded path always the x hats)
        oracle = msda.ms_deform_attn(value, shapes, loc, aw, impl="matmul",
                                     window=window, query_segments=shapes,
                                     band=band)
        torch.testing.assert_close(out.float(), oracle.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("per_point", [False, True], ids=["tile", "point"])
def test_banded_kernel_reach(cuda, per_point):
    """A corner whose band-local row lies outside [0, win) is dropped even
    where the absolute row exists; rows at or beyond h read as zero."""
    h, w, win = 21, 4, 8
    kernel = msda_cuda.msda_fwd_win_pp if per_point else msda_cuda.msda_fwd_win
    value = torch.ones((1, h * w, 1, 32), device=cuda)
    segs = ((0, h * w),)
    rows = torch.ones((1, 1, 1, 128), device=cuda)
    shape = (1, 1, 1, 1) if per_point else (1, 1, 1)
    for band, y_local, expect in ((1, -0.5, 0.5), (1, 0.0, 1.0), (1, 7.5, 0.5),
                                  (1, 8.0, 0.0), (1, -1.0, 0.0),
                                  # the last band, rows 16..23 of 21
                                  (4, 4.0, 1.0), (4, 4.5, 0.5), (4, 5.0, 0.0)):
        bidx = torch.full(shape, band, dtype=torch.int32, device=cuda)
        iy = torch.full_like(rows, y_local)
        args = (value, bidx, rows, iy, rows, h, w, win, segs, h * w)
        out = kernel(*args)
        torch.testing.assert_close(out, torch.full_like(out, expect))
        torch.testing.assert_close(out, msda.msda_fwd_win_plain(*args))


def test_int8_op_on_the_card_has_the_exact_gradients(cuda):
    value, loc, aw = _inputs(cuda, torch.float32, **CASES["d32_batch3"])
    shapes = CASES["d32_batch3"]["shapes"]
    g = torch.randn((3, 70, 256), device=cuda)
    grads = {}
    for int8 in (True, False):
        leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
        before = _counts()
        out = msda.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2],
                                  int8=int8)
        grads[int8] = torch.autograd.grad(out, leaves, g)
        got = dict(zip(COUNTERS, (a - b for a, b in zip(_counts(), before))))
        assert got == {**dict.fromkeys(COUNTERS, 0),
                       "fwd_q_launches" if int8 else "launches": 1,
                       "bwd_rows_launches": 1, "bwd_value_launches": 1}
    assert torch.equal(grads[True][1], grads[False][1])
    assert torch.equal(grads[True][2], grads[False][2])
    torch.testing.assert_close(grads[True][0], grads[False][0], atol=1e-5,
                               rtol=1e-5)


def test_new_kernel_refusals(cuda):
    shapes = ((24, 16), (12, 8))
    value, loc, aw = _raster(cuda, torch.float32, shapes, 1, 2, 8)
    with pytest.raises(NotImplementedError, match="K7-K10"):
        msda.ms_deform_attn(value.clone().requires_grad_(), shapes, loc, aw,
                            window=8, query_segments=shapes)
    vq, scale = msda.quantize_levels(value, shapes)
    with pytest.raises(NotImplementedError, match="no backward"):
        msda_cuda.msda_fwd_q(vq, scale, shapes, loc,
                             aw.clone().requires_grad_())
    with pytest.raises(ValueError, match="one device"):
        msda_cuda.msda_fwd_q(vq, scale.cpu(), shapes, loc, aw)
    with pytest.raises(TypeError, match="vq must be int8"):
        msda_cuda.msda_fwd_q(value, scale, shapes, loc, aw)
    rows = torch.zeros((1, 2, 4, 512), device=cuda)
    bidx = torch.zeros((1, 2, 4), dtype=torch.int32, device=cuda)
    segs = ((0, 384), (384, 96))
    with pytest.raises(ValueError, match="contiguous"):
        msda_cuda.msda_fwd_win(value[:, :384], bidx, rows,
                               rows.transpose(2, 3).contiguous().transpose(2, 3),
                               rows, 24, 16, 8, segs, 480)
    with pytest.raises(ValueError, match="bidx must be"):
        msda_cuda.msda_fwd_win_pp(value[:, :384], bidx, rows, rows, rows, 24,
                                  16, 8, segs, 480)
    out = msda_cuda.msda_fwd_win(value[:, :384], bidx, rows, rows, rows, 24,
                                 16, 8, segs, 480)
    assert out.shape == (1, 480, 16) and not out.any()


@pytest.mark.parametrize("flags", [
    dict(msda_window=4, msda_band="point", msda_int8=True),
    dict(msda_window=4, msda_band="tile"),
    dict(msda_int8=True)], ids=["served", "tile", "int8"])
def test_tiny_served_model_kernel_path_matches_plain(cuda, flags):
    """A 2+2-layer float32 model at 64x96 (levels of 8, 4, 2 and 1 rows; a
    window of 4 bands level 0): the kernel path against the plain versions
    on the same weights (TF32 off). int8 amplifies the last float32 bits
    where a value sits on a rounding tie, hence the looser limit."""
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg = EgtrConfig(d_model=64, encoder_layers=2, decoder_layers=2,
                         encoder_ffn_dim=128, decoder_ffn_dim=128,
                         num_queries=12, num_labels=7, num_rel_labels=5,
                         **flags)
        model_k = init_params(EgtrModel(cfg), torch.Generator().manual_seed(0))
        with torch.no_grad():
            for name, p in model_k.named_parameters():
                if name.endswith(("sampling_offsets.weight",
                                  "attention_weights.weight")):
                    p.normal_(0.0, 0.1)
        model_p = EgtrModel(cfg)
        model_p.load_state_dict(model_k.state_dict())
        for module in model_p.modules():
            if hasattr(module, "msda_impl"):
                module.msda_impl = "plain"
        model_k, model_p = model_k.to(cuda).eval(), model_p.to(cuda).eval()
        x = torch.randn((1, 64, 96, 3), device=cuda)
        before = _counts()
        with torch.inference_mode():
            out_k = model_k(x)
            mid = _counts()
            out_p = model_p(x)
        assert _counts() == mid and mid != before
        atol = 1e-2 if cfg.msda_int8 else 1e-4
        for key in ("logits", "pred_boxes", "pred_rel", "pred_connectivity"):
            torch.testing.assert_close(out_k[key], out_p[key], atol=atol,
                                       rtol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
