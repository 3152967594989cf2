"""The MSDA CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip without one. They cover
what chip_smoke.py's main-path shapes do not reach: head dims other than 32
(the kernels' channel loop), batches above 1, 1-wide levels, a level where
the forward's bf16 rounding moves to the y weights, samples on pixel centres
and outside the map, and the wrappers' refusals, for the forward kernel and
the two backward kernels; and for the int8 forward (K4) and the banded
forwards (K5, K6): windows of 8, 16 and 32, bands at the top and bottom edge
of a level, an overhanging last band, a level no taller than the window,
every value type, level subsets and float32 output of the exact kernel; and
for the banded backward (K7-K10): head dims 8 to 64, windows 8, 16 and 32,
batches of 1 to 3, an overhanging last band, the band's reach, a level within
the window, the whole windowed op's gradient, the exact backward kernels on a
level subset, and refusals; and for the exact forward (K1) and the backward
row kernel (K2) in their Hopper layout: one row a warp and rows walked by a
warp, rows handed out by shuffles and rows too long for that, bit-equal
reruns and bits that do not move with the rows a warp walks, loads narrowed
by D or by a pointer off the 16-byte alignment, a head dim of two chunks of
lanes, and the C side's refusal of a geometry that misses work; and for the value
gradient (K3) with its adds through global memory and through a block's
shared copies (head dims 8 to 256, a batch of 2, pixel centres and the
map's edges, a level subset with float32 out, narrow loads, refusals) and
the per-point banded kernels in their Hopper layout (K6 forward, K8 rows,
K10 value) on segments that split a warp's queries, windows 8 and 32, bands
at the top and bottom edge, an overhanging last band, batch 2, loads and
adds narrowed by an unaligned pointer in every form, K10 adding into a
slice of a layer's gradient, K6 and K8 bit-equal over two runs, and
refusals; and the int8 forward (K4) in its Hopper layout (D 8-64, P 3 and
8, level subsets, flipped levels, loads of at most 16 and 8 bytes,
unaligned values, bit-equal reruns, the C side's refusals) and K7 bit-equal
to K8 on its tile bands broadcast over the points; and the tile forms that
run the point forms' kernels: K5 bit-equal to K6 on its tile bands
broadcast over the points (every value type, windows 8-32), K9 against K10
on them and adding into a slice of a wider gradient that holds values, and
both refusing a geometry that misses work. On a GPU
machine without JAX, run them without the suite's conftest (which imports
JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

from dataclasses import replace

import pytest
import torch

from egtr_tpu_torch.config import EgtrConfig
from egtr_tpu_torch.models.egtr import EgtrModel
from egtr_tpu_torch.models.layers import init_params
from egtr_tpu_torch.ops import msda, msda_cuda
from egtr_tpu_torch.ops.msda_window import segment_bounds

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
    before = msda_cuda.launches["msda_fwd"]
    out = msda_cuda.msda_fwd(value, shapes, loc, aw)
    assert msda_cuda.launches["msda_fwd"] == before + 1
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
    names = ("msda_bwd_rows", "msda_bwd_value")
    before = [msda_cuda.launches[n] for n in names]
    got = msda_cuda.msda_bwd(value, shapes, loc, aw, g)
    assert [msda_cuda.launches[n] for n in names] == [b + 1 for b in before]
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
    names = ("msda_fwd", "msda_bwd_rows", "msda_bwd_value")
    before = tuple(msda_cuda.launches[n] for n in names)
    out = msda.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2],
                              impl=impl)
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, leaves, g)
    after = tuple(msda_cuda.launches[n] for n in names)
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
        before = msda_cuda.launches["msda_fwd"]
        with torch.inference_mode():
            out_k = model_k(x, mask)
            out_p = model_p(x, mask)
        assert msda_cuda.launches["msda_fwd"] == before + 4
        for key in ("logits", "pred_boxes", "pred_rel", "pred_connectivity"):
            torch.testing.assert_close(out_k[key], out_p[key], atol=1e-4,
                                       rtol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


# --------------------------------------------------------------------------
# K4 (int8 stage 1), K5 and K6 (banded forward)
# --------------------------------------------------------------------------

COUNTERS = msda_cuda.KERNELS


def _counts():
    return [msda_cuda.launches[c] for c in COUNTERS]


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
    assert _counts() == [b + (c == "msda_fwd_q")
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
        expect["msda_fwd_win_pp" if band == "point"
               else "msda_fwd_win"] = n_banded
    if n_banded < len(shapes):
        expect["msda_fwd_q" if int8 else "msda_fwd"] = 1
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
                       "msda_fwd_q" if int8 else "msda_fwd": 1,
                       "msda_bwd_rows": 1, "msda_bwd_value": 1}
    assert torch.equal(grads[True][1], grads[False][1])
    assert torch.equal(grads[True][2], grads[False][2])
    torch.testing.assert_close(grads[True][0], grads[False][0], atol=1e-5,
                               rtol=1e-5)


def test_new_kernel_refusals(cuda):
    shapes = ((24, 16), (12, 8))
    value, loc, aw = _raster(cuda, torch.float32, shapes, 1, 2, 8)
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


# --------------------------------------------------------------------------
# K7-K10 (banded backward), and K2 + K3 on a level subset
# --------------------------------------------------------------------------

def _banded_bwd_args(value, loc, aw, g, shapes, lid, window, per_point):
    """One banded level's backward inputs, as msda._windowed_backward makes
    them."""
    Q, D = loc.shape[1], value.shape[3]
    h, w = shapes[lid]
    segs = segment_bounds(Q, shapes)
    locT, awT = msda.rows_t(loc, aw)
    bidx, ix, iy_band, _, aw_eff, _, _ = msda.win_level_rows(
        locT, awT, lid, h, w, window, segs, D, per_point)
    start = msda.level_starts(shapes)[lid]
    return (value[:, start:start + h * w], bidx, ix, iy_band, aw_eff, g, h,
            w, window, segs, Q)


def _assert_win_bwd_close(got, ref, dtype):
    """dvalue_l and the three rows; all float32 sums of the same rounded
    products (summation order), the rows relative to their largest entry."""
    atol, rtol = BWD_TOL[torch.float32 if dtype == torch.float32
                         else torch.bfloat16]
    for name, a, b in zip(("dvalue", "dix", "diy", "daw"), got, ref):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, name
        scale = max(1.0, b.abs().max().item())
        torch.testing.assert_close(a, b, atol=atol * scale, rtol=rtol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("band", ["tile", "point"])
@pytest.mark.parametrize("case", sorted(c for c in WIN_CASES
                                        if c != "w32_all_exact"))
def test_bwd_win_kernels_match_plain(cuda, case, band, dtype):
    """K7 + K9 (tile) or K8 + K10 (point) on every banded level against
    msda_bwd_win_plain, one launch each per level."""
    kw = dict(WIN_CASES[case])
    window, shapes = kw.pop("window"), kw["shapes"]
    value, loc, aw = _raster(cuda, dtype, **kw)
    B, S, H, D = value.shape
    g = torch.randn((B, S, H * D), device=cuda).to(dtype)
    per_point = band == "point"
    for lid, (h, _) in enumerate(shapes):
        if h <= window:
            continue
        args = _banded_bwd_args(value, loc, aw, g, shapes, lid, window,
                                per_point)
        before = _counts()
        got = msda_cuda.msda_bwd_win(*args)
        names = (("msda_bwd_win_value_pp", "msda_bwd_win_rows_pp")
                 if per_point else ("msda_bwd_win_value",
                                    "msda_bwd_win_rows"))
        assert _counts() == [b + (c in names)
                             for b, c in zip(before, COUNTERS)]
        _assert_win_bwd_close(got, msda.msda_bwd_win_plain(*args), dtype)


def test_bwd_win_rows_deterministic_and_value_nearly(cuda):
    kw = dict(WIN_CASES["w16_d32_batch3"])
    window, shapes = kw.pop("window"), kw["shapes"]
    value, loc, aw = _raster(cuda, torch.float32, **kw)
    g = torch.randn((3, value.shape[1], 64), device=cuda)
    args = _banded_bwd_args(value, loc, aw, g, shapes, 0, window, True)
    a, b = msda_cuda.msda_bwd_win(*args), msda_cuda.msda_bwd_win(*args)
    assert all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
    # float32 atomics: the order of the additions may change the last bits
    torch.testing.assert_close(a[0], b[0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("per_point", [False, True], ids=["tile", "point"])
def test_banded_bwd_kernel_reach(cuda, per_point):
    """One sample read through band 1 (rows 4..11) of a 21-row level, or
    through the last band (rows 16..23): its value gradient lands on the
    absolute rows, nothing beyond the band or below row 20."""
    h, w, win, D = 21, 4, 8, 32
    value = torch.ones((1, h * w, 1, D), device=cuda)
    g = torch.ones((1, 1, D), device=cuda)
    segs = ((0, 1),)
    ix = torch.ones((1, 1, 1, 128), device=cuda)
    shape = (1, 1, 1, 1) if per_point else (1, 1, 1)
    for band, y_local, rows in ((1, 0.25, {4: 0.75, 5: 0.25}),
                                (1, -0.5, {4: 0.5}), (1, 7.5, {11: 0.5}),
                                (1, 8.0, {}), (4, 4.5, {20: 0.5})):
        bidx = torch.full(shape, band, dtype=torch.int32, device=cuda)
        iy = torch.full_like(ix, y_local)
        args = (value, bidx, ix, iy, ix, g, h, w, win, segs, 1)
        got = msda_cuda.msda_bwd_win(*args)
        expect = torch.zeros((h, w), device=cuda)
        for r, weight in rows.items():
            expect[r, 1] = weight
        torch.testing.assert_close(got[0][0, :, 0, 0].reshape(h, w), expect)
        _assert_win_bwd_close(got, msda.msda_bwd_win_plain(*args),
                              torch.float32)


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("band", ["tile", "point"])
@pytest.mark.parametrize("case", sorted(WIN_CASES))
def test_windowed_op_grad_kernels_match_plain(cuda, case, band, form):
    """The windowed op's forward + backward through the kernels against the
    same through their plain versions, and the launches of the backward's
    split: K2 and K3 once for the exact levels, K7 + K9 or K8 + K10 once per
    banded level. int8 has the same backward (straight-through)."""
    kw = dict(WIN_CASES[case])
    window, shapes = kw.pop("window"), kw["shapes"]
    dtype = torch.float32 if form == "f32" else torch.bfloat16
    value, loc, aw = _raster(cuda, dtype, **kw)
    B, S, H, D = value.shape
    g = torch.randn((B, S, H * D), device=cuda).to(dtype)
    args = dict(window=window, query_segments=shapes, band=band,
                int8=form == "int8")
    grads = []
    for impl in ("auto", "plain"):
        leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
        out = msda.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2],
                                  impl=impl, **args)
        before = _counts()
        grads.append(torch.autograd.grad(out, leaves, g))
        got = dict(zip(COUNTERS, (a - b for a, b in zip(_counts(), before))))
        n_banded = sum(h > window for h, _ in shapes)
        expect = dict.fromkeys(COUNTERS, 0)
        if impl == "auto":
            suffix = "_pp" if band == "point" else ""
            expect[f"msda_bwd_win_rows{suffix}"] = n_banded
            expect[f"msda_bwd_win_value{suffix}"] = n_banded
            if n_banded < len(shapes):
                expect["msda_bwd_rows"] = expect[
                    "msda_bwd_value"] = 1
        assert got == expect
    for name, a, b in zip(("dvalue", "dloc", "daw"), *grads):
        assert a.dtype == b.dtype and torch.isfinite(a.float()).all(), name
        atol, rtol = BWD_TOL[dtype]
        torch.testing.assert_close(
            a.float(), b.float(), rtol=rtol,
            atol=atol * max(1.0, b.float().abs().max().item()),
            msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bwd_kernels_level_subset(cuda, dtype):
    """K2 and K3 as a windowed call uses them: a subset of the levels (the
    others' entries zero), the value gradient's float32 sum as it is."""
    value, loc, aw = _inputs(cuda, dtype, **CASES["d8_thin_levels"])
    shapes = CASES["d8_thin_levels"]["shapes"]
    g = torch.randn((2, 33, 24), device=cuda).to(dtype)
    args = (value, shapes, loc, aw, g)
    for levels in ((2,), (0, 2), (1,)):
        dloc, daw = msda_cuda.msda_bwd_rows(*args, levels=levels)
        dvalue = msda_cuda.msda_bwd_value(*args, levels=levels,
                                          out_dtype=torch.float32)
        ref = msda.ms_deform_attn_plain_bwd(*args, levels=levels,
                                            dvalue_dtype=torch.float32)
        _assert_bwd_close((dvalue, dloc, daw), ref, dtype)
        others = [l for l in range(3) if l not in levels]
        assert not dloc[:, :, :, others].any()
        assert not daw[:, :, :, others].any()
    with pytest.raises(ValueError, match="levels must be"):
        msda_cuda.msda_bwd_rows(*args, levels=(3,))
    with pytest.raises(TypeError, match="out_dtype"):
        msda_cuda.msda_bwd_value(*args, out_dtype=torch.float16)


def test_bwd_win_refusals(cuda):
    shapes = ((24, 16), (12, 8))
    value, loc, aw = _raster(cuda, torch.float32, shapes, 1, 2, 8)
    g = torch.randn((1, value.shape[1], 16), device=cuda)
    args = _banded_bwd_args(value, loc, aw, g, shapes, 0, 8, False)
    vq, _ = msda.quantize_levels(value, shapes)
    bad = {
        "float32 or bfloat16 values": dict(value_l=vq[:, :384]),
        "g must have the value dtype": dict(g=g.bfloat16()),
        "g must be": dict(g=g[:, :100]),
        "bidx must be": dict(bidx=args[1][..., None]),
        "window below its height": dict(win=24),
        "one device": dict(g=g.cpu()),
    }
    names = ("value_l", "bidx", "ix", "iy_band", "aw_eff", "g", "h", "w",
             "win", "segs", "Q")
    for match, change in bad.items():
        kw = dict(zip(names, args))
        kw.update(change)
        with pytest.raises((TypeError, ValueError), match=match):
            msda_cuda.msda_bwd_win_rows(**kw)
        with pytest.raises((TypeError, ValueError), match=match):
            msda_cuda.msda_bwd_win_value(**kw)
    with pytest.raises(ValueError, match="g must be contiguous"):
        msda_cuda.msda_bwd_win_value(
            *args[:5], g.transpose(1, 2).contiguous().transpose(1, 2),
            *args[6:])


# --------------------------------------------------------------------------
# K11 (batched-P forward)
# --------------------------------------------------------------------------

# K11 against K1 on the same inputs: the same products, folded over the
# points in another order; float32 sums, so float32 round-off only, and in
# bf16 one rounding of the output either way
BP_CASES = {**CASES,
            "p2_d8": dict(B=2, Q=21, H=2, D=8, P=2, shapes=((6, 9), (3, 5))),
            "p8_d64": dict(B=1, Q=30, H=2, D=64, P=8, shapes=((6, 9), (1, 4))),
            "p1_d32": dict(B=3, Q=17, H=1, D=32, P=1, shapes=((5, 7),))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(BP_CASES))
def test_fwd_bp_matches_plain(cuda, case, dtype):
    """Both forms of K11 against their plain version and against K1 / K4;
    D 8/48/64, P 1/2/4/8, batches 1-3, thin and flipped levels, samples
    outside the map."""
    shapes = BP_CASES[case]["shapes"]
    value, loc, aw = _inputs(cuda, dtype, **BP_CASES[case])
    atol, rtol = TOL[dtype]
    before = _counts()
    out = msda_cuda.msda_fwd_bp(value, shapes, loc, aw)
    assert _counts() == [b + (c == "msda_fwd_bp")
                         for b, c in zip(before, COUNTERS)]
    ref = msda.msda_fwd_bp_plain(value, shapes, loc, aw)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(
        out.float(), msda_cuda.msda_fwd(value, shapes, loc, aw).float(),
        atol=atol, rtol=rtol)
    vq, scale = msda.quantize_levels(value, shapes)
    q = msda_cuda.msda_fwd_bp(vq, shapes, loc, aw, scale=scale)
    _assert_f32_close(q, msda.msda_fwd_bp_plain(vq, shapes, loc, aw,
                                                 scale=scale))
    _assert_f32_close(q, msda_cuda.msda_fwd_q(vq, scale, shapes, loc, aw))
    last = (len(shapes) - 1,)
    _assert_f32_close(
        msda_cuda.msda_fwd_bp(value, shapes, loc, aw, levels=last,
                              out_dtype=torch.float32),
        msda.msda_fwd_bp_plain(value, shapes, loc, aw, levels=last,
                               out_dtype=torch.float32))


def test_fwd_bp_on_pixel_centres_and_deterministic(cuda):
    """A sample on a pixel centre returns that pixel exactly; the fold over
    the points has a fixed order, so two runs are bit-equal."""
    value = torch.randn((1, 16, 1, 32), device=cuda)
    loc = torch.tensor([(1 + 0.5) / 4, (2 + 0.5) / 4],
                       device=cuda).reshape(1, 1, 1, 1, 1, 2)
    aw = torch.ones((1, 1, 1, 1, 1), device=cuda)
    out = msda_cuda.msda_fwd_bp(value, ((4, 4),), loc, aw)
    torch.testing.assert_close(out[0, 0], value[0, 9, 0], atol=0, rtol=0)
    value, loc, aw = _inputs(cuda, torch.float32, **CASES["d32_batch3"])
    shapes = CASES["d32_batch3"]["shapes"]
    assert torch.equal(msda_cuda.msda_fwd_bp(value, shapes, loc, aw),
                       msda_cuda.msda_fwd_bp(value, shapes, loc, aw))


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
def test_batched_p_dispatch_on_the_card(cuda, form):
    """With batch_p every exact forward launch goes to K11: the exact op,
    the int8 op, and the exact levels of a windowed call; the backward is
    K2 + K3 as without it."""
    dtype = torch.float32 if form == "f32" else torch.bfloat16
    int8 = form == "int8"
    shapes = ((24, 16), (12, 8), (6, 4))
    # a windowed call's queries are the raster tokens: Q = S
    value, loc, aw = _inputs(cuda, dtype, 1, 504, 2, 32, shapes)
    for window in (0, 8):
        kw = dict(window=window, query_segments=shapes if window else None,
                  band="point", int8=int8)
        before = _counts()
        out = msda.ms_deform_attn(value, shapes, loc, aw, batch_p=True, **kw)
        got = dict(zip(COUNTERS, (a - b for a, b in zip(_counts(), before))))
        expect = dict.fromkeys(COUNTERS, 0)
        expect["msda_fwd_bp"] = 1
        if window:
            expect["msda_fwd_win_pp"] = 2
        assert got == expect
        # the plain versions on the card: the same band choices
        ref = msda.ms_deform_attn(value, shapes, loc, aw, impl="plain",
                                  batch_p=True, **kw)
        atol, rtol = TOL[dtype]
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
    leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
    before = _counts()
    out = msda.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2],
                              int8=int8, batch_p=True)
    torch.autograd.grad(out, leaves, torch.ones_like(out))
    got = dict(zip(COUNTERS, (a - b for a, b in zip(_counts(), before))))
    assert got == {**dict.fromkeys(COUNTERS, 0), "msda_fwd_bp": 1,
                   "msda_bwd_rows": 1, "msda_bwd_value": 1}


def test_fwd_bp_refusals(cuda):
    """What the kernel that serves each form refuses: the float32 form's
    own lane split (P dividing 32, D a multiple of 4, 16-byte aligned
    values); the bfloat16 and int8 forms take any P, D and alignment that K1
    and K4 take."""
    value, loc, aw = _inputs(cuda, torch.float32, 1, 5, 2, 8, ((3, 4),))
    with pytest.raises(NotImplementedError, match="no backward"):
        msda_cuda.msda_fwd_bp(value.requires_grad_(), ((3, 4),), loc, aw)
    value = value.detach()
    with pytest.raises(ValueError, match="one device"):
        msda_cuda.msda_fwd_bp(value, ((3, 4),), loc.cpu(), aw)
    v3, l3, a3 = _inputs(cuda, torch.float32, 1, 5, 2, 8, ((3, 4),), P=3)
    with pytest.raises(ValueError, match="P must divide 32"):
        msda_cuda.msda_fwd_bp(v3, ((3, 4),), l3, a3)
    v6, l6, a6 = _inputs(cuda, torch.float32, 1, 5, 2, 6, ((3, 4),))
    with pytest.raises(ValueError, match="multiple of 4"):
        msda_cuda.msda_fwd_bp(v6, ((3, 4),), l6, a6)
    with pytest.raises(ValueError, match="aligned"):
        msda_cuda.msda_fwd_bp(torch.randn(1 + 24 * 8, device=cuda)[1:]
                              .view(1, 12, 2, 8), ((3, 4),), loc, aw)
    # routed forms: K1's and K4's contracts
    for v, l, a in ((v3, l3, a3), (v6, l6, a6)):
        msda_cuda.msda_fwd_bp(v.bfloat16(), ((3, 4),), l, a.bfloat16())
        vq, scale = msda.quantize_levels(v, ((3, 4),))
        msda_cuda.msda_fwd_bp(vq, ((3, 4),), l, a, scale=scale)
    vq, scale = msda.quantize_levels(value, ((3, 4),))
    with pytest.raises(TypeError, match="float32"):
        msda_cuda.msda_fwd_bp(vq, ((3, 4),), loc, aw, scale=scale,
                              out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="need their scale"):
        msda_cuda.msda_fwd_bp(vq, ((3, 4),), loc, aw)
    with pytest.raises(TypeError, match="out_dtype must be float32"):
        msda_cuda.msda_fwd_bp(value, ((3, 4),), loc, aw,
                              out_dtype=torch.bfloat16)
    empty = msda_cuda.msda_fwd_bp(value, ((3, 4),), loc[:, :0].contiguous(),
                                  aw[:, :0].contiguous())
    assert empty.shape == (1, 0, 16)


@pytest.mark.parametrize("case", ["p3", "p4", "unaligned"])
def test_fwd_bp_routed_forms_bit_equal(cuda, case):
    """K11's bfloat16 form runs K1's kernel and its int8 form K4's: their
    outputs bit for bit, with bf16 and float32 out, on every level and on a
    level subset, at 3 and 4 points a level and on values one element off
    their allocation; a K11 launch moves K11's count alone."""
    shapes = ((20, 30), (10, 15), (5, 8), (3, 4))
    value, loc, aw = _inputs(cuda, torch.bfloat16, 2, 150, 8, 32, shapes,
                             P=3 if case == "p3" else 4, seed=11)
    vq, scale = msda.quantize_levels(value, shapes)
    if case == "unaligned":
        value, vq = _offset(value, 1), _offset(vq, 1)
    for kw in ({}, dict(out_dtype=torch.float32),
               dict(levels=(3, 1), out_dtype=torch.float32), dict(levels=(2,))):
        before = _counts()
        out = msda_cuda.msda_fwd_bp(value, shapes, loc, aw, **kw)
        assert _counts() == [b + (c == "msda_fwd_bp")
                             for b, c in zip(before, COUNTERS)]
        assert torch.equal(out, msda_cuda.msda_fwd(value, shapes, loc, aw,
                                                   **kw))
        ref = msda.msda_fwd_bp_plain(value, shapes, loc, aw, **kw)
        atol, rtol = TOL[out.dtype]
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)
    for kw in ({}, dict(levels=(3,)), dict(levels=(0, 2))):
        before = _counts()
        out = msda_cuda.msda_fwd_bp(vq, shapes, loc, aw, scale=scale, **kw)
        assert _counts() == [b + (c == "msda_fwd_bp")
                             for b, c in zip(before, COUNTERS)]
        assert torch.equal(out, msda_cuda.msda_fwd_q(vq, scale, shapes, loc,
                                                     aw, **kw))
        _assert_f32_close(out, msda.msda_fwd_bp_plain(vq, shapes, loc, aw,
                                                      scale=scale, **kw))


# --------------------------------------------------------------------------
# K1 and K2 in their Hopper layout: lanes over (sample, channel group), a
# warp walking several rows on large calls, a row's locations and weights
# handed out by shuffles where they fit one per lane, the vector width
# narrowed by D and the pointers' alignment
# --------------------------------------------------------------------------

LAYOUT_SHAPES = ((20, 30), (10, 15), (5, 8), (3, 4))
# (B, Q, H, P): rows of one warp each, rows walked four to a warp, and rows
# of 8 points (64 location floats) that each lane reads for itself
LAYOUT_CASES = {"one_row": (1, 200, 8, 4), "walked": (2, 1100, 8, 4),
                "no_handout": (1, 200, 8, 8)}


def _offset(t, elements):
    """``t``'s values in a contiguous tensor whose storage starts
    ``elements`` past an allocation: a pointer the wide load cannot take."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    out = buf[elements:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_k1_k2_layouts_match_plain_bit_equal(cuda, case, dtype):
    """K1 and K2 against their plain versions with one row per warp
    (decoder-like row counts), rows walked by a warp (encoder-like), and
    rows too long for the hand-out, and bit-equal over two runs on each."""
    B, Q, H, P = LAYOUT_CASES[case]
    value, loc, aw = _inputs(cuda, dtype, B, Q, H, 32, LAYOUT_SHAPES, P=P)
    L = len(LAYOUT_SHAPES)
    geom = msda_cuda.launch_geometry(B * Q * H, 32, L * P, L * P,
                                     value.element_size())
    assert geom.handout == (case != "no_handout")
    assert (geom.rows_per_warp > 1) == (case == "walked")
    out = msda_cuda.msda_fwd(value, LAYOUT_SHAPES, loc, aw)
    assert torch.equal(out, msda_cuda.msda_fwd(value, LAYOUT_SHAPES, loc, aw))
    ref = msda.ms_deform_attn_plain(value, LAYOUT_SHAPES, loc, aw)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    g = torch.randn((B, Q, H * 32), device=cuda).to(dtype)
    args = (value, LAYOUT_SHAPES, loc, aw, g)
    dloc, daw = msda_cuda.msda_bwd_rows(*args)
    again = msda_cuda.msda_bwd_rows(*args)
    assert torch.equal(dloc, again[0]) and torch.equal(daw, again[1])
    pv, pl, pa = msda.ms_deform_attn_plain_bwd(*args)
    _assert_bwd_close((pv, dloc, daw), (pv, pl, pa), dtype)
    # a level subset too (the windowed call's use): the hand-out still
    # holds the whole row
    out = msda_cuda.msda_fwd(value, LAYOUT_SHAPES, loc, aw, levels=(3, 1),
                             out_dtype=torch.float32)
    _assert_f32_close(out, msda.ms_deform_attn_plain(
        value, LAYOUT_SHAPES, loc, aw, levels=(3, 1),
        out_dtype=torch.float32))


def test_k1_k2_rows_per_warp_moves_no_bit(cuda, monkeypatch):
    """One warp sums each row whatever rows it walks: K1 gives the same bits
    with one, two, four or eight rows a warp, with and without the
    hand-out."""
    value, loc, aw = _inputs(cuda, torch.bfloat16, 1, 700, 8, 32,
                             LAYOUT_SHAPES)
    outs = []
    for walk in (1, 2, 4, 8):
        msda_cuda.launch_geometry.cache_clear()
        monkeypatch.setattr(msda_cuda, "rows_per_warp_for",
                            lambda rows, walk=walk: walk)
        outs.append(msda_cuda.msda_fwd(value, LAYOUT_SHAPES, loc, aw))
    msda_cuda.launch_geometry.cache_clear()
    real = msda_cuda.launch_geometry
    monkeypatch.setattr(msda_cuda, "launch_geometry",
                        lambda *a: replace(real(*a), handout=0))
    outs.append(msda_cuda.msda_fwd(value, LAYOUT_SHAPES, loc, aw))
    for got in outs[1:]:
        assert torch.equal(outs[0], got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D,offset", [(10, 0), (32, 1), (32, 2), (6, 0)])
def test_k1_k2_narrow_loads_match_plain(cuda, D, offset, dtype):
    """A head dim or a value (and output-gradient) pointer that the 16-byte
    load cannot take goes to a narrower load in the same kernels."""
    B, Q, H = 1, 90, 4
    value, loc, aw = _inputs(cuda, dtype, B, Q, H, D, LAYOUT_SHAPES)
    value = _offset(value, offset)
    g = _offset(torch.randn((B, Q, H * D), device=cuda).to(dtype), offset)
    geom = msda_cuda.launch_geometry(
        B * Q * H, D, 16, 16, value.element_size(),
        msda_cuda.pointer_alignment(value, g))
    assert geom.vec * value.element_size() < 16
    out = msda_cuda.msda_fwd(value, LAYOUT_SHAPES, loc, aw)
    ref = msda.ms_deform_attn_plain(value, LAYOUT_SHAPES, loc, aw)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    args = (value, LAYOUT_SHAPES, loc, aw, g)
    dloc, daw = msda_cuda.msda_bwd_rows(*args)
    pv, pl, pa = msda.ms_deform_attn_plain_bwd(*args)
    _assert_bwd_close((pv, dloc, daw), (pv, pl, pa), dtype)


def test_k1_k2_wide_head_dim_takes_chunks(cuda):
    """D = 256 in float32: 64 groups of four channels, two chunks of 32
    lanes, with rows walked four to a warp and one to a warp."""
    for Q in (2200, 50):
        value, loc, aw = _inputs(cuda, torch.float32, 1, Q, 8, 256,
                                 ((6, 9), (3, 5)))
        shapes = ((6, 9), (3, 5))
        _assert_f32_close(msda_cuda.msda_fwd(value, shapes, loc, aw),
                          msda.ms_deform_attn_plain(value, shapes, loc, aw))
        g = torch.randn((1, Q, 8 * 256), device=cuda)
        got = msda_cuda.msda_bwd_rows(value, shapes, loc, aw, g)
        ref = msda.ms_deform_attn_plain_bwd(value, shapes, loc, aw, g)
        _assert_bwd_close((ref[0], *got), ref, torch.float32)


def test_k1_k2_refuse_a_geometry_that_misses_work(cuda, monkeypatch):
    """The C side's checks (msda_geom.cuh:geometry_ok, and K2's one row a
    warp without the hand-out) refuse what the CPU tests' model of them
    refuses: a launch that would miss or repeat work, or hand out a row
    longer than the warp."""
    from test_torch_msda_geometry import _accepted

    B, Q, H = 1, 200, 8
    value, loc, aw = _inputs(cuda, torch.bfloat16, B, Q, H, 32, LAYOUT_SHAPES)
    g = torch.randn((B, Q, H * 32), device=cuda).to(torch.bfloat16)
    value8, loc8, aw8 = _inputs(cuda, torch.bfloat16, B, Q, H, 32,
                                LAYOUT_SHAPES, P=8)
    real = msda_cuda.launch_geometry
    calls = {
        16: (lambda: msda_cuda.msda_fwd(value, LAYOUT_SHAPES, loc, aw),
             lambda: msda_cuda.msda_bwd_rows(value, LAYOUT_SHAPES, loc, aw,
                                             g)),
        32: (lambda: msda_cuda.msda_fwd(value8, LAYOUT_SHAPES, loc8, aw8),
             lambda: msda_cuda.msda_bwd_rows(value8, LAYOUT_SHAPES, loc8,
                                             aw8, g))}
    for lp, kernels in calls.items():
        for call, walk in zip(kernels, (True, False)):
            geom = real(B * Q * H, 32, lp, lp, 2, 16, walk)
            bad = [replace(geom, blocks=geom.blocks - 1),
                   replace(geom, blocks=geom.blocks + 1),
                   replace(geom, passes=geom.passes - 1),
                   replace(geom, groups=geom.groups + 1),
                   replace(geom, rows_per_warp=0)]
            if lp == 32 or not walk:
                bad.append(replace(geom, handout=1))
            if not walk:
                bad.append(replace(geom, rows_per_warp=2,
                                   blocks=-(-geom.blocks // 2)))
            for geometry in bad:
                assert not _accepted(geometry, B * Q * H, 32, lp, lp, 2,
                                     walk)
                monkeypatch.setattr(msda_cuda, "launch_geometry",
                                    lambda *a, geometry=geometry, **k:
                                    geometry)
                with pytest.raises(RuntimeError, match="launch failed"):
                    call()
            monkeypatch.setattr(msda_cuda, "launch_geometry", real)
            call()


# --------------------------------------------------------------------------
# K3 (msda_bwd_value) with levels kept in shared memory, and K8
# (msda_bwd_win_rows_pp) with lanes over (query, point, channel group)
# --------------------------------------------------------------------------

@pytest.fixture(params=["global", "private"])
def k3_layout(request, monkeypatch):
    """K3 with every level through global memory, or with every level that
    fits but the largest kept in the block's shared memory (one block a
    (batch, head))."""
    msda_cuda.value_geometry.cache_clear()
    request.addfinalizer(msda_cuda.value_geometry.cache_clear)
    if request.param == "private":
        monkeypatch.setattr(msda_cuda, "N_SMS", 1)
        monkeypatch.setattr(msda_cuda, "PRIVATE_MIN_ADDS", 0)
        monkeypatch.setattr(msda_cuda, "PRIVATE_BYTES", 200 * 1024)
    else:
        monkeypatch.setattr(msda_cuda, "PRIVATE_BYTES", 0)
    return request.param


def _k3_private(value, shapes, loc, g, levels=None):
    taken = range(len(shapes)) if levels is None else levels
    geom = msda_cuda.value_geometry(
        value.shape[0], loc.shape[1], value.shape[2], value.shape[3],
        tuple(tuple(shapes[l]) for l in taken), loc.shape[4],
        value.element_size(), msda_cuda.pointer_alignment(g))
    return geom.private


K3_CASES = {
    "d32_batch2": dict(B=2, Q=70, H=8, D=32, shapes=((9, 13), (5, 7))),
    "d64": dict(B=1, Q=40, H=2, D=64, shapes=((6, 9), (3, 5))),
    # float32: 64 groups of 4 channels, two chunks of 32 lanes
    "d256_chunks": dict(B=1, Q=30, H=2, D=256, shapes=((6, 9), (3, 5))),
    "d8_thin_levels": CASES["d8_thin_levels"],
    "flipped_level": CASES["flipped_level"],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_k3_layouts_match_plain(cuda, k3_layout, case, dtype):
    """K3 against the plain backward's dvalue with its adds through global
    memory and through the block's shared copies; two runs as close as the
    plain version."""
    kw = K3_CASES[case]
    value, loc, aw = _inputs(cuda, dtype, **kw)
    shapes = kw["shapes"]
    g = torch.randn((kw["B"], kw["Q"], kw["H"] * kw["D"]),
                    device=cuda).to(dtype)
    args = (value, shapes, loc, aw, g)
    # every level but the largest (one stays in global memory)
    expect = 0 if k3_layout == "global" else (
        3 if case == "d8_thin_levels" else 2)
    assert _k3_private(value, shapes, loc, g) == expect
    got = msda_cuda.msda_bwd_value(*args)
    again = msda_cuda.msda_bwd_value(*args)
    ref = msda.ms_deform_attn_plain_bwd(*args)[0]
    _assert_bwd_close((got,), (ref,), dtype)
    # two runs differ in the order of their float32 sums, so in bf16 by
    # the rounding of the output at most
    _assert_bwd_close((again,), (got,), dtype)


def test_k3_on_pixel_centres_and_map_edges(cuda, k3_layout):
    """A sample on a pixel centre lands on that pixel exactly; samples on
    the map's edges and corners (0 and 1) and just outside it put their
    in-map corners' share in and nothing elsewhere."""
    h, w, D = 4, 4, 32
    value = torch.randn((1, h * w, 1, D), device=cuda)
    g = torch.randn((1, 1, D), device=cuda)
    aw = torch.ones((1, 1, 1, 1, 1), device=cuda)
    centre = torch.tensor([(1 + 0.5) / 4, (2 + 0.5) / 4], device=cuda)
    dvalue = msda_cuda.msda_bwd_value(value, ((h, w),),
                                      centre.reshape(1, 1, 1, 1, 1, 2), aw, g)
    expect = torch.zeros_like(value)
    expect[0, 9, 0] = g[0, 0]
    torch.testing.assert_close(dvalue, expect, atol=0, rtol=0)
    edges = torch.tensor([[0.0, 0.0], [1.0, 1.0], [0.0, 0.6], [1.0, 0.3],
                          [0.45, 0.0], [-0.1, 0.5], [1.1, 0.5], [0.5, -0.2]],
                         device=cuda)
    n = edges.shape[0]
    loc = edges.reshape(1, n, 1, 1, 1, 2).contiguous()
    aw = torch.rand((1, n, 1, 1, 1), device=cuda)
    g = torch.randn((1, n, D), device=cuda)
    args = (value, ((h, w),), loc, aw, g)
    got = msda_cuda.msda_bwd_value(*args)
    ref = msda.ms_deform_attn_plain_bwd(*args)[0]
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k3_level_subset_f32_out_and_narrow_loads(cuda, k3_layout, dtype):
    """A windowed call's use (a subset of the levels, the float32 sum as it
    is, the others zero) and g pointers or head dims the 16-byte load
    cannot take (D 10 and 6, g one or two elements off an allocation)."""
    value, loc, aw = _inputs(cuda, dtype, **CASES["d32_batch3"])
    shapes = CASES["d32_batch3"]["shapes"]
    g = torch.randn((3, 70, 256), device=cuda).to(dtype)
    for levels in ((1,), (0,), (1, 0)):
        got = msda_cuda.msda_bwd_value(value, shapes, loc, aw, g,
                                       levels=levels, out_dtype=torch.float32)
        ref = msda.ms_deform_attn_plain_bwd(value, shapes, loc, aw, g,
                                            levels=levels,
                                            dvalue_dtype=torch.float32)[0]
        assert got.dtype == torch.float32
        _assert_bwd_close((got,), (ref,), dtype)
        # level 0 holds tokens 0..116, level 1 the rest
        others = {(0,): slice(9 * 13, None), (1,): slice(0, 9 * 13)}
        if levels in others:
            assert not got[:, others[levels]].any()
    for D, offset in ((10, 0), (32, 1), (32, 2), (6, 0)):
        value, loc, aw = _inputs(cuda, dtype, 1, 90, 4, D, LAYOUT_SHAPES)
        g = _offset(torch.randn((1, 90, 4 * D), device=cuda).to(dtype),
                    offset)
        assert msda_cuda.vector_width(
            D, value.element_size(),
            msda_cuda.pointer_alignment(g)) * value.element_size() < 16
        args = (value, LAYOUT_SHAPES, loc, aw, g)
        _assert_bwd_close((msda_cuda.msda_bwd_value(*args),),
                          (msda.ms_deform_attn_plain_bwd(*args)[0],), dtype)


def test_k3_refuses_a_geometry_that_misses_work(cuda, monkeypatch):
    """msda_bwd.cu's value_geometry_ok refuses what the CPU tests' model of
    it refuses: blocks that miss a (batch, head), passes that miss samples,
    shared memory that does not hold the private levels, a mask bit beyond
    the levels, more threads than a block takes; and a geometry that keeps
    every level in more than 48 KB of shared memory works."""
    from test_torch_msda_geometry import _accepted_value

    B, Q, H, D = 1, 300, 2, 32
    shapes = ((20, 20), (3, 5))
    value, loc, aw = _inputs(cuda, torch.float32, B, Q, H, D, shapes)
    g = torch.randn((B, Q, H * D), device=cuda)
    real = msda_cuda.value_geometry
    geom = real(B, Q, H, D, shapes, 4, 4)
    # both levels kept: 54,780 bytes, above the 48 KB a launch may take
    # without the kernel's consent (cudaFuncSetAttribute)
    kept = replace(geom, private=3, smem_bytes=4 * (400 + 15) * (D + 1))
    assert _accepted_value(kept, B, Q, H, D, shapes, 4, 4)
    bad = [replace(geom, blocks=geom.blocks - 1),
           replace(geom, query_chunks=geom.query_chunks + 1),
           replace(geom, passes=geom.passes - 1),
           replace(geom, threads=2048),
           replace(geom, private=4),
           replace(kept, smem_bytes=kept.smem_bytes - 4),
           replace(geom, smem_bytes=64)]
    for geometry in (kept, *bad):
        monkeypatch.setattr(msda_cuda, "value_geometry",
                            lambda *a, geometry=geometry: geometry)
        args = (value, shapes, loc, aw, g)
        if geometry is kept:
            _assert_bwd_close((msda_cuda.msda_bwd_value(*args),),
                              (msda.ms_deform_attn_plain_bwd(*args)[0],),
                              torch.float32)
            continue
        assert not _accepted_value(geometry, B, Q, H, D, shapes, 4, 4)
        with pytest.raises(RuntimeError, match="launch failed"):
            msda_cuda.msda_bwd_value(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [8, 32, 48, 64])
def test_k8_bit_equal_and_matches_plain(cuda, D, dtype):
    """K8 on every banded level of a raster call whose query segments do not
    fall on a warp's query boundary (a warp's queries straddle two
    segments, the last warp has a Q tail): against the plain version,
    bit-equal over two runs, the padding rows zero."""
    shapes = ((21, 11), (11, 7), (6, 3))  # 231, 77, 18 queries a segment
    value, loc, aw = _raster(cuda, dtype, shapes, 2, 3, D)
    B, S, H, _ = value.shape
    g = torch.randn((B, S, H * D), device=cuda).to(dtype)
    for lid, (h, _) in enumerate(shapes):
        if h <= 8:
            continue
        args = _banded_bwd_args(value, loc, aw, g, shapes, lid, 8, True)
        geom = msda_cuda.win_geometry(
            B * H, S, D, 4, value.element_size(),
            msda_cuda.pointer_alignment(args[0], g))
        assert any(q0 % geom.queries for q0, _ in args[9][1:]) or (
            geom.queries == 1)
        got = msda_cuda.msda_bwd_win_rows_pp(*args)
        again = msda_cuda.msda_bwd_win_rows_pp(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        ref = msda.msda_bwd_win_plain(*args)
        _assert_win_bwd_close((ref[0], *got), ref, dtype)


def test_k8_refuses_a_geometry_that_misses_work(cuda, monkeypatch):
    """msda_band.cuh's win_geometry_ok refuses what the CPU tests' model of
    it refuses."""
    from test_torch_msda_geometry import _accepted_win

    shapes = ((24, 16), (12, 8))
    value, loc, aw = _raster(cuda, torch.float32, shapes, 1, 2, 32)
    g = torch.randn((1, value.shape[1], 64), device=cuda)
    args = _banded_bwd_args(value, loc, aw, g, shapes, 0, 8, True)
    Q = args[-1]
    geom = msda_cuda.win_geometry(2, Q, 32, 4, 4)
    bad = [replace(geom, blocks=geom.blocks - 1),
           replace(geom, blocks=geom.blocks + 1),
           replace(geom, passes=geom.passes - 1),
           replace(geom, queries=geom.queries * 2),
           replace(geom, groups=geom.groups + 1),
           replace(geom, threads=512)]
    for geometry in bad:
        assert not _accepted_win(geometry, 2, Q, 32, 4, 4)
        monkeypatch.setattr(msda_cuda, "win_geometry",
                            lambda *a, geometry=geometry: geometry)
        with pytest.raises(RuntimeError, match="launch failed"):
            msda_cuda.msda_bwd_win_rows_pp(*args)


# --------------------------------------------------------------------------
# K6 (msda_fwd_win_pp) and K10 (msda_bwd_win_value_pp) in their Hopper
# layout
# --------------------------------------------------------------------------

# segments that do not fall on a warp's query boundary (231, 77, 18
# queries), a last band that overhangs at window 8 (h = 21) and a level at
# window 32 of two bands
K6_K10_CASES = {"w8": (8, ((21, 11), (11, 7), (6, 3))),
                "w32": (32, ((70, 9), (35, 5)))}


def _unaligned(t, offset):
    """``t``'s values in a tensor whose storage starts ``offset`` elements
    into an allocation (its data pointer off the 16-byte alignment)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _k6_level_args(value, loc, aw, shapes, lid, window, int8,
                   per_point=True):
    value_l, bidx, ix, iy_band, aw_eff, _, h, w, win, segs, Q = (
        _banded_bwd_args(value, loc, aw, None, shapes, lid, window,
                         per_point))
    if int8:
        vq, scale = msda.quantize_levels(value, shapes)
        start = msda.level_starts(shapes)[lid]
        value_l = vq[:, start:start + h * w]
        aw_eff = aw_eff * scale[:, :, lid, None, None]
    return value_l, bidx, ix, iy_band, aw_eff, h, w, win, segs, Q


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("D", [8, 32, 48, 64])
@pytest.mark.parametrize("case", sorted(K6_K10_CASES))
def test_k6_bit_equal_and_matches_plain(cuda, case, D, form):
    """K6 on every banded level of a raster call at batch 2 (the first and
    last tiles' bands at the top and bottom edge): against the plain
    version, bit-equal over two runs, one launch a call."""
    window, shapes = K6_K10_CASES[case]
    dtype = torch.float32 if form == "f32" else torch.bfloat16
    value, loc, aw = _raster(cuda, dtype, shapes, 2, 2, D)
    for lid, (h, _) in enumerate(shapes):
        if h <= window:
            continue
        args = _k6_level_args(value, loc, aw, shapes, lid, window,
                              form == "int8")
        before = _counts()
        got = msda_cuda.msda_fwd_win_pp(*args)
        assert _counts() == [b + (c == "msda_fwd_win_pp")
                             for b, c in zip(before, COUNTERS)]
        assert torch.equal(got, msda_cuda.msda_fwd_win_pp(*args))
        _assert_f32_close(got, msda.msda_fwd_win_plain(*args))


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_k6_unaligned_values_match_plain(cuda, offset, form):
    """K6 with its values' pointer off the 16-byte alignment: narrower
    loads (down to one channel a lane), the same function."""
    window, shapes = K6_K10_CASES["w8"]
    dtype = torch.float32 if form == "f32" else torch.bfloat16
    value, loc, aw = _raster(cuda, dtype, shapes, 2, 2, 32)
    args = list(_k6_level_args(value, loc, aw, shapes, 0, window,
                               form == "int8"))
    args[0] = _unaligned(args[0], offset)
    geom = msda_cuda.win_geometry(
        4, args[-1], 32, 4, args[0].element_size(),
        msda_cuda.pointer_alignment(args[0]), "fwd")
    assert geom.vec * args[0].element_size() <= offset * args[0].element_size()
    _assert_f32_close(msda_cuda.msda_fwd_win_pp(*args),
                      msda.msda_fwd_win_plain(*args))


@pytest.mark.parametrize("P", [1, 3, 8])
def test_k6_points_without_a_fold(cuda, P):
    """K6 where P does not divide the samples a pass holds (3; 8 at D = 64
    in float32) and where a query has one point: the lane walks its
    query's points, or folds them, with the same function."""
    window, shapes = K6_K10_CASES["w8"]
    value, loc, aw = _raster(cuda, torch.float32, shapes, 2, 2, 64, P=P)
    args = _k6_level_args(value, loc, aw, shapes, 0, window, False)
    geom = msda_cuda.win_geometry(4, args[-1], 64, P, 4, form="fwd")
    assert geom.fold == int(P == 1)
    got = msda_cuda.msda_fwd_win_pp(*args)
    assert torch.equal(got, msda_cuda.msda_fwd_win_pp(*args))
    _assert_f32_close(got, msda.msda_fwd_win_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [8, 32, 48, 64])
@pytest.mark.parametrize("case", sorted(K6_K10_CASES))
def test_k10_adds_into_a_slice_and_matches_plain(cuda, case, D, dtype):
    """K10 on every banded level of a raster call at batch 2: into a fresh
    buffer and into the level's slice of a [B, S, H, D] float32 gradient
    that already holds values (it adds; the rest of the gradient is not
    touched), against the plain version; two runs differ in the last bits
    at most."""
    window, shapes = K6_K10_CASES[case]
    value, loc, aw = _raster(cuda, dtype, shapes, 2, 2, D)
    B, S, H, _ = value.shape
    g = torch.randn((B, S, H * D), device=cuda).to(dtype)
    starts = msda.level_starts(shapes)
    for lid, (h, w) in enumerate(shapes):
        if h <= window:
            continue
        args = _banded_bwd_args(value, loc, aw, g, shapes, lid, window, True)
        ref = msda.msda_bwd_win_plain(*args)[0]
        fresh = msda_cuda.msda_bwd_win_value_pp(*args)
        _assert_win_bwd_close((fresh,), (ref,), dtype)
        torch.testing.assert_close(fresh, msda_cuda.msda_bwd_win_value_pp(
            *args), atol=1e-5, rtol=1e-5)
        held = torch.randn((B, S, H, D), device=cuda)
        dvalue = held.clone()
        level = slice(starts[lid], starts[lid] + h * w)
        before = _counts()
        got = msda_cuda.msda_bwd_win_value_pp(*args, out=dvalue[:, level])
        assert _counts() == [b + (c == "msda_bwd_win_value_pp")
                             for b, c in zip(before, COUNTERS)]
        assert got.data_ptr() == dvalue[:, level].data_ptr()
        _assert_win_bwd_close((dvalue[:, level] - held[:, level],), (ref,),
                              dtype)
        rest = torch.ones(S, dtype=torch.bool, device=cuda)
        rest[level] = False
        assert torch.equal(dvalue[:, rest], held[:, rest])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("offset", [1, 2])
def test_k10_unaligned_pointers_match_plain(cuda, offset, dtype):
    """K10 with g, or the gradient it adds into, off the 16-byte alignment:
    narrower adds, the same function."""
    window, shapes = K6_K10_CASES["w8"]
    value, loc, aw = _raster(cuda, dtype, shapes, 2, 2, 32)
    B, S, H, D = value.shape
    g = torch.randn((B, S, H * D), device=cuda).to(dtype)
    args = list(_banded_bwd_args(value, loc, aw, g, shapes, 0, window, True))
    h, w = shapes[0]
    ref = msda.msda_bwd_win_plain(*args)[0]
    args[5] = _unaligned(g, offset)
    _assert_win_bwd_close((msda_cuda.msda_bwd_win_value_pp(*args),), (ref,),
                          dtype)
    dvalue = _unaligned(torch.zeros((B, S, H, D), device=cuda), offset)
    msda_cuda.msda_bwd_win_value_pp(*args, out=dvalue[:, :h * w])
    _assert_win_bwd_close((dvalue[:, :h * w],), (ref,), dtype)


def test_k6_k10_refuse_a_geometry_that_misses_work(cuda, monkeypatch):
    """msda_band.cuh's win_geometry_ok refuses for K6 and K10, and for K5
    and K9, which take their launch, what the CPU tests' model of it
    refuses; K10 and K9 refuse an output that is not a float32 [B, h*w, H,
    D] view contiguous within a batch."""
    from test_torch_msda_geometry import _accepted_win

    shapes = ((24, 16), (12, 8))
    value, loc, aw = _raster(cuda, torch.bfloat16, shapes, 1, 2, 32)
    g = torch.randn((1, value.shape[1], 64), device=cuda).bfloat16()
    args = _banded_bwd_args(value, loc, aw, g, shapes, 0, 8, True)
    tile = _banded_bwd_args(value, loc, aw, g, shapes, 0, 8, False)
    fwd_args = (*args[:5], *args[6:])
    fwd_tile = (*tile[:5], *tile[6:])
    Q = args[-1]
    real = msda_cuda.win_geometry
    for form, call, es in (
            ("fwd", lambda: msda_cuda.msda_fwd_win_pp(*fwd_args), 2),
            ("fwd", lambda: msda_cuda.msda_fwd_win(*fwd_tile), 2),
            ("value", lambda: msda_cuda.msda_bwd_win_value_pp(*args), 4),
            ("value", lambda: msda_cuda.msda_bwd_win_value(*tile), 4)):
        geom = real(2, Q, 32, 4, 2, form=form)
        bad = [replace(geom, blocks=geom.blocks - 1),
               replace(geom, passes=geom.passes - 1),
               replace(geom, queries=geom.queries * 2),
               replace(geom, groups=geom.groups + 1),
               replace(geom, fold=2 if form == "fwd" else 1),
               replace(geom, vec=8, groups=4, lps_log2=2) if form == "value"
               else replace(geom, threads=512)]
        for geometry in bad:
            assert not _accepted_win(geometry, 2, Q, 32, 4, es, form)
            monkeypatch.setattr(msda_cuda, "win_geometry",
                                lambda *a, geometry=geometry: geometry)
            with pytest.raises(RuntimeError, match="launch failed"):
                call()
        monkeypatch.setattr(msda_cuda, "win_geometry", real)
    h, w = shapes[0]
    good = torch.zeros((1, h * w, 2, 32), device=cuda)
    for out in (good.bfloat16(), good[:, :-1], good.cpu(),
                good.transpose(2, 3).contiguous().transpose(2, 3)):
        for value_kernel, value_args in (
                (msda_cuda.msda_bwd_win_value_pp, args),
                (msda_cuda.msda_bwd_win_value, tile)):
            with pytest.raises(ValueError, match="out must be"):
                value_kernel(*value_args, out=out)


# --------------------------------------------------------------------------
# K4 (msda_fwd_q) and K7 (msda_bwd_win_rows, through K8's kernel) in their
# Hopper layout
# --------------------------------------------------------------------------

K4_CASES = {**CASES,
            # P that does not divide a pass, rows that do not fill a warp
            "p3_d16": dict(B=2, Q=31, H=3, D=16, P=3,
                           shapes=((6, 9), (3, 5))),
            # more samples a row than a pass holds
            "p8_d32": dict(B=1, Q=17, H=2, D=32, P=8,
                           shapes=((6, 9), (3, 5), (2, 3), (1, 4)))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_bit_equal_and_matches_plain(cuda, case, dtype, monkeypatch):
    """K4 at D 8-64, batches of 1-3, thin and flipped (round_y) levels,
    samples outside the map, P 3 and 8, on every level and on level
    subsets, with corner loads of at most 16 and 8 bytes: against the plain
    version, bit-equal over two runs."""
    kw = dict(K4_CASES[case])
    shapes = kw["shapes"]
    value, loc, aw = _inputs(cuda, dtype, **kw)
    vq, scale = msda.quantize_levels(value, shapes)
    subsets = [None, (len(shapes) - 1,), tuple(range(0, len(shapes), 2))]
    for cap in (16, 8):
        msda_cuda.q_geometry.cache_clear()
        monkeypatch.setattr(msda_cuda, "Q_VEC_BYTES", cap)
        for levels in subsets:
            args = (vq, scale, shapes, loc, aw)
            got = msda_cuda.msda_fwd_q(*args, levels=levels)
            assert torch.equal(got, msda_cuda.msda_fwd_q(*args,
                                                         levels=levels))
            _assert_f32_close(got, msda.msda_fwd_q_plain(*args,
                                                         levels=levels))
    msda_cuda.q_geometry.cache_clear()


@pytest.mark.parametrize("offset", [1, 2, 4, 8])
def test_k4_unaligned_values_match_plain(cuda, offset):
    """int8 values whose storage starts off the 16-byte alignment: the
    corner loads narrow to what the pointer allows."""
    kw = dict(CASES["d32_batch3"])
    shapes = kw["shapes"]
    value, loc, aw = _inputs(cuda, torch.bfloat16, **kw)
    vq, scale = msda.quantize_levels(value, shapes)
    moved = _unaligned(vq, offset)
    assert msda_cuda.pointer_alignment(moved) == offset
    got = msda_cuda.msda_fwd_q(moved, scale, shapes, loc, aw)
    _assert_f32_close(got, msda.msda_fwd_q_plain(vq, scale, shapes, loc, aw))
    assert torch.equal(got, msda_cuda.msda_fwd_q(moved, scale, shapes, loc,
                                                 aw))


def test_k4_refuses_a_geometry_that_misses_work(cuda, monkeypatch):
    """msda_fwd_q.cu's q_geometry_ok refuses what the CPU tests' model of it
    refuses."""
    from test_torch_msda_geometry import _accepted_q

    kw = dict(CASES["d32_batch3"])
    shapes = kw["shapes"]
    value, loc, aw = _inputs(cuda, torch.float32, **kw)
    vq, scale = msda.quantize_levels(value, shapes)
    B, Q, H, D = 3, 70, 8, 32
    ns = len(shapes) * 4
    geom = msda_cuda.q_geometry(B * Q * H, D, ns)
    assert _accepted_q(geom, B * Q * H, D, ns)
    bad = [replace(geom, blocks=geom.blocks - 1),
           replace(geom, blocks=geom.blocks + 1),
           replace(geom, passes=geom.passes - 1),
           replace(geom, slots_log2=5),
           replace(geom, groups=geom.groups + 1),
           replace(geom, threads=512)]
    for geometry in bad:
        assert not _accepted_q(geometry, B * Q * H, D, ns)
        monkeypatch.setattr(msda_cuda, "q_geometry",
                            lambda *a, geometry=geometry: geometry)
        with pytest.raises(RuntimeError, match="launch failed"):
            msda_cuda.msda_fwd_q(vq, scale, shapes, loc, aw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(c for c in WIN_CASES
                                        if c != "w32_all_exact"))
def test_k7_bit_equal_to_k8_on_broadcast_bands(cuda, case, dtype):
    """K7 runs K8's kernel with a band table whose point stride is 0: on
    every banded level (windows 8, 16 and 32, an overhanging last band,
    batches of 1-3, D 8-64) it is bit-equal to K8 given K7's tile bands
    broadcast over the points, bit-equal over two runs, and held to the
    plain version."""
    kw = dict(WIN_CASES[case])
    window, shapes = kw.pop("window"), kw["shapes"]
    value, loc, aw = _raster(cuda, dtype, **kw)
    B, S, H, D = value.shape
    g = torch.randn((B, S, H * D), device=cuda).to(dtype)
    for lid, (h, _) in enumerate(shapes):
        if h <= window:
            continue
        args = _banded_bwd_args(value, loc, aw, g, shapes, lid, window, False)
        bidx = args[1]
        P = args[2].shape[2]
        wide = bidx[:, :, None, :].expand(B, H, P, bidx.shape[-1])
        got = msda_cuda.msda_bwd_win_rows(*args)
        assert all(torch.equal(a, b) for a, b in zip(
            got, msda_cuda.msda_bwd_win_rows(*args)))
        assert all(torch.equal(a, b) for a, b in zip(
            got, msda_cuda.msda_bwd_win_rows_pp(args[0], wide.contiguous(),
                                                *args[2:])))
        ref = msda.msda_bwd_win_plain(*args)
        _assert_win_bwd_close((ref[0], *got), ref, dtype)


# --------------------------------------------------------------------------
# K5 (msda_fwd_win) and K9 (msda_bwd_win_value) through K6's and K10's
# kernels
# --------------------------------------------------------------------------

def _broadcast(bidx, P):
    """A tile band table [B, H, T] broadcast over P points: the per-point
    kernels' table for the same bands."""
    B, H, T = bidx.shape
    return bidx[:, :, None, :].expand(B, H, P, T).contiguous()


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", sorted(c for c in WIN_CASES
                                        if c != "w32_all_exact"))
def test_k5_bit_equal_to_k6_on_broadcast_bands(cuda, case, form):
    """K5 runs K6's kernel with a band table whose point stride is 0: on
    every banded level (windows 8, 16 and 32, an overhanging last band,
    batches of 1-3, D 8-64) it is bit-equal to K6 given K5's tile bands
    broadcast over the points, bit-equal over two runs, one launch a call,
    and held to the plain version."""
    kw = dict(WIN_CASES[case])
    window, shapes = kw.pop("window"), kw["shapes"]
    dtype = torch.float32 if form == "f32" else torch.bfloat16
    value, loc, aw = _raster(cuda, dtype, **kw)
    for lid, (h, _) in enumerate(shapes):
        if h <= window:
            continue
        args = _k6_level_args(value, loc, aw, shapes, lid, window,
                              form == "int8", per_point=False)
        before = _counts()
        got = msda_cuda.msda_fwd_win(*args)
        assert _counts() == [b + (c == "msda_fwd_win")
                             for b, c in zip(before, COUNTERS)]
        assert torch.equal(got, msda_cuda.msda_fwd_win(*args))
        wide = _broadcast(args[1], args[2].shape[2])
        assert torch.equal(got, msda_cuda.msda_fwd_win_pp(args[0], wide,
                                                          *args[2:]))
        _assert_f32_close(got, msda.msda_fwd_win_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [8, 32, 64])
@pytest.mark.parametrize("case", sorted(K6_K10_CASES))
def test_k9_adds_into_a_slice_and_matches_k10(cuda, case, D, dtype):
    """K9 on every banded level of a raster call at batch 2: into a fresh
    buffer and into the level's slice of a wider [B, S, H, D] float32
    gradient that already holds values (it adds; the rest of the gradient
    is not touched), against the plain version, and against K10 given its
    tile bands broadcast over the points (the same sums up to the order of
    the float32 additions)."""
    window, shapes = K6_K10_CASES[case]
    value, loc, aw = _raster(cuda, dtype, shapes, 2, 2, D)
    B, S, H, _ = value.shape
    g = torch.randn((B, S, H * D), device=cuda).to(dtype)
    starts = msda.level_starts(shapes)
    for lid, (h, w) in enumerate(shapes):
        if h <= window:
            continue
        args = _banded_bwd_args(value, loc, aw, g, shapes, lid, window, False)
        ref = msda.msda_bwd_win_plain(*args)[0]
        fresh = msda_cuda.msda_bwd_win_value(*args)
        _assert_win_bwd_close((fresh,), (ref,), dtype)
        wide = _broadcast(args[1], args[2].shape[2])
        torch.testing.assert_close(fresh, msda_cuda.msda_bwd_win_value_pp(
            args[0], wide, *args[2:]), atol=1e-5, rtol=1e-5)
        held = torch.randn((B, S, H, D), device=cuda)
        dvalue = held.clone()
        level = slice(starts[lid], starts[lid] + h * w)
        before = _counts()
        got = msda_cuda.msda_bwd_win_value(*args, out=dvalue[:, level])
        assert _counts() == [b + (c == "msda_bwd_win_value")
                             for b, c in zip(before, COUNTERS)]
        assert got.data_ptr() == dvalue[:, level].data_ptr()
        _assert_win_bwd_close((dvalue[:, level] - held[:, level],), (ref,),
                              dtype)
        rest = torch.ones(S, dtype=torch.bool, device=cuda)
        rest[level] = False
        assert torch.equal(dvalue[:, rest], held[:, rest])
