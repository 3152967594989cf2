"""The MSDA CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip without one. They cover
what chip_smoke.py's main-path shapes do not reach: head dims other than 32
(the kernels' channel loop), batches above 1, 1-wide levels, a level where
the forward's bf16 rounding moves to the y weights, samples on pixel centres
and outside the map, and the wrappers' refusals, for the forward kernel and
the two backward kernels. On a GPU machine without JAX, run them without the
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
