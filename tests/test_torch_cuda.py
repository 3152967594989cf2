"""The MSDA CUDA kernel against its plain version, on the card.

These tests need an NVIDIA GPU with nvcc and skip without one. They cover
what chip_smoke.py's main-path shapes do not reach: head dims other than 32
(the kernel's channel loop), batches above 1, 1-wide levels, a level where
the bf16 rounding moves to the y weights, samples on pixel centres, and the
wrapper's refusals. On a GPU machine without JAX, run them without the
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
