"""The port's MSDA (egtr_tpu_torch.ops.msda) against the JAX package's, on the CPU.

The plain PyTorch version is what a CPU tensor runs and what chip_smoke.py
holds the CUDA kernel against on the card. Here it is held against
egtr_tpu's ``ms_deform_attn`` with impl="pallas" (the Pallas kernel K1 in
interpret mode, as tests/test_msda.py runs it), impl="matmul", and the
``grid_sample`` oracle of tests/test_msda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from egtr_tpu.ops.msda import ms_deform_attn as jax_msda
from egtr_tpu_torch.ops import msda, msda_cuda

torch.set_num_threads(1)

# float32: summation order only, as tests/test_msda.py:70
ATOL, RTOL = 1e-5, 1e-4
# bfloat16 output: both sides round the same weights the same way and sum in
# float32, so they can differ by one bf16 rounding of the result (a relative
# step of 2**-8 = 3.9e-3); allow two steps
BF16_RTOL, BF16_ATOL = 2 * 2.0 ** -8, 1e-3


def grid_sample_oracle(value, spatial_shapes, loc, aw):
    """The reference debug implementation (model/deformable_detr.py:925-960),
    as tests/test_msda.py:18-46 composes it."""
    N, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    values = value.split([h * w for h, w in spatial_shapes], dim=1)
    grids = 2 * loc - 1
    sampled = []
    for lid, (h, w) in enumerate(spatial_shapes):
        v = values[lid].flatten(2).transpose(1, 2).reshape(N * M, D, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    aw = aw.transpose(1, 2).reshape(N * M, 1, Lq, L * P)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * aw).sum(-1)
    return out.view(N, M * D, Lq).transpose(1, 2)


def make_inputs(seed, B=2, Q=7, H=4, D=8, shapes=((6, 9), (3, 5), (2, 2))):
    rng = np.random.default_rng(seed)
    L, P = len(shapes), 4
    S = sum(h * w for h, w in shapes)
    value = rng.standard_normal((B, S, H, D)).astype(np.float32)
    # locations roam outside [0,1] to exercise the zero padding
    loc = rng.uniform(-0.2, 1.2, size=(B, Q, H, L, P, 2)).astype(np.float32)
    aw = rng.uniform(0, 1, size=(B, Q, H, L * P)).astype(np.float32)
    aw = (aw / aw.sum(-1, keepdims=True)).reshape(B, Q, H, L, P)
    return value, shapes, loc, aw


def torch_inputs(seed, **kw):
    return tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in make_inputs(seed, **kw))


CASES = {
    "default": dict(),
    # D=32 is the deployed head dim
    "d32": dict(B=1, Q=9, H=2, D=32, shapes=((5, 7), (3, 3))),
    # 1-wide and 1-tall levels (egtr_tpu/ops/msda.py:215)
    "thin_levels": dict(B=1, Q=6, H=2, D=8, shapes=((4, 1), (1, 5), (3, 3))),
}


@pytest.mark.parametrize("reference", ["pallas", "matmul", "grid_sample"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_f32(case, reference):
    value, shapes, loc, aw = make_inputs(11, **CASES[case])
    out = msda.ms_deform_attn_plain(*torch_inputs(11, **CASES[case]))
    if reference == "grid_sample":
        ref = grid_sample_oracle(torch.from_numpy(value), shapes,
                                 torch.from_numpy(loc), torch.from_numpy(aw))
    else:
        ref = jax_msda(jnp.asarray(value), shapes, jnp.asarray(loc),
                       jnp.asarray(aw), impl=reference)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


BF16_CASES = {
    "d32": dict(B=1, Q=9, H=2, D=32, shapes=((5, 7), (3, 3))),
    "thin_levels": dict(B=1, Q=6, H=2, D=8, shapes=((4, 1), (1, 5), (3, 3))),
    # w > 128 >= h and cheaper along y: the JAX kernel flips its orientation
    # there and rounds the y weights instead of the x weights
    "flipped_level": dict(B=1, Q=5, H=1, D=4, shapes=((100, 168), (3, 3))),
}


# the matmul path never flips its orientation, so it sees no flipped level
BF16_PAIRS = [(case, ref) for case in sorted(BF16_CASES)
              for ref in ("pallas", "matmul")
              if not (case == "flipped_level" and ref == "matmul")]


@pytest.mark.parametrize("case,reference", BF16_PAIRS)
def test_plain_matches_jax_bf16(case, reference):
    """bfloat16 values and weights, float32 locations, as the model passes
    them (egtr_tpu/models/layers.py:225-227)."""
    value, shapes, loc, aw = make_inputs(12, **BF16_CASES[case])
    v = torch.from_numpy(value).bfloat16()
    a = torch.from_numpy(aw).bfloat16()
    out = msda.ms_deform_attn_plain(v, shapes, torch.from_numpy(loc), a)
    ref = jax_msda(jnp.asarray(v.float().numpy(), jnp.bfloat16), shapes,
                   jnp.asarray(loc), jnp.asarray(a.float().numpy(),
                                                 jnp.bfloat16),
                   impl=reference)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


def test_orientation_matches_jax():
    from egtr_tpu.ops.msda_pallas import _orient as jax_orient

    for h, w in ((76, 126), (100, 168), (168, 100), (1, 500), (10, 16)):
        assert msda._orient(h, w, 32) == jax_orient(h, w, 32)
    assert msda._orient(100, 168, 32) == "y"


def test_exact_interior_point():
    """A sample exactly at a pixel center returns that pixel's value."""
    rng = np.random.default_rng(0)
    value = torch.from_numpy(rng.standard_normal((1, 16, 1, 2)).astype(np.float32))
    loc = torch.tensor([(1 + 0.5) / 4, (2 + 0.5) / 4]).reshape(1, 1, 1, 1, 1, 2)
    aw = torch.ones((1, 1, 1, 1, 1))
    out = msda.ms_deform_attn_plain(value, ((4, 4),), loc, aw)
    torch.testing.assert_close(out[0, 0], value[0, 2 * 4 + 1, 0], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("impl", ["auto", "pallas", "matmul", "gather"])
def test_dispatch_on_cpu_takes_plain(impl):
    value, shapes, loc, aw = torch_inputs(3)
    before = msda_cuda.launches
    out = msda.ms_deform_attn(value, shapes, loc, aw, impl=impl)
    assert msda_cuda.launches == before
    torch.testing.assert_close(
        out, msda.ms_deform_attn_plain(value, shapes, loc, aw), rtol=0, atol=0)


def test_dispatch_rejects_unknown_impl():
    value, shapes, loc, aw = torch_inputs(3)
    with pytest.raises(ValueError, match="unknown msda impl"):
        msda.ms_deform_attn(value, shapes, loc, aw, impl="grid_sample")
    with pytest.raises(ValueError, match="spatial shapes"):
        msda.ms_deform_attn(value, shapes[:2], loc, aw)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches the kernel or raises: no fallback."""
    value, shapes, loc, aw = torch_inputs(3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.msda_fwd(value, shapes, loc, aw)


def _bad_inputs():
    value, shapes, loc, aw = torch_inputs(3)
    yield "value must be float32 or bfloat16", (value.double(), shapes, loc, aw)
    yield "sampling_locations must be float32", (value, shapes, loc.bfloat16(), aw)
    yield "value dtype", (value, shapes, loc, aw.bfloat16())
    yield "do not cover", (value, ((6, 9), (3, 5), (2, 3)), loc, aw)
    yield "levels", (value, (), loc, aw)
    yield r"\[B,Q,H,L,P,2\]", (value, shapes, loc[..., :1], aw)
    yield "attention_weights must be", (value, shapes, loc, aw[..., :2])
    yield "contiguous", (value.transpose(0, 1).contiguous().transpose(0, 1),
                         shapes, loc, aw)


@pytest.mark.parametrize("match,args", list(_bad_inputs()),
                         ids=[m for m, _ in _bad_inputs()])
def test_kernel_input_checks(match, args):
    with pytest.raises((TypeError, ValueError), match=match):
        msda_cuda.check_inputs(*args)


def test_level_table():
    """(h, w, start token, round y) per level; y is rounded only in a
    low-precision dtype on a level the JAX kernel flips."""
    shapes = ((76, 126), (100, 168), (10, 16))
    assert msda_cuda.level_table(shapes, 32, torch.float32) == [
        76, 126, 0, 0, 100, 168, 76 * 126, 0, 10, 16, 76 * 126 + 16800, 0]
    assert msda_cuda.level_table(shapes, 32, torch.bfloat16)[7] == 1


def test_build_command_and_cache_key(tmp_path, monkeypatch):
    """The kernel builds with nvcc for sm_90a into a library named by a hash
    of the source, so an edited source builds anew."""
    cmd = msda_cuda.build_command("nvcc", tmp_path / "lib.so")
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert "-shared" in cmd and str(msda_cuda.SOURCE) == cmd[-1]
    path = msda_cuda.library_path()
    assert path.parent == msda_cuda.BUILD_DIR
    src = tmp_path / "msda_fwd.cu"
    src.write_text(msda_cuda.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(msda_cuda, "SOURCE", src)
    assert msda_cuda.library_path() != path


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(msda_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(msda_cuda.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        msda_cuda._nvcc()
