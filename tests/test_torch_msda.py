"""The port's MSDA (egtr_tpu_torch.ops.msda) against the JAX package's, on the CPU.

The plain PyTorch version is what a CPU tensor runs and what chip_smoke.py
holds the CUDA kernel against on the card. Here it is held against
egtr_tpu's ``ms_deform_attn`` with impl="pallas" (the Pallas kernel K1 in
interpret mode, as tests/test_msda.py runs it), impl="matmul", and the
``grid_sample`` oracle of tests/test_msda.py. The explicit backward
(``ms_deform_attn_plain_bwd``, what the CUDA backward kernels are held against)
is held against ``jax.vjp`` of the same Pallas op (kernels K2 and K3 in
interpret mode), and the autograd op against numerical differentiation.
"""

import jax
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


# --------------------------------------------------------------------------
# backward
# --------------------------------------------------------------------------

BWD_CASES = {
    # one sample exactly on the integer grid (pixel centre of (y=3, x=2) on
    # level 0): both hats sit on a kink there
    "default_on_grid": dict(),
    "d32": dict(B=1, Q=9, H=2, D=32, shapes=((5, 7), (3, 3))),
    "thin_levels": dict(B=1, Q=6, H=2, D=8, shapes=((4, 1), (1, 5), (3, 3))),
    # (96,130) with D=8 flips to orient "y" in the forward
    # (tests/test_msda.py:143-168); the backward never flips
    "flipped_level": dict(B=1, Q=5, H=1, D=8, shapes=((96, 130), (3, 3))),
}

# bfloat16: both sides round the same products (dT, hat_x) and sum in
# float32. dvalue and daw are rounded once to bf16 from sums that differ in
# their order: one bf16 step (2**-8 relative), allow two. dloc stays float32;
# its terms are bf16-exact products, so it differs by summation order scaled
# by the level size (dix*w): atol 1e-4 on values up to ~100.
BWD_TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
           "bfloat16": dict(atol=1e-3, rtol=2 * 2.0 ** -8)}
DLOC_TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
            "bfloat16": dict(atol=1e-4, rtol=1e-4)}


def bwd_inputs(seed, case):
    value, shapes, loc, aw = make_inputs(seed, **BWD_CASES[case])
    if case == "default_on_grid":
        loc[0, 0, 0, 0, 0] = [(2 + 0.5) / 9, (3 + 0.5) / 6]
    B, Q, H = loc.shape[:3]
    g = np.random.default_rng(seed + 100).standard_normal(
        (B, Q, H * value.shape[-1])).astype(np.float32)
    return value, shapes, loc, aw, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_bwd_matches_jax_vjp(case, dtype):
    value, shapes, loc, aw, g = bwd_inputs(21, case)
    if case == "flipped_level":
        from egtr_tpu.ops.msda_pallas import _orient as jax_orient
        assert jax_orient(96, 130, 8) == "y"
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(
        lambda v, l, a: jax_msda(v, shapes, l, a, impl="pallas"),
        jnp.asarray(value, jd), jnp.asarray(loc), jnp.asarray(aw, jd))
    ref = vjp(jnp.asarray(g, jd))
    tv, ta, tg = (torch.from_numpy(x).to(td) for x in (value, aw, g))
    got = msda.ms_deform_attn_plain_bwd(tv, shapes, torch.from_numpy(loc),
                                        ta, tg)
    assert [t.dtype for t in got] == [td, torch.float32, td]
    assert [tuple(t.shape) for t in got] == [value.shape, loc.shape, aw.shape]
    for name, a, b in zip(("dvalue", "dloc", "daw"), got, ref):
        tol = (DLOC_TOL if name == "dloc" else BWD_TOL)[dtype]
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   err_msg=name, **tol)
    if case == "default_on_grid":
        # sign(0) = 0 and the far corner is outside the support
        assert got[1][0, 0, 0, 0, 0].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("impl", ["auto", "matmul"])
def test_autograd_op_gradcheck_f64(impl):
    """The op's explicit backward against central differences in float64,
    off the integer grid (random locations; the step of 1e-6 crosses no
    kink for this seed)."""
    value, shapes, loc, aw = make_inputs(31, B=1, Q=3, H=2, D=4,
                                         shapes=((4, 5), (2, 3)))
    leaves = [torch.from_numpy(x).double().requires_grad_()
              for x in (value, loc, aw)]
    assert torch.autograd.gradcheck(
        lambda v, l, a: msda.ms_deform_attn(v, shapes, l, a, impl=impl),
        leaves, eps=1e-6, atol=1e-7, rtol=1e-5)


def test_autograd_op_uses_the_explicit_backward():
    """Under autograd the dispatch goes through the op, whose gradients are
    ms_deform_attn_plain_bwd's (float32 and bfloat16), not autograd's
    through the plain forward; without a gradient it records nothing."""
    for dtype in (torch.float32, torch.bfloat16):
        value, shapes, loc, aw, g = bwd_inputs(41, "default_on_grid")
        tv, ta, tg = (torch.from_numpy(x).to(dtype) for x in (value, aw, g))
        tl = torch.from_numpy(loc)
        leaves = [t.clone().requires_grad_() for t in (tv, tl, ta)]
        out = msda.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
        assert out.grad_fn is not None
        assert "MSDeformAttn" in type(out.grad_fn).__name__
        torch.testing.assert_close(
            out, msda.ms_deform_attn_plain(tv, shapes, tl, ta), rtol=0, atol=0)
        grads = torch.autograd.grad(out, leaves, tg)
        ref = msda.ms_deform_attn_plain_bwd(tv, shapes, tl, ta, tg)
        for a, b in zip(grads, ref):
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert msda.ms_deform_attn(tv, shapes, tl, ta).grad_fn is None
    with torch.no_grad():
        assert msda.ms_deform_attn(leaves[0], shapes, leaves[1],
                                   leaves[2]).grad_fn is None


def test_plain_bwd_kink_rule_differs_from_autograd():
    """Why the backward is explicit: on the integer grid autograd through
    abs/clamp picks other subgradients than the JAX kernels' sign(0) = 0."""
    value = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 16, 1, 2)).astype(np.float32))
    loc = torch.tensor([(1 + 0.5) / 4, (2 + 0.5) / 4]).reshape(1, 1, 1, 1, 1, 2)
    aw = torch.ones((1, 1, 1, 1, 1))
    g = torch.ones((1, 1, 2))
    _, dloc, _ = msda.ms_deform_attn_plain_bwd(value, ((4, 4),), loc, aw, g)
    assert dloc.abs().max() == 0
    leaf = loc.clone().requires_grad_()
    msda.ms_deform_attn_plain(value, ((4, 4),), leaf, aw).backward(g)
    assert leaf.grad.abs().max() > 0


def test_bwd_wrappers_refuse_cpu_tensors_and_bad_grad():
    value, shapes, loc, aw = torch_inputs(3)
    g = torch.zeros((2, 7, 32))
    for fn in (msda_cuda.msda_bwd_rows, msda_cuda.msda_bwd_value,
               msda_cuda.msda_bwd):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(value, shapes, loc, aw, g)
    msda_cuda.check_grad_output(value, loc, g)
    with pytest.raises(ValueError, match="grad_output must be"):
        msda_cuda.check_grad_output(value, loc, g[:, :, :16])
    with pytest.raises(TypeError, match="value dtype"):
        msda_cuda.check_grad_output(value, loc, g.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        msda_cuda.check_grad_output(value, loc,
                                    torch.zeros((2, 32, 7)).transpose(1, 2))


def test_every_source_has_a_library_and_a_counter():
    """Four sources, six kernels: each builds for sm_90a into its own
    hash-keyed library, and each kernel has its own launch count."""
    assert sorted(msda_cuda.sources()) == ["msda_bwd", "msda_fwd",
                                           "msda_fwd_q", "msda_fwd_win"]
    paths = {n: msda_cuda.library_path(n) for n in msda_cuda.sources()}
    assert len(set(paths.values())) == 4
    for name, src in msda_cuda.sources().items():
        assert src.exists() and src.parent.name == "csrc"
        cmd = msda_cuda.build_command("nvcc", paths[name], name)
        assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(src)
        assert paths[name].name.startswith(f"lib{name}-")
    assert {fn: lib for fn, (lib, _) in msda_cuda._FUNCTIONS.items()} == {
        "msda_fwd": "msda_fwd", "msda_bwd_rows": "msda_bwd",
        "msda_bwd_value": "msda_bwd", "msda_fwd_q": "msda_fwd_q",
        "msda_fwd_win": "msda_fwd_win", "msda_fwd_win_pp": "msda_fwd_win"}
    text = msda_cuda.SOURCE_BWD.read_text()
    for fn in ("msda_bwd_rows", "msda_bwd_value"):
        assert f'extern "C" int {fn}(' in text
    for counter in ("launches", "bwd_rows_launches", "bwd_value_launches",
                    "fwd_q_launches", "fwd_win_launches",
                    "fwd_win_pp_launches"):
        assert isinstance(getattr(msda_cuda, counter), int)
