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


def make_inputs(seed, B=2, Q=7, H=4, D=8, shapes=((6, 9), (3, 5), (2, 2)),
                P=4):
    rng = np.random.default_rng(seed)
    L = len(shapes)
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
    before = dict(msda_cuda.launches)
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
    """(h, w, start token, round y, level index) per summed level; y is
    rounded only where stage 1 rounds (a low-precision dtype, or int8) on a
    level the JAX kernel flips; a subset keeps each level's own index."""
    shapes = ((76, 126), (100, 168), (10, 16))
    assert msda_cuda.level_table(shapes, 32, (0, 1, 2), False) == [
        76, 126, 0, 0, 0, 100, 168, 76 * 126, 0, 1,
        10, 16, 76 * 126 + 16800, 0, 2]
    assert msda_cuda.level_table(shapes, 32, (0, 1, 2), True)[8] == 1
    assert msda_cuda.level_table(shapes, 32, (2,), True) == [
        10, 16, 76 * 126 + 16800, 0, 2]


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
    """Eight sources, thirteen kernels (the eleven MSDA kernels, the
    matcher's and the trunk's frozen-BN epilogue): each builds for sm_90a
    into its own hash-keyed library, and each kernel has its own launch
    count in one dict, which one function sets to 0."""
    assert sorted(msda_cuda.sources()) == ["frozen_bn", "lsap", "msda_bwd",
                                           "msda_bwd_win", "msda_fwd",
                                           "msda_fwd_bp", "msda_fwd_q",
                                           "msda_fwd_win"]
    paths = {n: msda_cuda.library_path(n) for n in msda_cuda.sources()}
    assert len(set(paths.values())) == 8
    for name, src in msda_cuda.sources().items():
        assert src.exists() and src.parent.name == "csrc"
        cmd = msda_cuda.build_command("nvcc", paths[name], name)
        assert "arch=compute_90a,code=sm_90a" in cmd and cmd[-1] == str(src)
        assert paths[name].name.startswith(f"lib{name}-")
    assert {fn: lib for fn, (lib, _) in msda_cuda._FUNCTIONS.items()} == {
        "msda_fwd": "msda_fwd", "msda_bwd_rows": "msda_bwd",
        "msda_bwd_value": "msda_bwd", "msda_fwd_q": "msda_fwd_q",
        "msda_fwd_win": "msda_fwd_win", "msda_fwd_win_pp": "msda_fwd_win",
        "msda_bwd_win_rows": "msda_bwd_win",
        "msda_bwd_win_rows_pp": "msda_bwd_win",
        "msda_bwd_win_value": "msda_bwd_win",
        "msda_bwd_win_value_pp": "msda_bwd_win",
        "msda_fwd_bp": "msda_fwd_bp", "lsap": "lsap",
        "frozen_bn": "frozen_bn"}
    text = msda_cuda.SOURCE_BWD.read_text()
    for fn in ("msda_bwd_rows", "msda_bwd_value"):
        assert f'extern "C" int {fn}(' in text
    assert set(msda_cuda.launches) == set(msda_cuda.KERNELS
                                          + msda_cuda.MATCHER_KERNELS
                                          + msda_cuda.BACKBONE_KERNELS)
    assert len(msda_cuda.KERNELS) == 11
    assert msda_cuda.MATCHER_KERNELS == ("lsap",)
    assert msda_cuda.BACKBONE_KERNELS == ("frozen_bn",)
    saved = dict(msda_cuda.launches)
    try:
        msda_cuda.launches["msda_fwd_bp"] += 3
        msda_cuda.launches["lsap"] += 2
        msda_cuda.launches["frozen_bn"] += 1
        msda_cuda.reset_launches()
        assert msda_cuda.launches == dict.fromkeys(
            msda_cuda.KERNELS + msda_cuda.MATCHER_KERNELS
            + msda_cuda.BACKBONE_KERNELS, 0)
    finally:
        msda_cuda.launches.update(saved)


# --------------------------------------------------------------------------
# the batched-P forward (K11, EGTR_MSDA_BATCH_P=1)
# --------------------------------------------------------------------------

# f32: the JAX package holds its batched-P kernel to its p-loop at 1e-6
# (tests/test_msda.py:596-619); the same bound holds here: both sides sum the
# same float32 products, in another order
BP_TOL = dict(atol=1e-6, rtol=1e-6)


def jax_batched_p(value, shapes, loc, aw, dtype=jnp.float32, **kw):
    """The JAX op with ``msda_pallas.FWD_BATCH_P`` on (the Pallas kernel
    _fwd_kernel_bp in interpret mode), traced afresh so that the flag is
    read, and restored after."""
    from egtr_tpu.ops import msda_pallas as mp

    old = mp.FWD_BATCH_P
    try:
        mp.FWD_BATCH_P = True
        out = jax.jit(lambda v, l, a: jax_msda(v, shapes, l, a, impl="pallas",
                                               **kw))(
            jnp.asarray(value, dtype), jnp.asarray(loc),
            jnp.asarray(aw, dtype))
        return np.asarray(out.astype(jnp.float32))
    finally:
        mp.FWD_BATCH_P = old


# three points a level: no power of two, so no even split of a warp's lanes
BP_CASES = {**CASES, "p3": dict(B=2, Q=5, H=2, D=8, P=3,
                                shapes=((6, 9), (3, 5)))}


@pytest.mark.parametrize("case", sorted(BP_CASES))
def test_batched_p_plain_matches_jax_f32(case):
    value, shapes, loc, aw = make_inputs(31, **BP_CASES[case])
    ref = jax_batched_p(value, shapes, loc, aw)
    tv, _, tl, ta = torch_inputs(31, **BP_CASES[case])
    plain = msda.msda_fwd_bp_plain(tv, shapes, tl, ta)
    np.testing.assert_allclose(plain.numpy(), ref, **BP_TOL)
    before = dict(msda_cuda.launches)
    out = msda.ms_deform_attn(tv, shapes, tl, ta, batch_p=True)
    assert msda_cuda.launches == before
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    # the same function as K1's plain version, summed in another order
    np.testing.assert_allclose(
        plain.numpy(), msda.ms_deform_attn_plain(tv, shapes, tl, ta).numpy(),
        **BP_TOL)


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_batched_p_plain_matches_jax_bf16(case):
    value, shapes, loc, aw = make_inputs(32, **BF16_CASES[case])
    v = torch.from_numpy(value).bfloat16()
    a = torch.from_numpy(aw).bfloat16()
    tl = torch.from_numpy(loc)
    ref = jax_batched_p(v.float().numpy(), shapes, loc, a.float().numpy(),
                        jnp.bfloat16)
    out = msda.ms_deform_attn(v, shapes, tl, a, batch_p=True)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, msda.msda_fwd_bp_plain(v, shapes, tl, a),
                               rtol=0, atol=0)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_p_int8_matches_jax(dtype):
    """The int8 form against msda_pallas_q with the batched-P body (the
    quantized branch of _fwd_body_bp): the integer stage is the same, the
    float32 fold differs in summation order."""
    value, shapes, loc, aw = make_inputs(33, **CASES["d32"])
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    v = torch.from_numpy(value).to(td)
    a = torch.from_numpy(aw).to(td)
    tl = torch.from_numpy(loc)
    ref = jax_batched_p(v.float().numpy(), shapes, loc, a.float().numpy(), jd,
                        int8=True)
    out = msda.ms_deform_attn(v, shapes, tl, a, int8=True, batch_p=True)
    assert out.dtype == td
    tol = (dict(atol=ATOL, rtol=RTOL) if dtype == "float32"
           else dict(atol=BF16_ATOL, rtol=BF16_RTOL))
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)
    vq, scale = msda.quantize_levels(v, shapes)
    plain = msda.msda_fwd_bp_plain(vq, shapes, tl, a, scale=scale)
    assert plain.dtype == torch.float32
    torch.testing.assert_close(out, plain.to(td), rtol=0, atol=0)
    np.testing.assert_allclose(
        plain.numpy(), msda.msda_fwd_q_plain(vq, scale, shapes, tl, a).numpy(),
        **BP_TOL)


@pytest.mark.parametrize("int8", [False, True])
def test_batched_p_windowed_call_matches_jax(int8):
    """A windowed call sends its exact level (6, 4) to the batched-P forward,
    and its banded levels (24, 16), (12, 8) to the banded kernels."""
    shapes = ((24, 16), (12, 8), (6, 4))
    rng = np.random.default_rng(34)
    S = sum(h * w for h, w in shapes)
    value = rng.standard_normal((1, S, 2, 8)).astype(np.float32)
    refs = [np.stack([(xx.ravel() + 0.5) / w, (yy.ravel() + 0.5) / h], -1)
            for h, w in shapes
            for yy, xx in [np.meshgrid(np.arange(h), np.arange(w),
                                       indexing="ij")]]
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    off = rng.uniform(-3, 3, (1, S, 2, 3, 4, 2)).astype(np.float32)
    loc = (np.concatenate(refs)[None, :, None, None, None, :]
           + off / wh[None, None, None, :, None, :]).astype(np.float32)
    aw = rng.uniform(0, 1, (1, S, 2, 12)).astype(np.float32)
    aw = (aw / aw.sum(-1, keepdims=True)).reshape(1, S, 2, 3, 4)
    kw = dict(window=8, query_segments=shapes, band="point", int8=int8)
    ref = jax_batched_p(value, shapes, loc, aw, **kw)
    tv, tl, ta = (torch.from_numpy(a) for a in (value, loc, aw))
    out = msda.ms_deform_attn(tv, shapes, tl, ta, batch_p=True, **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    off_flag = msda.ms_deform_attn(tv, shapes, tl, ta, batch_p=False, **kw)
    np.testing.assert_allclose(out.numpy(), off_flag.numpy(), **BP_TOL)


def test_batched_p_default_is_the_module_flag(monkeypatch):
    """batch_p=None reads msda.FWD_BATCH_P at the call; the matmul and
    gather paths ignore it, as the JAX package's XLA paths do."""
    value, shapes, loc, aw = torch_inputs(35)
    bp = msda.msda_fwd_bp_plain(value, shapes, loc, aw)
    k1 = msda.ms_deform_attn_plain(value, shapes, loc, aw)
    assert not torch.equal(bp, k1)  # another order of summation
    monkeypatch.setattr(msda, "FWD_BATCH_P", True)
    assert torch.equal(msda.ms_deform_attn(value, shapes, loc, aw), bp)
    assert torch.equal(msda.ms_deform_attn(value, shapes, loc, aw,
                                           batch_p=False), k1)
    matmul = msda.ms_deform_attn(value, shapes, loc, aw, impl="matmul")
    assert torch.equal(matmul, msda.ms_deform_attn(
        value, shapes, loc, aw, impl="matmul", batch_p=False))
    monkeypatch.setattr(msda, "FWD_BATCH_P", False)
    assert torch.equal(msda.ms_deform_attn(value, shapes, loc, aw), k1)


def test_batched_p_gradient_is_the_exact_ops():
    """The backward never reads the flag (K2 + K3, or their plain
    version): the gradients with and without batch_p are the same."""
    value, shapes, loc, aw = torch_inputs(36)
    g = torch.randn((value.shape[0], loc.shape[1],
                     value.shape[2] * value.shape[3]),
                    generator=torch.Generator().manual_seed(0))
    grads = []
    for batch_p in (False, True):
        leaves = [t.clone().requires_grad_() for t in (value, loc, aw)]
        out = msda.ms_deform_attn(*leaves[:1], shapes, *leaves[1:],
                                  batch_p=batch_p)
        grads.append(torch.autograd.grad(out, leaves, g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_environment_variable_sets_the_flag():
    """EGTR_MSDA_BATCH_P=1 at import turns the flag on, as in
    msda_pallas.py:85; it is off by default."""
    import os
    import subprocess
    import sys

    code = "from egtr_tpu_torch.ops import msda; print(msda.FWD_BATCH_P)"
    env = {k: v for k, v in os.environ.items() if k != "EGTR_MSDA_BATCH_P"}
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    outs = []
    for extra in ({}, {"EGTR_MSDA_BATCH_P": "1"}, {"EGTR_MSDA_BATCH_P": "0"}):
        run = subprocess.run([sys.executable, "-c", code], cwd=root,
                             env={**env, **extra}, capture_output=True,
                             text=True, timeout=120, check=True)
        outs.append(run.stdout.strip())
    assert outs == ["False", "True", "False"]


def test_batched_p_wrapper_refuses():
    """No fallback for a CPU tensor, and the float32 form's own limits (its
    kernel's lane split): P divides the warp's 32 lanes, D is a multiple of
    4; the int8 form needs its scale."""
    value, shapes, loc, aw = torch_inputs(3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        msda_cuda.msda_fwd_bp(value, shapes, loc, aw)
    with pytest.raises(ValueError, match="P must divide 32"):
        msda_cuda.check_inputs_bp(value, shapes, torch.cat([loc, loc[..., :1, :]],
                                                           dim=4).contiguous(),
                                  torch.cat([aw, aw[..., :1]], 4).contiguous(),
                                  None)
    v6, _, l6, a6 = torch_inputs(3, D=6)
    with pytest.raises(ValueError, match="multiple of 4"):
        msda_cuda.check_inputs_bp(v6, shapes, l6, a6, None)
    vq, scale = msda.quantize_levels(value, shapes)
    with pytest.raises(ValueError, match="need their scale"):
        msda_cuda.check_inputs_bp(vq, shapes, loc, aw, None)
    with pytest.raises(ValueError, match="int8 values only"):
        msda_cuda.check_inputs_bp(value, shapes, loc, aw, scale)
    msda_cuda.check_inputs_bp(value, shapes, loc, aw, None)
    msda_cuda.check_inputs_bp(vq, shapes, loc, aw, scale)


def _unaligned(t):
    """``t``'s values in a tensor whose storage starts one element past an
    allocation."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("P,D", [(4, 8), (3, 8), (4, 6), (5, 12)])
def test_batched_p_forms_route_to_their_kernels(P, D):
    """Each form of K11 names the kernel that serves it, and refuses only
    what that kernel refuses: bfloat16 runs K1's and int8 K4's (any P and
    D, any alignment, where K1 and K4 take them), float32 K11's own (P
    dividing 32, D a multiple of 4, 16-byte aligned values); int8 without
    its scale, or a scale beside float values, is refused in every form."""
    assert msda_cuda.BP_ROUTES == {torch.bfloat16: "msda_fwd",
                                   torch.int8: "msda_fwd_q",
                                   torch.float32: "msda_fwd_bp"}
    value, shapes, loc, aw = torch_inputs(37, P=P, D=D)
    bf16 = (value.bfloat16(), aw.bfloat16())
    vq, scale = msda.quantize_levels(value, shapes)
    for v, a in (bf16, (_unaligned(bf16[0]), bf16[1])):
        assert msda_cuda.check_inputs_bp(v, shapes, loc, a, None) == "msda_fwd"
        msda_cuda.check_inputs(v, shapes, loc, a)
    for q in (vq, _unaligned(vq)):
        assert msda_cuda.check_inputs_bp(q, shapes, loc, aw,
                                         scale) == "msda_fwd_q"
        msda_cuda.check_inputs_q(q, scale, shapes, loc, aw)
        with pytest.raises(ValueError, match="need their scale"):
            msda_cuda.check_inputs_bp(q, shapes, loc, aw, None)
    with pytest.raises(ValueError, match="int8 values only"):
        msda_cuda.check_inputs_bp(*bf16[:1], shapes, loc, bf16[1], scale)
    own = 32 % P == 0 and D % 4 == 0
    if own:
        assert msda_cuda.check_inputs_bp(value, shapes, loc, aw,
                                         None) == "msda_fwd_bp"
        with pytest.raises(ValueError, match="aligned to four channels"):
            msda_cuda.check_inputs_bp(_unaligned(value), shapes, loc, aw,
                                      None)
    else:
        with pytest.raises(ValueError, match="float32 kernel"):
            msda_cuda.check_inputs_bp(value, shapes, loc, aw, None)
    # what each route launches: a C function of the library of that source
    for route in msda_cuda.BP_ROUTES.values():
        lib, _ = msda_cuda._FUNCTIONS[route]
        assert msda_cuda.source_of(route) == msda_cuda.sources()[lib]
    assert msda_cuda.source_of("msda_fwd") == msda_cuda.SOURCE
    assert msda_cuda.source_of("msda_fwd_q") == msda_cuda.SOURCE_Q
    assert msda_cuda.source_of("msda_fwd_bp") == msda_cuda.SOURCE_BP
