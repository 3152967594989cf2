"""The trunk's frozen-BN epilogue (``backbone.frozen_bn_act``) on the CPU.

- Routing: the CPU, and grad mode on wherever the map lies, take PyTorch's
  expression, bit for bit the trunk written out module by module
  (``expression_forward``: the outputs and, under grad, every
  FrozenBatchNorm leaf's gradient); with grad mode off a map on the card
  (faked here: every map counts as the card's) goes to
  ``msda_cuda.frozen_bn`` once a site, written into the convolution's
  output, 49 sites in ResNet-50, and a map in another layout than
  channels_last is refused there, not sent back to the expression.
- The wrapper's refusals that need no card.
- A numpy emulation of the kernel's vector and channel map
  (``msda_cuda.frozen_bn_geometry``): every element taken once, each
  vector's channels reading their own parameters, at every site of the
  trunks and on maps whose last block is partly empty.

The kernel's arithmetic is held to the expression on the card
(tests/test_torch_cuda.py).
"""

import copy
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from egtr_tpu_torch.models import backbone
from egtr_tpu_torch.models.epilogue_sites import (random_norm,
                                                  sites_per_forward,
                                                  trunk_sites)
from egtr_tpu_torch.models.layers import init_params
from egtr_tpu_torch.ops import msda_cuda

torch.set_num_threads(1)

# blocks and dilation
TRUNKS = {"resnet50": ((3, 4, 6, 3), False),
          "resnet101": ((3, 4, 23, 3), False),
          "resnet50_dilated": ((3, 4, 6, 3), True)}
PIXELS = (2, 48, 72, 3)


def expression_forward(model, pixel_values):
    """The trunk written out module by module in PyTorch's expression: each
    norm, then the residual, then the ReLU, as separate calls."""
    def bottleneck(m, x):
        out = F.relu(m.bn1(m.conv1(x)))
        out = F.relu(m.bn2(m.conv2(out)))
        out = m.bn3(m.conv3(out))
        identity = x
        if m.has_downsample:
            identity = m.downsample_bn(m.downsample_conv(x))
        return F.relu(out + identity)

    x = pixel_values.to(model.dtype).permute(0, 3, 1, 2)
    x = F.relu(model.bn1(model.conv1(x)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    outs = []
    for stage, n_blocks in enumerate(model.blocks):
        for b in range(n_blocks):
            x = bottleneck(getattr(model, f"layer{stage + 1}_{b}"), x)
        if stage + 1 in model.out_stages:
            outs.append(x)
    return tuple(outs)


def _model(trunk, dtype=torch.bfloat16, seed=0):
    """A trunk with seeded weights and norm statistics away from the
    init's, so that every parameter of a norm moves the output."""
    blocks, dilation = TRUNKS[trunk]
    model = backbone.ResNet50(blocks, dtype=dtype, dilation=dilation)
    init_params(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, backbone.FrozenBatchNorm):
            stats = random_norm(m.weight.shape[0], g, "cpu")
            m.load_state_dict(stats.state_dict())
    return model


def _pixels(seed=2):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        PIXELS).astype(np.float32))


def _refuse(*args, **kwargs):
    raise AssertionError("the kernel was called")


def _assert_bits_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_the_cpu_takes_the_expression(trunk, mode, monkeypatch):
    monkeypatch.setattr(msda_cuda, "frozen_bn", _refuse)
    model = _model(trunk)
    x = _pixels()
    with getattr(torch, mode)():
        _assert_bits_equal(model(x), expression_forward(model, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_grad_on_takes_the_expression_and_its_gradients(trunk, dtype,
                                                           monkeypatch):
    """Under grad mode even a map that the kernel takes goes through the
    expression: the outputs and every FrozenBatchNorm leaf's gradient (and
    every other parameter's) equal the written-out trunk's bit for bit."""
    monkeypatch.setattr(backbone, "_takes_kernel", lambda x: True)
    monkeypatch.setattr(msda_cuda, "frozen_bn", _refuse)
    model = _model(trunk, dtype)
    ref_model = copy.deepcopy(model)
    x = _pixels()
    outs, ref = model(x), expression_forward(ref_model, x)
    _assert_bits_equal(outs, ref)
    g = torch.Generator().manual_seed(3)
    weights = [torch.randn(o.shape, generator=g) for o in outs]
    for outputs in (outs, ref):
        sum((o * w).sum() for o, w in zip(outputs, weights)).backward()
    norms = 0
    for (name, p), (_, q) in zip(model.named_parameters(),
                                 ref_model.named_parameters()):
        assert p.grad is not None and torch.equal(p.grad, q.grad), name
        norms += name.rsplit(".", 1)[-1] in ("running_mean", "running_var")
    assert norms == 2 * (1 + 3 * sum(model.blocks) + 4)


def _fake_kernel(calls):
    """``msda_cuda.frozen_bn`` as the card would take these CPU maps: its
    checks, then the expression's result written into ``out``."""
    def kernel(x, params, residual=None, residual_params=None, out=None):
        msda_cuda.check_inputs_frozen_bn(x, params, residual,
                                         residual_params, out)
        assert out is x
        assert not torch.is_grad_enabled()
        bn = backbone.FrozenBatchNorm(x.shape[1])
        bn.weight, bn.bias, bn.running_mean, bn.running_var = params
        rbn = None
        if residual_params is not None:
            rbn = backbone.FrozenBatchNorm(x.shape[1])
            (rbn.weight, rbn.bias, rbn.running_mean,
             rbn.running_var) = residual_params
        out.copy_(backbone.frozen_bn_act_plain(x, bn, residual, rbn))
        calls.append(("relu" if residual is None else "identity"
                      if residual_params is None else "downsample",
                      x.dtype))
        msda_cuda.launches["frozen_bn"] += 1
        return out
    return kernel


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode",
                                  "enable_grad"])
@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_a_card_map_takes_the_kernel_once_a_site(trunk, mode, monkeypatch):
    calls = []
    monkeypatch.setattr(backbone, "_takes_kernel", lambda x: True)
    monkeypatch.setattr(msda_cuda, "frozen_bn", _fake_kernel(calls))
    model = _model(trunk)
    x = _pixels()
    msda_cuda.reset_launches()
    with getattr(torch, mode)():
        outs = model(x)
    with torch.no_grad():
        _assert_bits_equal(outs, expression_forward(model, x))
    if mode == "enable_grad":
        assert calls == [] and msda_cuda.launches["frozen_bn"] == 0
        return
    blocks = sum(TRUNKS[trunk][0])
    assert msda_cuda.launches["frozen_bn"] == len(calls) == 1 + 3 * blocks
    assert calls[0] == ("relu", torch.bfloat16)
    assert {dtype for _, dtype in calls[1:]} == {torch.float32}
    assert Counter(form for form, _ in calls) == {
        "relu": 1 + 2 * blocks, "identity": blocks - 4, "downsample": 4}


def test_the_route_reads_the_device_alone(monkeypatch):
    """A CUDA map goes to the kernel whatever its layout, and the kernel
    refuses one that is not channels_last: no silent way back to the
    expression. The CPU and the meta device never take the kernel."""
    for device in ("cpu", "meta"):
        assert not backbone._takes_kernel(torch.empty(1, device=device))
    calls = []
    monkeypatch.setattr(backbone, "_takes_kernel", lambda x: True)
    monkeypatch.setattr(msda_cuda, "frozen_bn", _fake_kernel(calls))
    bn = backbone.FrozenBatchNorm(8)
    with torch.no_grad():
        with pytest.raises(ValueError, match="channels_last"):
            backbone.frozen_bn_act(torch.zeros((1, 8, 3, 5)), bn)
        backbone.frozen_bn_act(_cl((1, 8, 3, 5)), bn)
    assert calls == [("relu", torch.float32)]


def test_the_trunk_sites():
    """49 sites in ResNet-50 at either bucket, 100 in ResNet-101: the
    bfloat16 stem (C 64), float32 blocks, C % 4 == 0 everywhere; the
    forms in the order the forward runs them."""
    for hw, batch in ((608, 1008), 1), ((800, 1344), 8):
        sites = trunk_sites(hw, batch)
        assert len(sites) == 49
        assert sites[0] == ((batch, 64, -(-hw[0] // 2), -(-hw[1] // 2)),
                            torch.bfloat16, "relu")
        assert all(d == torch.float32 and s[1] % 4 == 0
                   for s, d, _ in sites[1:])
        assert [f for _, _, f in sites[1:4]] == ["relu", "relu",
                                                 "downsample"]
        assert [f for _, _, f in sites[4:7]] == ["relu", "relu", "identity"]
    assert len(trunk_sites((608, 1008), 1, (3, 4, 23, 3))) == 100
    assert sites_per_forward((3, 4, 6, 3)) == 49
    assert sites_per_forward((3, 4, 23, 3)) == 100


def _cl(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).contiguous(
        memory_format=torch.channels_last)


def _vectors(C):
    return tuple(torch.ones(C) for _ in range(4))


def test_refusals_without_a_card():
    x = _cl((1, 8, 3, 5))
    p = _vectors(8)
    check = msda_cuda.check_inputs_frozen_bn
    assert check(x, p, None, None, None).vec == 4
    with pytest.raises(ValueError, match="channels_last"):
        check(torch.zeros((1, 8, 3, 5)), p, None, None, None)
    with pytest.raises(ValueError, match="C % 4"):
        check(_cl((1, 6, 3, 5)), _vectors(6), None, None, None)
    with pytest.raises(ValueError, match="C % 8"):
        check(_cl((1, 20, 3, 5), torch.bfloat16), _vectors(20), None, None,
              None)
    with pytest.raises(TypeError, match="dtype"):
        check(x, p, _cl((1, 8, 3, 5), torch.bfloat16), None, None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        check(x.half(), p, None, None, None)
    with pytest.raises(TypeError, match="float32"):
        check(x, tuple(t.bfloat16() for t in p), None, None, None)
    with pytest.raises(ValueError, match=r"\[8\]"):
        check(x, _vectors(4), None, None, None)
    with pytest.raises(ValueError, match="four|weight"):
        check(x, p[:3], None, None, None)
    with pytest.raises(ValueError, match="without a residual"):
        check(x, p, None, p, None)
    with pytest.raises(ValueError, match="shape|must be"):
        check(x, p, _cl((1, 8, 3, 6)), None, None)
    r = _cl((1, 8, 3, 5))
    with pytest.raises(ValueError, match="not be the residual"):
        check(x, p, r, None, r)
    # channels_last, one element off the allocation's alignment
    off = torch.zeros(1 + 8 * 3 * 5)[1:].view(1, 3, 5, 8).permute(0, 3, 1, 2)
    with pytest.raises(ValueError, match="aligned"):
        check(off, p, None, None, None)
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.frozen_bn(x, p)


def _emulate(shape, element_size):
    """Run the kernel's index map over a map of [N, C, H, W] ``shape`` as
    numpy: (vector, its first channel) per (block, unroll step, thread),
    -1 where the kernel's bound check leaves the slot empty."""
    N, C, H, W = shape
    numel = N * C * H * W
    geom = msda_cuda.frozen_bn_geometry(numel, C, element_size)
    n_vec = numel // geom.vec
    b = np.arange(geom.blocks)[:, None, None]
    k = np.arange(geom.unroll)[None, :, None]
    t = np.arange(geom.threads)[None, None, :]
    v = (b * geom.unroll + k) * geom.threads + t
    v = np.where(v < n_vec, v, -1).ravel()
    taken = v[v >= 0]
    return geom, n_vec, taken, (taken % (C // geom.vec)) * geom.vec


def _assert_map(shape, element_size):
    N, C, H, W = shape
    geom, n_vec, v, c0 = _emulate(shape, element_size)
    assert geom.vec * element_size <= msda_cuda.FBN_VEC_BYTES
    assert n_vec * geom.vec == N * C * H * W
    # every vector once, so every element once
    assert np.array_equal(np.bincount(v, minlength=n_vec),
                          np.ones(n_vec, np.int64))
    # the channels lane j of a vector reads are its elements' own: element
    # e of an [N, H, W, C] layout is channel e % C
    for j in range(geom.vec):
        assert np.array_equal(c0 + j, (v * geom.vec + j) % C)
    # the last block holds work, and no block past it is launched
    assert (geom.blocks - 1) * geom.unroll * geom.threads < n_vec
    return geom, n_vec


BUCKETS = {"608x1008_b1": ((608, 1008), 1), "800x1344_b1": ((800, 1344), 1)}


@pytest.mark.parametrize("trunk", sorted(TRUNKS))
@pytest.mark.parametrize("bucket", sorted(BUCKETS))
def test_vector_and_channel_map_at_every_site(bucket, trunk):
    blocks, dilation = TRUNKS[trunk]
    sites = trunk_sites(*BUCKETS[bucket], blocks, dilation)
    for shape in sorted({s for s, _, _ in sites}):
        dtypes = {d for s, d, _ in sites if s == shape}
        for dtype in dtypes:
            size = torch.empty((), dtype=dtype).element_size()
            geom, _ = _assert_map(shape, size)
            assert geom.vec == 16 // size


def test_the_offline_batch_takes_the_same_map_per_block():
    """At batch 8 (800x1344) the blocks tile the vectors: one block's slots
    are a permutation of its range, the last block is the only partial
    one."""
    for shape, dtype, _ in trunk_sites((800, 1344), 8):
        size = torch.empty((), dtype=dtype).element_size()
        numel = int(np.prod(shape))
        geom = msda_cuda.frozen_bn_geometry(numel, shape[1], size)
        per_block = geom.unroll * geom.threads
        n_vec = numel // geom.vec
        assert (geom.blocks - 1) * per_block < n_vec <= geom.blocks * per_block
        _, _, v, _ = _emulate((1, geom.vec, 1, per_block), size)
        assert np.array_equal(np.sort(v), np.arange(per_block))


@pytest.mark.parametrize("shape,dtype,vec", [
    ((1, 12, 5, 7), torch.float32, 4),      # 105 vectors: one partial block
    ((3, 40, 9, 11), torch.bfloat16, 8),    # 1,485 vectors
    ((2, 24, 33, 17), torch.bfloat16, 8),
    ((1, 2048, 19, 31), torch.float32, 4),  # a tail of 616 vectors
    ((1, 4, 1, 1), torch.float32, 4),       # one vector
])
def test_vector_and_channel_map_with_a_tail(shape, dtype, vec):
    geom, n_vec = _assert_map(shape, torch.empty((), dtype=dtype)
                              .element_size())
    assert geom.vec == vec
    assert n_vec % (geom.unroll * geom.threads) or n_vec == (
        geom.unroll * geom.threads)
