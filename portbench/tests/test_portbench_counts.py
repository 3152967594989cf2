"""The frozen work counts: the FLOP counter and the MSDA bound against
hand-worked numbers at small shapes, and the counter's convolutions and
linear layers against the calls the plain reference makes."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from portbench import flops
from portbench.reference.model import Reference
from portbench.tests.tiny import TINY_MODEL, tiny_spec
from portbench.weights import make_state


def test_conv_out_and_levels():
    assert flops.conv_out(32, 7, 2, 3) == 16
    assert flops.conv_out(15, 3, 2, 1) == 8
    assert flops.level_shapes((600, 1000), 4) == [(75, 125), (38, 63),
                                                   (19, 32), (10, 16)]


def test_trunk_hand_worked_stem_and_first_block():
    # 32x32: stem 7x7/2 -> 16x16, max-pool -> 8x8, then layer1_0 at 8x8:
    # 1x1 64->64, 3x3 64->64, 1x1 64->256, downsample 1x1 64->256
    stem = 2 * 3 * 64 * 49 * 16 * 16
    block = 2 * 64 * 8 * 8 * (64 + 64 * 9 + 256 + 256)
    assert flops.trunk_flops((32, 32), blocks=(1, 0, 0, 0)) == stem + block


def test_msda_bound_hand_worked():
    m = {"encoder_attention_heads": 8, "num_feature_levels": 1,
         "encoder_n_points": 4, "d_model": 256, "encoder_layers": 1,
         "decoder_layers": 0, "num_queries": 0}
    # one level of 8x8 (padded image 64x64 at stride 8): S = Q = 64
    samples = 64 * 8 * 4
    value = 64 * 8 * 32 * 2
    loc, aw, out = samples * 8, samples * 2, 64 * 256 * 2
    fwd_bytes = (value + loc + aw + out) / 3.35e12 * 1e3
    fwd_ops = samples * 32 * 10 / 67e12 * 1e3
    got = flops.msda_bounds(m, (64, 64), 1)
    assert got["fwd"] == pytest.approx(max(fwd_bytes, fwd_ops))
    rows = (value + loc + aw + out + loc + aw) / 3.35e12 * 1e3
    assert got["rows"] == pytest.approx(max(rows, samples * 32 * 28
                                            / 67e12 * 1e3))


def _counted(cell, hw):
    """FLOPs of the reference's convolutions and linear layers in one
    forward at ``hw``, counted from the calls it makes."""
    spec = tiny_spec(cell)
    m = spec.config["model"]
    from egtr_tpu_torch.models.egtr import EgtrModel
    from egtr_tpu_torch.config import EgtrConfig

    model = EgtrModel(EgtrConfig(**m))
    state = make_state(list(model.named_parameters()), 0, "cpu", 8, 4, 4,
                       "fan_in")
    ref = Reference(state, m)
    counts = {"conv": 0, "linear": 0}
    conv, linear = F.conv2d, F.linear

    def c2d(x, w, b=None, stride=1, padding=0, *a, **k):
        y = conv(x, w, b, stride, padding, *a, **k)
        counts["conv"] += 2 * w[0].numel() * y.numel()
        return y

    def lin(x, w, b=None):
        y = linear(x, w, b)
        counts["linear"] += 2 * w.shape[1] * y.numel()
        return y

    x = torch.randn(1, *hw, 3)
    mask = torch.ones(1, *hw, dtype=torch.bool)
    try:
        F.conv2d, F.linear = c2d, lin
        ref.forward(x, mask)
    finally:
        F.conv2d, F.linear = conv, linear
    return m, counts


def test_counter_matches_the_calls():
    hw = (64, 96)
    m, counts = _counted("vg-serve-b1", hw)
    parts = flops.forward_flops(m, hw)
    assert counts["conv"] == parts["trunk"] + parts["input_proj"]
    # the linear layers: the encoder's and decoder's (less the attention
    # products and MSDA's sampling), the heads, and the relation head's
    # projections and its pair MLPs' later layers (the reference forms the
    # first pair layer as a product over Q x Q x 2E, the counter as the
    # factorised sums)
    E, Q, Lr = m["d_model"], m["num_queries"], m["decoder_layers"] + 1
    R = m["num_rel_labels"]
    attn = m["decoder_layers"] * 2 * 2 * Q * Q * E
    pair_first = 2 * (2 * Q * Lr * E * E * 2 + 2 * Q * Q * Lr * E * 2)
    gate = 2 * Q * Lr * E * 2
    linear = (parts["encoder"] + parts["decoder"] - attn + parts["heads"]
              + parts["relation_head"] - pair_first - gate)
    assert counts["linear"] == linear
    assert TINY_MODEL["d_model"] == E


def test_step_flops_train_is_three_forwards():
    m = tiny_spec("vg-train-b4a2").config["model"]
    one = flops.step_flops(m, (96, 160), 1, False)
    assert flops.step_flops(m, (96, 160), 4, True) == 12 * one
