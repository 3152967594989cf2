"""The benchmark's frozen work counts: model FLOPs from a configuration's
shapes, and the least time of each MSDA kernel call.

Model FLOPs count 2 per multiply-add of the published model's matrix work:
the ResNet trunk's convolutions, the input projections, every encoder and
decoder linear layer, the decoder's attention products, MSDA's sampling (10
operations per sample and channel: four bilinear corners and the attention
weight, a multiply-add each), the class and box heads of every decoder
layer, and the relation head in the factorised form of the JAX package
(the gate is rank one over pairs, so the first layer of both pair MLPs is
two projections and two gated sums, not a product over Q x Q x 2E).
Normalisation, activations, softmax, masks, the postprocess and the
optimizer are not counted. A training step counts three times the forward:
the backward computes the gradient of every leaf, the frozen ones too,
whose norm the clip takes. The count does not change with how the program
computes the work.

The MSDA bound is ``chip_smoke.py:bound`` frozen: each input read once and
each output written once over the HBM rate, against the operations over
the float32 rate (the kernels do their arithmetic outside the tensor
cores), whichever is longer.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

# H100 SXM (NVIDIA data sheet, dense): bf16 tensor-core peak for the MFU,
# HBM rate and float32 rate for the MSDA bound
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# operations per sampled (query, head, level, point) and channel: forward,
# backward rows (K2), backward value (K3), as chip_smoke.py counts them
FLOPS_FWD, FLOPS_ROWS, FLOPS_VALUE = 10, 28, 10

STAGE_WIDTHS = (64, 128, 256, 512)
STAGE_CHANNELS = (512, 1024, 2048)


def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - (k - 1) - 1) // s + 1


def conv_flops(cin: int, cout: int, k: int, ho: int, wo: int) -> int:
    return 2 * cin * cout * k * k * ho * wo


def level_shapes(hw: Tuple[int, int], levels: int) -> List[Tuple[int, int]]:
    """(h, w) of each feature level for a padded image (strides 8, 16, 32,
    then stride-2 convolutions)."""
    H, W = hw
    shapes = [(math.ceil(H / s), math.ceil(W / s)) for s in (8, 16, 32)]
    while len(shapes) < levels:
        h, w = shapes[-1]
        shapes.append((math.ceil(h / 2), math.ceil(w / 2)))
    return shapes[:levels]


def trunk_flops(hw: Tuple[int, int], blocks=(3, 4, 6, 3)) -> int:
    """The ResNet v1.5 trunk of one image."""
    h, w = conv_out(hw[0], 7, 2, 3), conv_out(hw[1], 7, 2, 3)
    total = conv_flops(3, 64, 7, h, w)
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    cin = 64
    for stage, (n, width) in enumerate(zip(blocks, STAGE_WIDTHS)):
        for b in range(n):
            s = 2 if (b == 0 and stage > 0) else 1
            ho, wo = conv_out(h, 3, s, 1), conv_out(w, 3, s, 1)
            total += conv_flops(cin, width, 1, h, w)
            total += conv_flops(width, width, 3, ho, wo)
            total += conv_flops(width, 4 * width, 1, ho, wo)
            if b == 0:
                total += conv_flops(cin, 4 * width, 1, ho, wo)
            cin, h, w = 4 * width, ho, wo
    return total


def forward_flops(m: Dict, hw: Tuple[int, int]) -> Dict[str, int]:
    """FLOPs of one image's forward by part, for the model fields ``m`` of
    a configuration file and the padded image ``hw``."""
    E, Fe, Fd = m["d_model"], m["encoder_ffn_dim"], m["decoder_ffn_dim"]
    H, L = m["encoder_attention_heads"], m["num_feature_levels"]
    Pe, Pd = m["encoder_n_points"], m["decoder_n_points"]
    Q, C, R = m["num_queries"], m["num_labels"], m["num_rel_labels"]
    Le, Ld = m["encoder_layers"], m["decoder_layers"]
    D = E // H
    shapes = level_shapes(hw, L)
    S = sum(h * w for h, w in shapes)
    parts = {"trunk": trunk_flops(hw)}
    proj = 0
    for lvl, (h, w) in enumerate(shapes):
        if lvl < 3:
            proj += conv_flops(STAGE_CHANNELS[lvl], E, 1, h, w)
        else:
            cin = STAGE_CHANNELS[-1] if lvl == 3 else E
            proj += conv_flops(cin, E, 3, h, w)
    parts["input_proj"] = proj
    enc_linear = 2 * S * E * (E + H * L * Pe * 2 + H * L * Pe + E + 2 * Fe)
    parts["encoder"] = Le * enc_linear
    parts["msda"] = (Le * S + Ld * Q) * H * L * Pe * D * FLOPS_FWD
    dec = (2 * Q * E * 4 * E + 2 * 2 * Q * Q * E       # self-attention
           + 2 * S * E * E                             # cross value_proj
           + 2 * Q * E * (H * L * Pd * 2 + H * L * Pd + E)
           + 2 * Q * E * 2 * Fd)
    parts["decoder"] = Ld * dec
    parts["heads"] = Ld * 2 * Q * (E * C + 2 * E * E + 4 * E) + 2 * Q * E * 2
    Lr = Ld + 1
    rel = (2 * Q * E * E * 2 * Lr                      # proj_q, proj_k, finals
           + 2 * Q * Lr * E * 2)                       # the gate's halves
    for out in (R, 1):                                 # relation, connectivity
        rel += (2 * Q * Lr * E * E * 2                 # W1 on q and on k
                + 2 * Q * Q * Lr * E * 2               # the gated sums
                + 2 * Q * Q * E * E + 2 * Q * Q * E * out)
    parts["relation_head"] = rel
    return parts


def step_flops(m: Dict, hw: Tuple[int, int], images: int,
               train: bool) -> float:
    """Model FLOPs of ``images`` images: their forward, three times it in
    training."""
    total = sum(forward_flops(m, hw).values()) * images
    return float(total * (3 if train else 1))


def bound_ms(nbytes: int, samples: int, channels: int,
             flops_per_sample_channel: int) -> float:
    """``chip_smoke.py:bound``: the least time of a call in ms."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = samples * channels * flops_per_sample_channel / FP32_FLOPS * 1e3
    return max(byte_ms, op_ms)


def msda_calls(m: Dict, hw: Tuple[int, int]) -> List[Tuple[int, int]]:
    """(Q, S) of every MSDA call of one forward."""
    shapes = level_shapes(hw, m["num_feature_levels"])
    S = sum(h * w for h, w in shapes)
    return ([(S, S)] * m["encoder_layers"]
            + [(m["num_queries"], S)] * m["decoder_layers"])


def msda_bounds(m: Dict, hw: Tuple[int, int], batch: int,
                value_bytes: int = 2) -> Dict[str, float]:
    """Least ms of one forward's MSDA calls, and of their two backward
    kernels, summed by kernel: "fwd" (K1), "rows" (K2), "value" (K3).
    Value, weights, output and its gradient in the compute type
    (``value_bytes``), locations and their gradient float32."""
    H = m["encoder_attention_heads"]
    L, P = m["num_feature_levels"], m["encoder_n_points"]
    D = m["d_model"] // H
    out = {"fwd": 0.0, "rows": 0.0, "value": 0.0}
    for Q, S in msda_calls(m, hw):
        samples = batch * Q * H * L * P
        value = batch * S * H * D * value_bytes
        loc = samples * 2 * 4
        aw = samples * value_bytes
        o = batch * Q * H * D * value_bytes
        out["fwd"] += bound_ms(value + loc + aw + o, samples, D, FLOPS_FWD)
        out["rows"] += bound_ms(value + loc + aw + o + loc + aw, samples, D,
                                FLOPS_ROWS)
        out["value"] += bound_ms(loc + aw + o + value, samples, D,
                                 FLOPS_VALUE)
    return out
