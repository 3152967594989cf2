"""Seeded random weights made on the device in a few large calls.

Every parameter of the model is filled from one draw of standard normals on
the device's generator: each leaf takes a view of the draw, scaled and
shifted by a rule on its name and shape (one ``_foreach_mul_`` and one
``_foreach_add_`` over all leaves), and the MSDA sampling offsets' biases
take the directional grid of the published initialisation. The values are
float32, the type the model holds its parameters in. The same state goes to
the program and to the reference.

Two schemes, named by a traffic mix's ``weights``:

- ``fan_in`` (the serving cells): every weight matrix and convolution at
  variance 1/fan-in (flax's and PyTorch's default scale, which keeps a unit
  signal through each layer), so that a random model's answers depend on
  its input image, as a trained model's do, and an answer computed on
  another image fails the output check. The published initialisation
  zeroes the box head's last layer and the sampling offsets' weights, which
  would make every box and sampling point independent of the image; here
  they are drawn like the rest.
- ``published`` (the training cells): Deformable DETR's initialisation,
  dense layers at 0.02 and the reference-point layer Xavier, with the box
  head's last layer and the sampling offsets' weights drawn at 0.02 too
  and the class head's at 0.1, so that queries differ in their scores.

In both: normalisation weights one, biases zero, convolutions at variance
1/fan-in, the query embeddings 1.0 (an ``nn.Embedding``), the class head's
bias the focal prior, the frozen frequency-bias table drawn as
log-frequencies around -3. The configuration files list these under
``assumed``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

CLASS_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
CLASS_WEIGHT_STD = 0.1
DENSE_STD = 0.02
TRIPLET_STD, TRIPLET_MEAN = 1.0, -3.0


def leaf_rule(name: str, shape: Tuple[int, ...], scheme: str
              ) -> Tuple[float, float]:
    """(scale, shift) of the standard normal that fills one leaf."""
    last = name.rsplit(".", 1)[-1]
    if last == "running_var":
        return 0.0, 1.0
    if last == "running_mean":
        return 0.0, 0.0
    if "triplet_dist" in name:
        return TRIPLET_STD, TRIPLET_MEAN
    if "rel_dist" in name:
        return 0.0, 1.0 / shape[0]
    module = name.split(".")[-2] if "." in name else ""
    if "norm" in name or "bn" in module:
        return (0.0, 1.0) if last == "weight" else (0.0, 0.0)
    if "class_embed" in name and last == "bias":
        return 0.0, CLASS_PRIOR_BIAS
    if last == "bias" or name.endswith("_bias"):
        return 0.0, 0.0
    if len(shape) == 4:
        return math.sqrt(1.0 / (shape[1] * shape[2] * shape[3])), 0.0
    if "query_position_embeddings" in name or "level_embed" in name:
        return 1.0, 0.0
    if scheme == "fan_in":
        # the relation head's raw matrices are [in, out], the rest [out, in]
        fan_in = shape[0] if name.endswith("_kernel") else shape[1]
        return math.sqrt(1.0 / fan_in), 0.0
    if scheme != "published":
        raise ValueError(f"unknown weights scheme {scheme!r}")
    if "class_embed" in name:
        return CLASS_WEIGHT_STD, 0.0
    if "reference_points" in name:
        return math.sqrt(2.0 / (shape[0] + shape[1])), 0.0
    return DENSE_STD, 0.0


def offset_grid(num_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """The sampling offsets' directional bias (Deformable DETR's init)."""
    thetas = np.arange(num_heads, dtype=np.float64) * (2.0 * math.pi
                                                       / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(num_heads, 1, 1, 2), (1, n_levels, n_points, 1))
    grid = grid * np.arange(1, n_points + 1).reshape(1, 1, n_points, 1)
    return grid.reshape(-1).astype(np.float32)


def make_state(named: List[Tuple[str, torch.Tensor]], seed: int, device,
               heads: int, levels: int, points: int, scheme: str
               ) -> Dict[str, torch.Tensor]:
    """The seeded float32 state of every named leaf, on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(p.numel() for _, p in named)
    flat = torch.randn(total, generator=g, device=device)
    views, at = [], 0
    for _, p in named:
        views.append(flat[at:at + p.numel()].view(p.shape))
        at += p.numel()
    rules = [leaf_rule(n, tuple(p.shape), scheme) for n, p in named]
    torch._foreach_mul_(views, [s for s, _ in rules])
    torch._foreach_add_(views, [b for _, b in rules])
    grid = torch.from_numpy(offset_grid(heads, levels, points)).to(device)
    offsets = [v for (n, _), v in zip(named, views)
               if n.endswith("sampling_offsets.bias")]
    torch._foreach_add_(offsets, [grid] * len(offsets))
    return {n: v for (n, _), v in zip(named, views)}


def fill_model(model: torch.nn.Module, seed: int, cfg, scheme: str
               ) -> Dict[str, torch.Tensor]:
    """Fill ``model``'s parameters (already on their device) in place from
    ``seed`` by ``scheme``; returns the state it copied in (views of one
    flat buffer)."""
    named = list(model.named_parameters())
    device = named[0][1].device
    state = make_state(named, seed, device, cfg.encoder_attention_heads,
                       cfg.num_feature_levels, cfg.encoder_n_points, scheme)
    with torch.no_grad():
        torch._foreach_copy_([p for _, p in named],
                             [state[n] for n, _ in named])
    return state
