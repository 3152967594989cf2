"""JAX parameter tree -> the port's ``state_dict``.

The port's modules are named after the flax tree
(``model.encoder_layer_0.self_attn.value_proj``, ``model.backbone.layer1_0.conv1``,
``relation_head.rel_predictor_gate_kernel``), so the bridge is a mechanical
walk over the ``{'params': ...}`` tree of numpy arrays:

- a Dense ``kernel`` [in, out] becomes ``weight`` [out, in] (transpose);
- a Conv ``kernel`` HWIO becomes ``weight`` OIHW;
- a LayerNorm/GroupNorm ``scale`` becomes ``weight``;
- every other leaf keeps its name and layout (biases, frozen-BN statistics,
  embeddings, the relation head's raw ``*_kernel`` parameters, buffers).

Load the result with ``model.load_state_dict(sd, strict=True)``, so a leaf
that is missing or extra fails.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..config import EgtrConfig

_BLOCK_RE = re.compile(r"layer(\d)_(\d+)$")


def _leaf(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel" and value.ndim == 2:
        return "weight", value.T
    if name == "kernel" and value.ndim == 4:
        return "weight", value.transpose(3, 2, 0, 1)
    if name == "scale":
        return "weight", value
    return name, value


def _check_depth(tree: Mapping, cfg: EgtrConfig) -> None:
    """The backbone's block counts must be the config's (the JAX converter
    infers them from the keys and never checks them)."""
    backbone = tree.get("model", {}).get("backbone", {})
    counts = {1: 0, 2: 0, 3: 0, 4: 0}
    for key in backbone:
        m = _BLOCK_RE.match(key)
        if m:
            stage, b = int(m.group(1)), int(m.group(2))
            counts[stage] = max(counts[stage], b + 1)
    found = tuple(counts[s] for s in (1, 2, 3, 4))
    if backbone and found != cfg.backbone_blocks:
        raise ValueError(f"backbone block counts {found} do not match "
                         f"cfg.backbone={cfg.backbone!r} "
                         f"{cfg.backbone_blocks}")


def state_dict_from_jax(params: Mapping, cfg: EgtrConfig
                        ) -> Dict[str, torch.Tensor]:
    """Turn the JAX ``{'params': ...}`` tree (numpy or array-like leaves)
    into the port's ``state_dict`` (float32 CPU tensors)."""
    tree = params["params"] if "params" in params else params
    _check_depth(tree, cfg)
    sd: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: Tuple[str, ...]):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))
            else:
                name, arr = _leaf(key, np.asarray(value, np.float32))
                sd[".".join(prefix + (name,))] = torch.from_numpy(
                    np.array(arr, np.float32, order="C"))

    walk(tree, ())
    return sd
