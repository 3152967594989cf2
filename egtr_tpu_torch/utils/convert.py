"""JAX parameter tree -> the port's ``state_dict``.

The port's modules are named after the flax tree
(``model.encoder_layer_0.self_attn.value_proj``, ``model.backbone.layer1_0.conv1``,
``relation_head.rel_predictor_gate_kernel``), so the bridge is a mechanical
walk over the ``{'params': ...}`` tree of numpy arrays:

- a Dense ``kernel`` [in, out] becomes ``weight`` [out, in] (transpose);
- a Conv ``kernel`` HWIO becomes ``weight`` OIHW;
- a LayerNorm/GroupNorm ``scale`` becomes ``weight``;
- every other leaf keeps its name and layout (biases, frozen-BN statistics,
  embeddings, the relation head's raw ``*_kernel`` parameters, the
  frequency-bias tables).

Load the result with ``model.load_state_dict(sd, strict=True)``, so a leaf
that is missing or extra fails.

Every flax param is an ``nn.Parameter`` in the port, and the renames are
linear relayouts, so the same walk carries a JAX *gradient* tree
(``jax.grad`` over the params) to ``{parameter name: gradient}``: the tests
compare gradients name by name through it. Optimizer state is not carried.
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
    """Turn the JAX ``{'params': ...}`` tree (numpy or array-like leaves;
    parameters, or gradients of the same structure) into the port's
    ``state_dict`` layout (float32 CPU tensors)."""
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


_TIMM_BLOCK_RE = re.compile(
    r"layer(\d)\.(\d+)\.(conv[123]\.weight|bn[123]\.\w+|downsample\.[01]\.\w+)$")
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def backbone_state_dict_from_timm(sd: Mapping[str, object],
                                  root: str = "model.backbone"
                                  ) -> Dict[str, torch.Tensor]:
    """A RAW timm/torchvision ResNet state dict (keys like ``conv1.weight``,
    ``layer1.0.bn1.running_mean``, ``layer1.0.downsample.0.weight``) as
    entries of the port's ``state_dict`` under ``root``: the counterpart of
    ``egtr_tpu.utils.convert.convert_backbone_state_dict``, the reference's
    backbone bootstrap (train_egtr.py:255-260). Conv weights keep their OIHW
    layout; the classifier (``fc.*``) is dropped. Merge with a fresh init via
    ``checkpoint.merge_pretrained``."""
    out: Dict[str, torch.Tensor] = {}

    def put(name, value):
        out[f"{root}.{name}"] = torch.as_tensor(np.asarray(value, np.float32))

    for key, value in sd.items():
        if key == "conv1.weight":
            put("conv1.weight", value)
        elif key.startswith("bn1.") and key[4:] in _BN_LEAVES:
            put(key, value)
        else:
            m = _TIMM_BLOCK_RE.match(key)
            if not m:
                continue
            stage, block, rest = m.groups()
            rest = (rest.replace("downsample.0.", "downsample_conv.")
                    .replace("downsample.1.", "downsample_bn."))
            put(f"layer{stage}_{block}.{rest}", value)
    if not out:
        raise ValueError(
            "state dict contains no recognizable ResNet keys (expected raw "
            "timm/torchvision names like 'conv1.weight')")
    return out
