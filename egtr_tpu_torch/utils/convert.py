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

``convert_detr_state_dict`` reads the reference's own checkpoints (HF
``DetrForSceneGraphGeneration`` names, a Lightning ``model.`` prefix or
none) straight into the same ``state_dict`` names, with no flax tree in
between: reference tensors are torch layouts already, so only the relation
head's raw ``*_kernel`` parameters are transposed.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

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


_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_BN = "(?:" + "|".join(_BN_LEAVES) + ")"
_TIMM_BLOCK_RE = re.compile(
    rf"layer([1-4])\.(\d+)\.(conv[123]\.weight|bn[123]\.{_BN}"
    rf"|downsample\.0\.weight|downsample\.1\.{_BN})$")


def _timm_name(key: str) -> Optional[str]:
    """The port's backbone name of a raw timm/torchvision ResNet key, or
    None for a key it has no counterpart of (the classifier, the BN
    counters)."""
    if key == "conv1.weight" or (key.startswith("bn1.")
                                 and key[4:] in _BN_LEAVES):
        return key
    m = _TIMM_BLOCK_RE.match(key)
    if not m:
        return None
    stage, block, rest = m.groups()
    rest = (rest.replace("downsample.0.", "downsample_conv.")
            .replace("downsample.1.", "downsample_bn."))
    return f"layer{stage}_{block}.{rest}"


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
    out = {f"{root}.{_timm_name(key)}": torch.as_tensor(
        np.asarray(value, np.float32))
        for key, value in sd.items() if _timm_name(key)}
    if not out:
        raise ValueError(
            "state dict contains no recognizable ResNet keys (expected raw "
            "timm/torchvision names like 'conv1.weight')")
    return out


def strip_prefix(sd: Mapping[str, object]) -> Dict[str, object]:
    """Strip one leading Lightning ``model.`` prefix if every key has it
    (``egtr_tpu/utils/convert.py:strip_prefix``)."""
    if all(k.startswith("model.") for k in sd):
        return {k[len("model."):]: v for k, v in sd.items()}
    return dict(sd)


def _array(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().float().numpy()
    return np.asarray(value, np.float32)


_REF_BACKBONE = "model.backbone.conv_encoder.model."
_REF_BLOCK_RE = re.compile(r"layer([1-4])\.(\d+)\.")


def _check_reference_depth(sd: Mapping[str, object], cfg: EgtrConfig) -> None:
    """The reference backbone's block counts must be the config's."""
    counts = dict.fromkeys((1, 2, 3, 4), 0)
    for key in sd:
        m = key.startswith(_REF_BACKBONE) and _REF_BLOCK_RE.match(
            key[len(_REF_BACKBONE):])
        if m:
            stage = int(m.group(1))
            counts[stage] = max(counts[stage], int(m.group(2)) + 1)
    found = tuple(counts.values())
    if any(found) and found != cfg.backbone_blocks:
        raise ValueError(f"backbone block counts {found} do not match "
                         f"cfg.backbone={cfg.backbone!r} "
                         f"{cfg.backbone_blocks}")


def convert_detr_state_dict(sd: Mapping[str, object], cfg: EgtrConfig
                            ) -> Dict[str, torch.Tensor]:
    """A reference EGTR / detector state dict (HF names, torch layouts; a
    Lightning ``model.`` prefix is stripped; numpy or torch values) as the
    port's ``state_dict`` (float32 CPU tensors): the counterpart of
    ``egtr_tpu.utils.convert.convert_detr_state_dict`` followed by
    ``state_dict_from_jax``, leaf for leaf.

    Pieces absent from ``sd`` are absent from the result (merge with a fresh
    init via ``checkpoint.merge_pretrained``, or load with
    ``load_state_dict(strict=True)`` to require every leaf). A key this map
    does not take raises, naming it (a two-stage checkpoint under a config
    without ``two_stage`` among them), as do backbone block counts other than
    the config's. The BN counters ``num_batches_tracked`` have no
    counterpart and are dropped."""
    sd = {k: v for k, v in strip_prefix(sd).items()
          if not k.endswith("num_batches_tracked")}
    _check_reference_depth(sd, cfg)
    out: Dict[str, torch.Tensor] = {}
    taken = set()

    def put(src: str, dst: str, transpose: bool = False) -> None:
        if src in sd:
            arr = _array(sd[src])
            out[dst] = torch.from_numpy(np.array(arr.T if transpose else arr,
                                                 np.float32, order="C"))
            taken.add(src)

    def linear(src: str, dst: str) -> None:
        put(f"{src}.weight", f"{dst}.weight")
        put(f"{src}.bias", f"{dst}.bias")

    # the ResNet trunk, under the reference's backbone wrapper; conv
    # weights stay OIHW
    for key in [k for k in sd if k.startswith(_REF_BACKBONE)]:
        name = _timm_name(key[len(_REF_BACKBONE):])
        if name:
            put(key, f"model.backbone.{name}")

    for lvl in range(cfg.num_feature_levels):
        src, dst = f"model.input_proj.{lvl}", f"model.input_proj_{lvl}"
        linear(f"{src}.0", f"{dst}_conv")
        linear(f"{src}.1", f"{dst}_norm")
    if cfg.two_stage:
        # the proposal machinery in place of the learned queries and
        # reference points (deformable_detr.py:2306-2343)
        for name in ("enc_output", "enc_output_norm", "pos_trans",
                     "pos_trans_norm"):
            linear(f"model.{name}", f"model.{name}")
    else:
        put("model.query_position_embeddings.weight",
            "model.query_position_embeddings")
        linear("model.reference_points", "model.reference_points")
    put("model.level_embed", "model.level_embed")
    # the learned 50x50 position embedding lives under the reference's
    # backbone wrapper (deformable_detr.py:880-906)
    for name in ("row_embeddings", "column_embeddings"):
        put(f"model.backbone.position_embedding.{name}.weight",
            f"model.{name}")

    # encoder and decoder layers: the same names below the layer
    for kind, n_layers in (("encoder", cfg.encoder_layers),
                           ("decoder", cfg.decoder_layers)):
        for i in range(n_layers):
            src = f"model.{kind}.layers.{i}."
            for key in [k for k in sd if k.startswith(src)]:
                put(key, f"model.{kind}_layer_{i}.{key[len(src):]}")

    # detection heads: per-layer clones with box refinement or two stages,
    # else one shared pair; two stages add the proposals' head
    # (deformable_detr.py:2426-2443)
    num_pred = cfg.decoder_layers + int(cfg.two_stage)
    for idx in range(num_pred if (cfg.with_box_refine or cfg.two_stage)
                     else 1):
        linear(f"class_embed.{idx}", f"model.class_embed_{idx}")
        for j in range(3):
            linear(f"bbox_embed.{idx}.layers.{j}",
                   f"model.bbox_embed_{idx}.layers_{j}")

    # the relation head; its first layers are raw [in, out] parameters
    rh = "relation_head"
    for i in range(cfg.decoder_layers):
        linear(f"proj_q.{i}", f"{rh}.proj_q_{i}")
        linear(f"proj_k.{i}", f"{rh}.proj_k_{i}")
    linear("final_sub_proj", f"{rh}.final_sub_proj")
    linear("final_obj_proj", f"{rh}.final_obj_proj")
    put("rel_predictor_gate.weight", f"{rh}.rel_predictor_gate_kernel", True)
    put("rel_predictor_gate.bias", f"{rh}.rel_predictor_gate_bias")
    for src, dst in (("rel_predictor", "rel_predictor_layers"),
                     ("connectivity_layer", "connectivity_layers")):
        put(f"{src}.layers.0.weight", f"{rh}.{dst}_0_kernel", True)
        put(f"{src}.layers.0.bias", f"{rh}.{dst}_0_bias")
        for j in (1, 2):
            linear(f"{src}.layers.{j}", f"{rh}.{dst}_{j}")
    # the frequency-bias buffers
    put("rel_dist", "rel_dist")
    put("triplet_dist", "triplet_dist")

    left = sorted(set(sd) - taken)
    if left:
        raise ValueError(f"{len(left)} reference keys have no counterpart in "
                         f"the port for this config: {left[:10]}")
    return out
