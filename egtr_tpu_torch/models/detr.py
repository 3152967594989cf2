"""Deformable-DETR base model (PyTorch port of ``egtr_tpu/models/detr.py``).

Reference: ``DeformableDetrModel`` (model/deformable_detr.py:1978-2390) plus
the detection heads of ``DeformableDetrForObjectDetection`` (:2400-2553).
Backbone -> input projections with GroupNorm, sine (or learned) position and
level embeddings -> MSDA encoder -> query decoder that exposes the per-layer
self-attention Q/K -> per-layer class and box heads.

The port covers the exact path, the banded MSDA approximation
(``msda_window``, ``msda_band``: encoder self-attention only) and int8 stage
1 (``msda_int8``: encoder and decoder), forward and gradient. It refuses at
construction what only the JAX package implements so far:
``two_stage`` and rematerialization (``use_remat``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import RESNET50_STAGE_CHANNELS, EgtrConfig
from ..ops.boxes import inverse_sigmoid
from ..ops.posenc import sine_position_embedding, sine_position_embedding_full
from .backbone import ResNet50
from .layers import (Conv, DecoderLayer, Dense, EncoderLayer, Initialized,
                     MLPHead, constant_init, dropout, normal_init, ones,
                     uniform_init, xavier_uniform, zeros)


def check_supported(cfg: EgtrConfig) -> None:
    """Raise NotImplementedError for options outside the port so far."""
    if cfg.two_stage:
        raise NotImplementedError("two_stage is not ported yet")
    if cfg.use_remat:
        raise NotImplementedError(
            "use_remat (rematerialized layers) is not ported yet")


def torch_dtype(name: str) -> torch.dtype:
    """The config's ``compute_dtype``; the port runs float32 and bfloat16."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise NotImplementedError(f"compute_dtype {name!r} is not ported; "
                                  f"use one of {sorted(dtypes)}")
    return dtypes[name]


def level_shapes(image_hw: Tuple[int, int], num_levels: int,
                 dilation: bool = False) -> Tuple[Tuple[int, int], ...]:
    """Per-level (h, w) for a padded image shape.

    C3..C5 are ceil(H/8,16,32); each extra level is a stride-2 3x3 conv on
    the previous one -> ceil(/2). With ``dilation`` C5 stays at stride 16.
    """
    H, W = image_hw
    shapes = [(math.ceil(H / s), math.ceil(W / s))
              for s in (8, 16, 16 if dilation else 32)]
    while len(shapes) < num_levels:
        h, w = shapes[-1]
        shapes.append((math.ceil(h / 2), math.ceil(w / 2)))
    return tuple(shapes[:num_levels])


def _resize_mask(mask: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Downsample a [B,H,W] bool mask with torch's legacy 'nearest' semantics
    (src = floor(dst * in/out)), as the reference's F.interpolate does to
    pixel_mask (deformable_detr.py:783-786)."""
    B, H, W = mask.shape
    oh, ow = hw
    ri = torch.arange(oh, device=mask.device) * H // oh
    ci = torch.arange(ow, device=mask.device) * W // ow
    return mask[:, ri][:, :, ci]


def encoder_reference_points(spatial_shapes, valid_ratios: torch.Tensor):
    """Per-level normalized reference grid for the encoder.

    Reference: DeformableDetrEncoder.get_reference_points
    (deformable_detr.py:1615-1648). Returns [B, S, L, 2].
    """
    dev = valid_ratios.device
    refs = []
    for lid, (h, w) in enumerate(spatial_shapes):
        ref_y, ref_x = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij")
        r = torch.stack([ref_x.reshape(-1), ref_y.reshape(-1)], -1)[None]
        denom = valid_ratios[:, None, lid, :] * torch.tensor(
            [w, h], dtype=torch.float32, device=dev)
        refs.append(r / denom)
    ref = torch.cat(refs, dim=1)                             # [B, S, 2]
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]  # [B,S,L,2]


class GroupNorm(Initialized):
    """GroupNorm computed in float32 (the JAX module's ``dtype=float32``)."""

    def __init__(self, num_groups: int, features: int):
        super().__init__()
        self.num_groups = num_groups
        self.param("weight", (features,), ones)
        self.param("bias", (features,), zeros)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, eps=1e-5)


class DeformableDetrBase(Initialized):
    """Backbone -> multi-scale encoder -> query decoder with per-layer heads.

    Returns a dict with per-layer class logits / boxes, stacked decoder
    (q, k) attention states, and the final hidden state: everything the
    EGTR relation head needs.
    """

    def __init__(self, config: EgtrConfig):
        super().__init__()
        check_supported(config)
        cfg = self.config = config
        E = cfg.d_model
        dtype = self.dtype = torch_dtype(cfg.compute_dtype)
        Lv = cfg.num_feature_levels
        self.backbone = ResNet50(blocks=cfg.backbone_blocks, dtype=dtype,
                                 dilation=cfg.dilation)
        n_feats = len(RESNET50_STAGE_CHANNELS)
        for lvl in range(Lv):
            if lvl < n_feats:
                conv = Conv(RESNET50_STAGE_CHANNELS[lvl], E, 1, bias=True,
                            dtype=dtype, kernel_init=xavier_uniform)
            else:
                # extra level: stride-2 3x3 conv on C5, then on the previous
                # extra level (deformable_detr.py:1999-2009)
                in_ch = RESNET50_STAGE_CHANNELS[-1] if lvl == n_feats else E
                conv = Conv(in_ch, E, 3, stride=2, padding=1, bias=True,
                            dtype=dtype, kernel_init=xavier_uniform)
            self.add_module(f"input_proj_{lvl}_conv", conv)
            self.add_module(f"input_proj_{lvl}_norm", GroupNorm(32, E))
        if cfg.position_embedding_type == "learned":
            # 50x50 learned table (deformable_detr.py:880-906)
            self.param("row_embeddings", (50, E // 2), uniform_init(0.0, 1.0))
            self.param("column_embeddings", (50, E // 2),
                       uniform_init(0.0, 1.0))
        self.param("level_embed", (Lv, E), normal_init(1.0))

        for i in range(cfg.encoder_layers):
            self.add_module(f"encoder_layer_{i}", EncoderLayer(
                E, cfg.encoder_ffn_dim, cfg.encoder_attention_heads, Lv,
                cfg.encoder_n_points, cfg.activation_function, dtype,
                cfg.msda_impl, cfg.dropout, cfg.activation_dropout,
                cfg.msda_window, cfg.msda_band, cfg.msda_int8))

        # detection heads: per-layer clones with box refinement, else one
        # shared pair (deformable_detr.py:2426-2443)
        cls_bias = float(-math.log((1 - 0.01) / 0.01))
        self.n_heads = cfg.decoder_layers if cfg.with_box_refine else 1
        for i in range(self.n_heads):
            self.add_module(f"class_embed_{i}", Dense(
                E, cfg.num_labels, torch.float32,
                bias_init=constant_init(cls_bias)))
            self.add_module(f"bbox_embed_{i}", MLPHead(
                E, E, 4, 3, final_kernel_zero=True,
                final_bias=(0.0, 0.0, -2.0, -2.0), dtype=torch.float32))

        self.param("query_position_embeddings", (cfg.num_queries, 2 * E),
                   normal_init(0.02))
        self.reference_points = Dense(E, 2, torch.float32,
                                      kernel_init=xavier_uniform)
        for i in range(cfg.decoder_layers):
            self.add_module(f"decoder_layer_{i}", DecoderLayer(
                E, cfg.decoder_ffn_dim, cfg.decoder_attention_heads, Lv,
                cfg.decoder_n_points, cfg.activation_function, dtype,
                cfg.msda_impl, cfg.dropout, cfg.attention_dropout,
                cfg.activation_dropout, cfg.msda_int8))

    def _head(self, i: int):
        i = i if self.n_heads > 1 else 0
        return getattr(self, f"class_embed_{i}"), getattr(self, f"bbox_embed_{i}")

    def forward(self, pixel_values: torch.Tensor,
                pixel_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """pixel_values [B,H,W,3] (NHWC); pixel_mask [B,H,W] (True = valid)
        or None for an unpadded batch (the mask-free path); ``generator``
        feeds the dropout masks in ``train()`` mode."""
        cfg = self.config
        E = cfg.d_model
        dtype = self.dtype
        Lv = cfg.num_feature_levels
        B, H_img, W_img, _ = pixel_values.shape
        dev = pixel_values.device
        no_mask = pixel_mask is None
        if not no_mask:
            pixel_mask = pixel_mask.bool()

        feats = self.backbone(pixel_values)
        shapes = level_shapes((H_img, W_img), Lv, cfg.dilation)
        sources, masks, pos_embeds = [], [], []
        for lvl in range(Lv):
            if lvl < len(feats):
                x = feats[lvl]
            else:
                x = feats[-1] if lvl == len(feats) else sources[-1]
            src = getattr(self, f"input_proj_{lvl}_conv")(x)
            src = getattr(self, f"input_proj_{lvl}_norm")(src).to(dtype)
            if tuple(src.shape[2:]) != shapes[lvl]:
                raise ValueError(f"level {lvl}: conv shape "
                                 f"{tuple(src.shape[2:])} != {shapes[lvl]}")
            hh, ww = shapes[lvl]
            m = None if no_mask else _resize_mask(pixel_mask, shapes[lvl])
            if cfg.position_embedding_type == "learned":
                y_emb = self.row_embeddings[torch.arange(hh, device=dev).clamp(max=49)]
                x_emb = self.column_embeddings[torch.arange(ww, device=dev).clamp(max=49)]
                pe = torch.cat([x_emb[None, :, :].expand(hh, ww, E // 2),
                                y_emb[:, None, :].expand(hh, ww, E // 2)],
                               dim=-1)[None].expand(B, hh, ww, E)
            elif no_mask:
                pe = sine_position_embedding_full(
                    shapes[lvl], E // 2, device=dev).expand(B, hh, ww, E)
            else:
                pe = sine_position_embedding(m, E // 2)
            sources.append(src)
            masks.append(m)
            pos_embeds.append(pe)

        # NCHW -> [B, h*w, E], raster order as the JAX package's NHWC reshape
        source_flatten = torch.cat(
            [s.flatten(2).transpose(1, 2) for s in sources], dim=1)
        mask_flatten = None if no_mask else torch.cat(
            [m.reshape(B, -1) for m in masks], dim=1)
        pos_flatten = torch.cat(
            [p.reshape(B, -1, E) + self.level_embed[l][None, None]
             for l, p in enumerate(pos_embeds)], dim=1).to(dtype)

        # valid ratios (deformable_detr.py:2065-2074)
        if no_mask:
            valid_ratios = torch.ones((B, Lv, 2), dtype=torch.float32,
                                      device=dev)
        else:
            vr = []
            for m in masks:
                valid_h = m[:, :, 0].sum(1).float()
                valid_w = m[:, 0, :].sum(1).float()
                vr.append(torch.stack([valid_w / m.shape[2],
                                       valid_h / m.shape[1]], dim=-1))
            valid_ratios = torch.stack(vr, dim=1)             # [B,L,2]

        # ---- encoder ----
        enc_ref = encoder_reference_points(shapes, valid_ratios)
        hidden = dropout(source_flatten, cfg.dropout, self.training, generator)
        for i in range(cfg.encoder_layers):
            hidden = getattr(self, f"encoder_layer_{i}")(
                hidden, pos_flatten, enc_ref, shapes, mask_flatten, generator)
        encoder_hidden = hidden

        # ---- query init ----
        query_pos, target = self.query_position_embeddings.split(E, dim=1)
        query_pos = query_pos[None].expand(B, cfg.num_queries, E)
        target = target[None].expand(B, cfg.num_queries, E)
        reference_points = self.reference_points(query_pos).sigmoid()
        init_reference = reference_points
        query_pos = query_pos.to(dtype)
        target = target.to(dtype)

        # ---- decoder (deformable_detr.py:1853-1939) ----
        hidden = target
        inter_hidden, inter_refs, attn_qs, attn_ks = [], [], [], []
        for i in range(cfg.decoder_layers):
            if reference_points.shape[-1] == 4:
                ref_input = reference_points[:, :, None] * torch.cat(
                    [valid_ratios, valid_ratios], -1)[:, None]
            else:
                ref_input = reference_points[:, :, None] * valid_ratios[:, None]
            hidden, q, k = getattr(self, f"decoder_layer_{i}")(
                hidden, query_pos, encoder_hidden, ref_input, shapes,
                mask_flatten, generator)
            if cfg.with_box_refine:
                delta = self._head(i)[1](hidden)
                if reference_points.shape[-1] == 2:
                    # refs become 4-dim after the first refinement
                    # (deformable_detr.py:1908-1917)
                    new_ref = torch.cat(
                        [delta[..., :2] + inverse_sigmoid(reference_points),
                         delta[..., 2:]], dim=-1)
                else:
                    new_ref = delta + inverse_sigmoid(reference_points)
                reference_points = new_ref.sigmoid().detach()
            inter_hidden.append(hidden)
            inter_refs.append(reference_points)
            attn_qs.append(q)
            attn_ks.append(k)

        # ---- per-layer class/box outputs (egtr.py:286-314) ----
        outputs_classes, outputs_coords = [], []
        for lvl in range(cfg.decoder_layers):
            ref = init_reference if lvl == 0 else inter_refs[lvl - 1]
            ref = inverse_sigmoid(ref)
            cls_head, box_head = self._head(lvl)
            logits = cls_head(inter_hidden[lvl])
            delta = box_head(inter_hidden[lvl])
            if ref.shape[-1] == 4:
                coord_logits = delta + ref
            else:
                coord_logits = torch.cat([delta[..., :2] + ref,
                                          delta[..., 2:]], dim=-1)
            outputs_classes.append(logits)
            outputs_coords.append(coord_logits.sigmoid())

        return {
            "last_hidden_state": inter_hidden[-1],
            "logits": outputs_classes[-1],
            "pred_boxes": outputs_coords[-1],
            "all_logits": torch.stack(outputs_classes, dim=1),   # [B,Lyr,Q,C]
            "all_pred_boxes": torch.stack(outputs_coords, dim=1),
            "attention_queries": torch.stack(attn_qs, dim=1),    # [B,Lyr,H,Q,Dh]
            "attention_keys": torch.stack(attn_ks, dim=1),
            "init_reference_points": init_reference,
            "intermediate_reference_points": torch.stack(inter_refs, dim=1),
            "encoder_last_hidden_state": encoder_hidden,
        }
