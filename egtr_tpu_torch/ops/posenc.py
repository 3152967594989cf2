"""2-D sine position embedding (PyTorch port of ``egtr_tpu/ops/posenc.py``).

Reference: ``DeformableDetrSinePositionEmbedding`` (model/deformable_detr.py:
850-876) — cumulative sum of the pixel mask, normalized, interleaved sin/cos.
Channels-last like the JAX package: [B, H, W, 2*embedding_dim].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _interleave(embed: torch.Tensor, embedding_dim: int,
                temperature: float) -> torch.Tensor:
    """[..., ] positions -> [..., embedding_dim] sin/cos pairs."""
    dim_t = torch.arange(embedding_dim, dtype=torch.float32,
                         device=embed.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / embedding_dim)
    pos = embed[..., None] / dim_t
    pos = torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], dim=-1)
    return pos.flatten(-2)


def sine_position_embedding(pixel_mask: torch.Tensor, embedding_dim: int = 128,
                            temperature: float = 10000.0,
                            normalize: bool = True,
                            scale: Optional[float] = None) -> torch.Tensor:
    """pixel_mask: [B, H, W] (1 = valid). Returns [B, H, W, 2*embedding_dim]."""
    if scale is None:
        scale = 2 * math.pi
    mask = pixel_mask.to(torch.float32)
    y_embed = mask.cumsum(1)
    x_embed = mask.cumsum(2)
    if normalize:
        eps = 1e-6
        y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * scale
        x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * scale
    pos_x = _interleave(x_embed, embedding_dim, temperature)
    pos_y = _interleave(y_embed, embedding_dim, temperature)
    return torch.cat([pos_y, pos_x], dim=-1)


def sine_position_embedding_full(hw: Tuple[int, int], embedding_dim: int = 128,
                                 temperature: float = 10000.0,
                                 scale: Optional[float] = None,
                                 device=None) -> torch.Tensor:
    """Mask-free path: the embedding for an all-valid [h, w] image
    (cumsum of ones == index + 1). Returns [1, h, w, 2*embedding_dim] —
    identical to :func:`sine_position_embedding` on a full mask."""
    if scale is None:
        scale = 2 * math.pi
    h, w = hw
    eps = 1e-6
    y = ((torch.arange(1, h + 1, dtype=torch.float32, device=device) - 0.5)
         / (h + eps) * scale)
    x = ((torch.arange(1, w + 1, dtype=torch.float32, device=device) - 0.5)
         / (w + eps) * scale)
    y_embed = y[None, :, None].expand(1, h, w)
    x_embed = x[None, None, :].expand(1, h, w)
    pos_x = _interleave(x_embed, embedding_dim, temperature)
    pos_y = _interleave(y_embed, embedding_dim, temperature)
    return torch.cat([pos_y, pos_x], dim=-1)
