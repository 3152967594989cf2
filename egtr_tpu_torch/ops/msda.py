"""Multi-scale deformable attention: the plain PyTorch version and the dispatch.

PyTorch port of ``egtr_tpu/ops/msda.py`` (exact path only). Semantics: sampling
locations are normalized to [0,1]; the pixel-space sample point is
``loc * size - 0.5`` (identical to ``F.grid_sample(align_corners=False)`` with
grid ``2*loc-1``); bilinear interpolation with zero padding outside the
feature map; attention weights are already softmaxed over (levels x points);
the levels are summed.

Shapes:
    value:              [B, S, H, D]   (S = sum of h*w over levels)
    sampling_locations: [B, Q, H, L, P, 2]  (x, y), float32
    attention_weights:  [B, Q, H, L, P]
    returns:            [B, Q, H*D]   in the value dtype

Rounding follows the JAX package's Pallas kernel so that the hand-written
CUDA kernel (``msda_cuda.py``), this plain version and ``egtr_tpu`` differ
only in the order of summation: in a low-precision value dtype, the bilinear
weights of the contracted axis (x, or y where ``_orient`` flips the level) are
rounded to that dtype (``msda_pallas.py:136``); the other axis's weight times
the attention weight stays float32; everything accumulates in float32 and is
cast to the value dtype once at the end.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

_LANES = 128


def _orient(h: int, w: int, D: int) -> str:
    """The JAX kernel's contraction orientation for one level
    (``msda_pallas.py:948-965``): "x" contracts w, "y" contracts h. It
    decides which axis's bilinear weights are rounded to the value dtype."""
    cost_x = h * D * -(-w // _LANES)
    cost_y = w * D * -(-h // _LANES)
    return "y" if cost_y < cost_x else "x"


def _hat(t: torch.Tensor) -> torch.Tensor:
    return (1.0 - t.abs()).clamp(min=0.0)


def ms_deform_attn_plain(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Bilinear gather of the four corners per sample, in plain PyTorch."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    dtype = value.dtype
    # [B, H, S, D] float32: one gather table per (batch, head)
    table = value.float().permute(0, 2, 1, 3)
    out = torch.zeros((B, Q, H, D), dtype=torch.float32, device=value.device)
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lid].float()       # [B,Q,H,P,2]
        aw = attention_weights[:, :, :, lid].float()         # [B,Q,H,P]
        ix = loc[..., 0] * w - 0.5
        iy = loc[..., 1] * h - 0.5
        x0, y0 = ix.floor(), iy.floor()
        x1, y1 = x0 + 1.0, y0 + 1.0
        wx0, wx1 = _hat(ix - x0), _hat(ix - x1)
        wy0, wy1 = _hat(iy - y0), _hat(iy - y1)
        flip = _orient(h, w, D) == "y"
        if dtype != torch.float32:
            if flip:
                wy0, wy1 = wy0.to(dtype).float(), wy1.to(dtype).float()
            else:
                wx0, wx1 = wx0.to(dtype).float(), wx1.to(dtype).float()
        level = table[:, :, start:start + h * w]              # [B,H,hw,D]

        def corner(yc, xc):
            """Values at integer corner (yc, xc) [B,Q,H,P]; zero outside."""
            valid = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
            idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).long()
            idx = idx.permute(0, 2, 1, 3).reshape(B, H, Q * P, 1)
            g = torch.gather(level, 2, idx.expand(B, H, Q * P, D))
            g = g.reshape(B, H, Q, P, D).permute(0, 2, 1, 3, 4)
            return torch.where(valid[..., None], g, 0.0)     # [B,Q,H,P,D]

        v00, v01 = corner(y0, x0), corner(y0, x1)
        v10, v11 = corner(y1, x0), corner(y1, x1)
        if flip:
            # contract y first, then weight each column by hat_x * aw
            t0 = wy0[..., None] * v00 + wy1[..., None] * v10
            t1 = wy0[..., None] * v01 + wy1[..., None] * v11
            c0, c1 = wx0 * aw, wx1 * aw
        else:
            # contract x first, then weight each row by hat_y * aw
            t0 = wx0[..., None] * v00 + wx1[..., None] * v01
            t1 = wx0[..., None] * v10 + wx1[..., None] * v11
            c0, c1 = wy0 * aw, wy1 * aw
        out = out + (t0 * c0[..., None] + t1 * c1[..., None]).sum(3)
        start += h * w
    return out.reshape(B, Q, H * D).to(dtype)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   impl: str = "auto") -> torch.Tensor:
    """Exact multi-scale deformable attention (forward).

    impl "auto" and "pallas" launch the hand-written CUDA kernel on CUDA
    tensors (``msda_cuda.msda_fwd``) and take the plain version on CPU
    tensors; "matmul" and "gather" (the JAX package's XLA paths) take the
    plain version on any device.
    """
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if len(spatial_shapes) != sampling_locations.shape[3]:
        raise ValueError(
            f"{len(spatial_shapes)} spatial shapes for "
            f"{sampling_locations.shape[3]} levels of sampling locations")
    if impl in ("auto", "pallas"):
        if value.device.type == "cpu":
            return ms_deform_attn_plain(value, spatial_shapes,
                                        sampling_locations, attention_weights)
        from .msda_cuda import msda_fwd
        return msda_fwd(value, spatial_shapes, sampling_locations,
                        attention_weights)
    if impl in ("matmul", "gather"):
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)
    raise ValueError(f"unknown msda impl: {impl!r}")
