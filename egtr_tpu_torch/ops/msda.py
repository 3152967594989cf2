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
cast to the value dtype once at the end. The gradient is explicit
(``ms_deform_attn_plain_bwd`` and the CUDA backward kernels), with the
roundings and the kink rule of the JAX backward kernels.
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


def _hat_grad(t: torch.Tensor) -> torch.Tensor:
    """d hat / dt as the JAX backward kernels take it (``msda_pallas.py:472``):
    ``-sign(t)`` inside the support, 0 outside it and at the kink t = 0."""
    return torch.where(t.abs() < 1.0, -torch.sign(t), torch.zeros_like(t))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Sums run in float32; a float64 input (numerical gradient checks) keeps
    its precision."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _corner_index(yc, xc, h: int, w: int):
    """Integer corner (yc, xc) [B,Q,H,P] -> (inside the map [B,Q,H,P], token
    index within the level [B,H,Q*P], clamped where outside)."""
    B, Q, H, P = yc.shape
    valid = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
    idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).long()
    return valid, idx.permute(0, 2, 1, 3).reshape(B, H, Q * P)


def _gather_corner(level, valid, idx):
    """Values [B,Q,H,P,D] of one corner from ``level`` [B,H,hw,D]; zero
    outside the map."""
    B, Q, H, P = valid.shape
    D = level.shape[-1]
    g = torch.gather(level, 2, idx[..., None].expand(B, H, Q * P, D))
    g = g.reshape(B, H, Q, P, D).permute(0, 2, 1, 3, 4)
    return torch.where(valid[..., None], g, 0.0)


def _pixel_coords(sampling_locations, lid: int, h: int, w: int, acc):
    """Pixel-space sample points of one level and their floor corners."""
    loc = sampling_locations[:, :, :, lid].to(acc)           # [B,Q,H,P,2]
    ix = loc[..., 0] * w - 0.5
    iy = loc[..., 1] * h - 0.5
    x0, y0 = ix.floor(), iy.floor()
    return ix, iy, x0, y0, x0 + 1.0, y0 + 1.0


def ms_deform_attn_plain(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor) -> torch.Tensor:
    """Bilinear gather of the four corners per sample, in plain PyTorch."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    dtype = value.dtype
    acc = _acc_dtype(dtype)
    low = dtype not in (torch.float32, torch.float64)
    # [B, H, S, D]: one gather table per (batch, head)
    table = value.to(acc).permute(0, 2, 1, 3)
    out = torch.zeros((B, Q, H, D), dtype=acc, device=value.device)
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        aw = attention_weights[:, :, :, lid].to(acc)         # [B,Q,H,P]
        ix, iy, x0, y0, x1, y1 = _pixel_coords(sampling_locations, lid, h, w,
                                               acc)
        wx0, wx1 = _hat(ix - x0), _hat(ix - x1)
        wy0, wy1 = _hat(iy - y0), _hat(iy - y1)
        flip = _orient(h, w, D) == "y"
        if low:
            if flip:
                wy0, wy1 = wy0.to(dtype).to(acc), wy1.to(dtype).to(acc)
            else:
                wx0, wx1 = wx0.to(dtype).to(acc), wx1.to(dtype).to(acc)
        level = table[:, :, start:start + h * w]              # [B,H,hw,D]
        v00 = _gather_corner(level, *_corner_index(y0, x0, h, w))
        v01 = _gather_corner(level, *_corner_index(y0, x1, h, w))
        v10 = _gather_corner(level, *_corner_index(y1, x0, h, w))
        v11 = _gather_corner(level, *_corner_index(y1, x1, h, w))
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


def ms_deform_attn_plain_bwd(value: torch.Tensor,
                             spatial_shapes: Sequence[Tuple[int, int]],
                             sampling_locations: torch.Tensor,
                             attention_weights: torch.Tensor,
                             grad_output: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Gradients (dvalue, dloc, daw) of the op, in plain PyTorch.

    Port of ``_msda_pallas_bwd`` with its two kernels' arithmetic
    (``_bwd_rows_body``, ``_bwd_dvtt_body``) written over the four corners.
    It recomputes the hats from (value, loc, aw). Per sample, with corners
    (y_j, x_i), ``hy_j``/``hx_i`` the hats and cdt the value dtype:

        dT_j   = cdt(hy_j * aw * g)            rounded per (y, channel)
        dix    = sum_i hat'(ix - x_i) sum_j sum_d V_ji dT_j
        T_j    = sum_i V_ji cdt(hx_i)
        daw    = sum_j sum_d hy_j T_j g
        diy    = sum_j sum_d aw hat'(iy - y_j) T_j g
        dV_ji += dT_j cdt(hx_i)

    The backward always rounds the x hats, also on a level whose forward
    rounds the y hats (the JAX backward never flips its orientation).
    ``hat'`` is :func:`_hat_grad`; a corner outside the map contributes
    nothing. ``dloc`` is chained through ``ix = x*w - 0.5``. Returned dtypes
    are those of the three inputs.
    """
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    dtype = value.dtype
    acc = _acc_dtype(dtype)
    low = dtype not in (torch.float32, torch.float64)

    def cdt(t):
        return t.to(dtype).to(acc) if low else t

    table = value.to(acc).permute(0, 2, 1, 3)                 # [B,H,S,D]
    g = grad_output.reshape(B, Q, H, 1, D).to(acc)
    dtable = torch.zeros((B, H, S, D), dtype=acc, device=value.device)
    dloc_parts, daw_parts = [], []
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        aw = attention_weights[:, :, :, lid].to(acc)         # [B,Q,H,P]
        ix, iy, x0, y0, x1, y1 = _pixel_coords(sampling_locations, lid, h, w,
                                               acc)
        xs, ys = (x0, x1), (y0, y1)
        hx = [cdt(_hat(ix - x)) for x in xs]
        ghx = [_hat_grad(ix - x) for x in xs]
        hy = [_hat(iy - y) for y in ys]
        ghy = [_hat_grad(iy - y) for y in ys]
        level = table[:, :, start:start + h * w]
        dlevel = dtable[:, :, start:start + h * w]
        dix = torch.zeros_like(ix)
        diy = torch.zeros_like(ix)
        daw = torch.zeros_like(ix)
        for j in range(2):
            dT = cdt((hy[j] * aw)[..., None] * g)             # [B,Q,H,P,D]
            T = torch.zeros_like(dT)
            for i in range(2):
                valid, idx = _corner_index(ys[j], xs[i], h, w)
                v = _gather_corner(level, valid, idx)
                dix = dix + (v * dT).sum(-1) * ghx[i]
                T = T + v * hx[i][..., None]
                dv = torch.where(valid[..., None], dT * hx[i][..., None], 0.0)
                dlevel.scatter_add_(
                    2, idx[..., None].expand(B, H, Q * P, D),
                    dv.permute(0, 2, 1, 3, 4).reshape(B, H, Q * P, D))
            Tg = (T * g).sum(-1)                              # [B,Q,H,P]
            daw = daw + hy[j] * Tg
            diy = diy + aw * ghy[j] * Tg
        dloc_parts.append(torch.stack([dix * w, diy * h], dim=-1))
        daw_parts.append(daw)
        start += h * w
    dvalue = dtable.permute(0, 2, 1, 3).to(dtype).contiguous()
    dloc = torch.stack(dloc_parts, dim=3).to(sampling_locations.dtype)
    daw = torch.stack(daw_parts, dim=3).to(attention_weights.dtype)
    return dvalue, dloc, daw


class _MSDeformAttn(torch.autograd.Function):
    """The op with its explicit backward. It saves only (value, loc, aw), as
    the JAX op does: the backward recomputes the hats. With ``kernel`` and
    CUDA tensors it launches the hand-written kernels (forward
    ``msda_cuda.msda_fwd``, backward ``msda_cuda.msda_bwd``); otherwise it
    runs the plain forward and the plain backward. Autograd never
    differentiates through ``ms_deform_attn_plain``: its gradient would round
    other products and pick other subgradients at the hats' kinks."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights,
                spatial_shapes, kernel):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = spatial_shapes
        ctx.kernel = kernel
        if kernel:
            from .msda_cuda import msda_fwd
            return msda_fwd(value, spatial_shapes, sampling_locations,
                            attention_weights)
        return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_output):
        value, loc, aw = ctx.saved_tensors
        if ctx.kernel:
            from .msda_cuda import msda_bwd
            grads = msda_bwd(value, ctx.spatial_shapes, loc, aw,
                             grad_output.contiguous())
        else:
            grads = ms_deform_attn_plain_bwd(value, ctx.spatial_shapes, loc,
                                             aw, grad_output)
        return (*grads, None, None)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   impl: str = "auto") -> torch.Tensor:
    """Exact multi-scale deformable attention, forward and gradient.

    impl "auto" and "pallas" launch the hand-written CUDA kernels on CUDA
    tensors (``msda_cuda``) and take the plain versions on CPU tensors;
    "matmul" and "gather" (the JAX package's XLA paths) take the plain
    versions on any device. Where autograd needs a gradient the call goes
    through :class:`_MSDeformAttn`.
    """
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if len(spatial_shapes) != sampling_locations.shape[3]:
        raise ValueError(
            f"{len(spatial_shapes)} spatial shapes for "
            f"{sampling_locations.shape[3]} levels of sampling locations")
    if impl in ("auto", "pallas"):
        kernel = value.device.type != "cpu"
    elif impl in ("matmul", "gather"):
        kernel = False
    else:
        raise ValueError(f"unknown msda impl: {impl!r}")
    tensors = (value, sampling_locations, attention_weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _MSDeformAttn.apply(*tensors, spatial_shapes, kernel)
    if kernel:
        from .msda_cuda import msda_fwd
        return msda_fwd(*tensors[:1], spatial_shapes, *tensors[1:])
    return ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                                attention_weights)
