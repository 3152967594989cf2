"""Multi-scale deformable attention: the plain PyTorch version and the dispatch.

PyTorch port of ``egtr_tpu/ops/msda.py``: the exact op, the int8 stage 1
(``int8``) and the banded approximation (``window``, ``band``; geometry in
``msda_window.py``), each as a plain version beside the hand-written CUDA
kernel that ``msda_cuda.py`` wraps. Semantics: sampling
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
roundings and the kink rule of the JAX backward kernels. The int8 op
without a window shares that backward (straight-through); a gradient through
a banded level is not ported yet and raises.

How a windowed call splits into launches (and so how the launch counts are
derived): the levels with ``h <= window`` go to the exact kernel in ONE
launch over that subset of levels (``msda_fwd``, or ``msda_fwd_q`` with
``int8``), and every taller level is ONE launch of the banded kernel
(``msda_fwd_win`` for ``band="tile"``, ``msda_fwd_win_pp`` for
``band="point"``, each in a float or an int8 form). Every launch returns that
part's float32 sum; the parts are added in float32 and cast to the value dtype
once, as the JAX op does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .msda_window import (Segments, check_window, query_tile,
                          segment_bounds, segment_rows_t, unsegment_cols,
                          window_rows, windowed_level_coords)

_LANES = 128

# When a list, every banded level of every windowed call appends
# ``(level index, bidx)``: whole-model comparisons count how many band
# choices differ between two paths. None (the default) records nothing.
band_index_log: Optional[List[Tuple[int, torch.Tensor]]] = None


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


def _corner_index(yc, xc, h: int, w: int, row0=None, nrows: int = 0):
    """Integer corner (yc, xc) [B,Q,H,P] -> (inside the map [B,Q,H,P], token
    index within the level [B,H,Q*P], clamped where outside).

    With ``row0`` (the band's start row per sample) ``yc`` is band-local: the
    corner exists where ``0 <= yc < nrows`` and its absolute row
    ``row0 + yc`` is less than ``h``."""
    B, Q, H, P = yc.shape
    valid = (xc >= 0) & (xc <= w - 1) & (yc >= 0)
    if row0 is None:
        valid = valid & (yc <= h - 1)
    else:
        valid = valid & (yc <= nrows - 1) & (yc + row0 <= h - 1)
        yc = yc + row0
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


def _hat_rounding(dtype: torch.dtype, int8: bool):
    """What stage 1 does to the contracted axis's hats: 7-bit integers with
    ``int8`` (``round(127 * hat)``, half to even), the value dtype where that
    is a low-precision one, nothing in float32/float64."""
    if int8:
        return lambda t: (t * 127.0).round()
    if dtype not in (torch.float32, torch.float64):
        acc = _acc_dtype(dtype)
        return lambda t: t.to(dtype).to(acc)
    return lambda t: t


def _sample_level(level, ix, iy, aw, h: int, w: int, flip: bool, round_hat,
                  row0=None, nrows: int = 0):
    """One level's weighted bilinear samples [B,Q,H,D] from ``level``
    [B,H,hw,D]; ``ix``, ``iy``, ``aw`` are [B,Q,H,P], all in the accumulation
    dtype. Stage 1 contracts x (y with ``flip``) with hats that went through
    ``round_hat``; stage 2 weights by the other axis's hat times ``aw``. With
    ``row0`` the level is read through a band: ``iy`` is band-local and the
    rows are ``row0 + y`` for ``0 <= y < nrows`` (see :func:`_corner_index`).
    """
    x0, y0 = ix.floor(), iy.floor()
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx0, wx1 = _hat(ix - x0), _hat(ix - x1)
    wy0, wy1 = _hat(iy - y0), _hat(iy - y1)
    if flip:
        wy0, wy1 = round_hat(wy0), round_hat(wy1)
    else:
        wx0, wx1 = round_hat(wx0), round_hat(wx1)
    v00 = _gather_corner(level, *_corner_index(y0, x0, h, w, row0, nrows))
    v01 = _gather_corner(level, *_corner_index(y0, x1, h, w, row0, nrows))
    v10 = _gather_corner(level, *_corner_index(y1, x0, h, w, row0, nrows))
    v11 = _gather_corner(level, *_corner_index(y1, x1, h, w, row0, nrows))
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
    return (t0 * c0[..., None] + t1 * c1[..., None]).sum(3)


def level_starts(spatial_shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """First token of each level in the flattened value."""
    starts, start = [], 0
    for h, w in spatial_shapes:
        starts.append(start)
        start += h * w
    return starts


def ms_deform_attn_plain(value: torch.Tensor,
                         spatial_shapes: Sequence[Tuple[int, int]],
                         sampling_locations: torch.Tensor,
                         attention_weights: torch.Tensor,
                         levels: Optional[Sequence[int]] = None,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Bilinear gather of the four corners per sample, in plain PyTorch.

    ``levels`` restricts the sum to those level indices (a windowed call sums
    its exact levels apart from its banded ones); ``out_dtype`` is the result
    dtype, the value dtype by default."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    dtype = value.dtype
    acc = _acc_dtype(dtype)
    round_hat = _hat_rounding(dtype, False)
    low = dtype not in (torch.float32, torch.float64)
    # [B, H, S, D]: one gather table per (batch, head)
    table = value.to(acc).permute(0, 2, 1, 3)
    out = torch.zeros((B, Q, H, D), dtype=acc, device=value.device)
    starts = level_starts(spatial_shapes)
    for lid in (range(L) if levels is None else levels):
        h, w = spatial_shapes[lid]
        aw = attention_weights[:, :, :, lid].to(acc)         # [B,Q,H,P]
        ix, iy = _pixel_coords(sampling_locations, lid, h, w, acc)[:2]
        flip = low and _orient(h, w, D) == "y"
        level = table[:, :, starts[lid]:starts[lid] + h * w]  # [B,H,hw,D]
        out = out + _sample_level(level, ix, iy, aw, h, w, flip, round_hat)
    return out.reshape(B, Q, H * D).to(dtype if out_dtype is None
                                       else out_dtype)


def quantize_levels(value: torch.Tensor,
                    spatial_shapes: Sequence[Tuple[int, int]]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of every level's values
    (``msda_pallas.py:_quantize_level``, in its order of operations).

    The scale is per (batch, head) over the level: ``sv = max |v|`` (at least
    1e-12) and ``vq = round(v * (127 / sv))``. Returns ``vq`` [B,S,H,D] int8
    and ``scale = sv / (127 * 127)`` [B,H,L] float32, which folds the value
    scale and the hats' 1/127 into the attention weights."""
    parts, scales = [], []
    for start, (h, w) in zip(level_starts(spatial_shapes), spatial_shapes):
        v = value[:, start:start + h * w].float()             # [B,hw,H,D]
        sv = v.abs().amax(dim=(1, 3)).clamp(min=1e-12)        # [B,H]
        # tensor / tensor: torch turns scalar / tensor into a product with
        # the reciprocal, which rounds other values than the JAX division
        inv = torch.full_like(sv, 127.0) / sv
        parts.append((v * inv[:, None, :, None]).round().to(torch.int8))
        scales.append(sv / torch.full_like(sv, 127.0 * 127.0))
    return torch.cat(parts, dim=1), torch.stack(scales, dim=-1)


def msda_fwd_q_plain(vq: torch.Tensor, scale: torch.Tensor,
                     spatial_shapes: Sequence[Tuple[int, int]],
                     sampling_locations: torch.Tensor,
                     attention_weights: torch.Tensor,
                     levels: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The int8 stage 1 in plain PyTorch, with the contract of the kernel
    ``msda_cuda.msda_fwd_q``: ``(vq, scale)`` from :func:`quantize_levels`,
    float32 [B, Q, H*D] out.

    Per sample the contracted axis (x, or y where ``_orient`` flips the
    level, in any dtype) sums ``vq * round(127 * hat)`` over its two corners
    in integers (float32 holds them exactly: at most 2 * 127 * 127); the
    other axis's hat times ``aw * scale`` weights the result in float32."""
    B, S, H, D = vq.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    round_hat = _hat_rounding(torch.float32, True)
    table = vq.float().permute(0, 2, 1, 3)
    out = torch.zeros((B, Q, H, D), dtype=torch.float32, device=vq.device)
    starts = level_starts(spatial_shapes)
    for lid in (range(L) if levels is None else levels):
        h, w = spatial_shapes[lid]
        aw = (attention_weights[:, :, :, lid].float()
              * scale[:, None, :, lid, None])
        ix, iy = _pixel_coords(sampling_locations, lid, h, w,
                               torch.float32)[:2]
        flip = _orient(h, w, D) == "y"
        level = table[:, :, starts[lid]:starts[lid] + h * w]
        out = out + _sample_level(level, ix, iy, aw, h, w, flip, round_hat)
    return out.reshape(B, Q, H * D)


def ms_deform_attn_plain_q(value: torch.Tensor,
                           spatial_shapes: Sequence[Tuple[int, int]],
                           sampling_locations: torch.Tensor,
                           attention_weights: torch.Tensor) -> torch.Tensor:
    """The op with int8 stage 1 (``msda_pallas.py:msda_pallas_q``), forward,
    in plain PyTorch: quantize, sample, cast to the value dtype."""
    vq, scale = quantize_levels(value, spatial_shapes)
    return msda_fwd_q_plain(vq, scale, spatial_shapes, sampling_locations,
                            attention_weights).to(value.dtype)


def msda_fwd_win_plain(value_l: torch.Tensor, bidx: torch.Tensor,
                       ix: torch.Tensor, iy_band: torch.Tensor,
                       aw_eff: torch.Tensor, h: int, w: int, win: int,
                       segs: Segments, Q: int) -> torch.Tensor:
    """One banded level in plain PyTorch, in the banded kernels' own terms
    (``msda_cuda.msda_fwd_win`` / ``msda_fwd_win_pp``): float32 [B, Q, H*D].

    ``value_l`` [B, h*w, H, D] are the level's values: float32, bfloat16 (the
    x hats are then rounded to bfloat16) or int8 (the x hats are
    ``round(127 * hat)`` and ``aw_eff`` carries the scale).
    ``ix``, ``iy_band``, ``aw_eff`` are the segmented rows [B, H, P, Q_pad] of
    ``msda_window.window_rows``, ``iy_band`` local to the sample's band.
    ``bidx`` is [B, H, T] (one band per query tile) or [B, H, P, T] (one per
    point and tile); band j covers rows ``j * win/2 + y`` for
    ``0 <= y < win``, rows at or beyond ``h`` read as zero, and a corner
    whose ``y`` lies outside ``[0, win)`` is dropped even where its absolute
    row exists (the hats are taken on the band-local coordinate)."""
    B, _, H, D = value_l.shape
    Qp = ix.shape[-1]
    TQ = Qp // bidx.shape[-1]
    int8 = value_l.dtype == torch.int8
    round_hat = _hat_rounding(value_l.dtype, int8)
    row0 = bidx * (win // 2)
    row0 = row0[..., None].expand(*row0.shape, TQ).reshape(*row0.shape[:-1],
                                                           Qp)
    if bidx.dim() == 3:
        row0 = row0[:, :, None, :].expand(B, H, ix.shape[2], Qp)

    def rows(t):  # [B,H,P,Qp] -> [B,Qp,H,P]
        return t.permute(0, 3, 1, 2)

    table = value_l.float().permute(0, 2, 1, 3)               # [B,H,hw,D]
    out = _sample_level(table, rows(ix).float(), rows(iy_band).float(),
                        rows(aw_eff).float(), h, w, False, round_hat,
                        row0=rows(row0).float(), nrows=win)   # [B,Qp,H,D]
    out = unsegment_cols(out.permute(0, 2, 3, 1), segs, TQ)   # [B,H,D,Q]
    return out.permute(0, 3, 1, 2).reshape(B, Q, H * D)


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


def _exact_forward(value, spatial_shapes, sampling_locations,
                   attention_weights, kernel: bool, int8: bool):
    """The op without a window: kernel or plain version, exact or int8."""
    args = (spatial_shapes, sampling_locations, attention_weights)
    if kernel:
        from . import msda_cuda
        if int8:
            vq, scale = quantize_levels(value, spatial_shapes)
            return msda_cuda.msda_fwd_q(vq, scale, *args).to(value.dtype)
        return msda_cuda.msda_fwd(value, *args)
    if int8:
        return ms_deform_attn_plain_q(value, *args)
    return ms_deform_attn_plain(value, *args)


class _MSDeformAttn(torch.autograd.Function):
    """The op with its explicit backward. It saves only (value, loc, aw), as
    the JAX op does: the backward recomputes the hats. With ``kernel`` and
    CUDA tensors it launches the hand-written kernels (forward
    ``msda_cuda.msda_fwd`` or, with ``int8``, ``msda_cuda.msda_fwd_q``;
    backward ``msda_cuda.msda_bwd``); otherwise it runs the plain forward and
    the plain backward. The int8 forward has the exact op's backward
    (straight-through, ``msda_pallas.py:1156``). Autograd never
    differentiates through ``ms_deform_attn_plain``: its gradient would round
    other products and pick other subgradients at the hats' kinks."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights,
                spatial_shapes, kernel, int8=False):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = spatial_shapes
        ctx.kernel = kernel
        return _exact_forward(value, spatial_shapes, sampling_locations,
                              attention_weights, kernel, int8)

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
        return (*grads, None, None, None)


def rows_t(sampling_locations, attention_weights):
    """[B,Q,H,L,P,2] / [B,Q,H,L,P] -> ([B,H,L,2,P,Q], [B,H,L,P,Q]) float32,
    query minor: the row layout of the banded path
    (``msda_pallas.py:_rows_t``)."""
    locT = sampling_locations.float().permute(0, 2, 3, 5, 4, 1).contiguous()
    awT = attention_weights.float().permute(0, 2, 3, 4, 1).contiguous()
    return locT, awT


def win_level_rows(locT, awT, lid: int, h: int, w: int, window: int,
                   segs: Segments, D: int, per_point: bool):
    """Segmented, window-transformed rows of one banded level from the
    :func:`rows_t` layout (``msda_pallas.py:_win_level_rows``): ``(bidx, ix,
    iy_band, iy_clamped_abs, aw_eff, inband, in_image)``, the rows
    [B, H, P, Q_pad_total] and contiguous."""
    # banding is strictly on y: the tile's raster queries span whole rows
    TQ = query_tile(window, D, w)
    ix = segment_rows_t(locT[:, :, lid, 0] * w - 0.5, segs, TQ)
    iy = segment_rows_t(locT[:, :, lid, 1] * h - 0.5, segs, TQ)
    awr = segment_rows_t(awT[:, :, lid], segs, TQ)
    bidx, *rest = window_rows(iy, awr, h, window, TQ, per_point)
    return (bidx.contiguous(), ix.contiguous(),
            *(r.contiguous() for r in rest))


def _windowed_forward(value, spatial_shapes, sampling_locations,
                      attention_weights, window: int, query_segments,
                      band: str, int8: bool, kernel: bool):
    """The banded forward (``msda_pallas.py:_msda_win_fwd``): exact levels in
    one launch, one launch per banded level, float32 parts summed."""
    if kernel:
        from . import msda_cuda
    B, S, H, D = value.shape
    Q = sampling_locations.shape[1]
    per_point = band == "point"
    exact = tuple(lid for lid, (h, _) in enumerate(spatial_shapes)
                  if h <= window)
    args = (spatial_shapes, sampling_locations, attention_weights)
    if int8:
        source, scale = quantize_levels(value, spatial_shapes)
    else:
        source = value
    out = None
    if exact and int8:
        fn = msda_cuda.msda_fwd_q if kernel else msda_fwd_q_plain
        out = fn(source, scale, *args, levels=exact)
    elif exact:
        fn = msda_cuda.msda_fwd if kernel else ms_deform_attn_plain
        out = fn(value, *args, levels=exact, out_dtype=torch.float32)
    if kernel:
        fn = msda_cuda.msda_fwd_win_pp if per_point else msda_cuda.msda_fwd_win
    else:
        fn = msda_fwd_win_plain
    locT, awT = rows_t(sampling_locations, attention_weights)
    segs = segment_bounds(Q, query_segments)
    starts = level_starts(spatial_shapes)
    for lid, (h, w) in enumerate(spatial_shapes):
        if h <= window:
            continue
        bidx, ix, iy_band, _, aw_eff, _, _ = win_level_rows(
            locT, awT, lid, h, w, window, segs, D, per_point)
        if band_index_log is not None:
            band_index_log.append((lid, bidx))
        if int8:
            aw_eff = aw_eff * scale[:, :, lid, None, None]
        part = fn(source[:, starts[lid]:starts[lid] + h * w], bidx, ix,
                  iy_band, aw_eff, h, w, window, segs, Q)
        out = part if out is None else out + part
    return out.to(value.dtype)


def _matmul_windowed(value, spatial_shapes, sampling_locations,
                     attention_weights, window: int, query_segments,
                     band: str):
    """The windowed approximation as the exact plain op on clamp-transformed
    coordinates (``egtr_tpu/ops/msda.py:_msda_matmul_windowed``): a second
    oracle for the banded kernels, which never sees a band. Compare in
    float32: in a low-precision dtype the exact plain op rounds the y hats on
    a level where it contracts y, the banded path always the x hats."""
    D = value.shape[3]
    Q = sampling_locations.shape[1]
    locs, aws = [], []
    for lid, (h, w) in enumerate(spatial_shapes):
        loc_l = sampling_locations[:, :, :, lid]
        aw_l = attention_weights[:, :, :, lid]
        if h > window:
            loc_l, aw_l, bidx = windowed_level_coords(
                loc_l, aw_l, h, w, window, query_segments, Q, D,
                per_point=band == "point")
            if band_index_log is not None:
                band_index_log.append((lid, bidx))
        locs.append(loc_l.float())
        aws.append(aw_l.float())
    loc = torch.stack(locs, dim=3).to(sampling_locations.dtype)
    aw = torch.stack(aws, dim=3).to(attention_weights.dtype)
    return ms_deform_attn_plain(value, spatial_shapes, loc, aw)


def _takes_kernels(impl: str, value: torch.Tensor) -> bool:
    """Whether a call launches the CUDA kernels: never for a CPU tensor, on
    any other device unless ``impl`` names a plain path."""
    return impl in ("auto", "pallas") and value.device.type != "cpu"


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor,
                   impl: str = "auto", window: int = 0,
                   query_segments=None, int8: bool = False,
                   band: str = "tile") -> torch.Tensor:
    """Multi-scale deformable attention: exact, with int8 stage 1, banded.

    impl "auto" and "pallas" launch the hand-written CUDA kernels on CUDA
    tensors (``msda_cuda``) and take their plain versions on CPU tensors;
    "plain" takes those plain versions on any device (what a kernel path is
    compared with on the card); "matmul" and "gather" (the JAX package's XLA
    paths) take the exact plain op on any device, "matmul" with a window on
    clamp-transformed coordinates.

    ``window > 0`` enables the banded approximation (``msda_window.py``) on
    the levels taller than ``window``; ``query_segments`` must then give the
    raster layout of the queries (encoder self-attention: the spatial
    shapes). ``band`` is "tile" (one band per query tile) or "point" (one per
    sampling point and tile). ``int8`` quantizes stage 1 (values to int8 per
    batch, head and level, the contracted hats to 7 bits); it is a feature of
    the kernels and is refused with "matmul" and "gather".

    Where autograd needs a gradient the call goes through
    :class:`_MSDeformAttn`; the int8 op has the exact op's gradient. The
    gradient of a call with a banded level is not ported yet (the JAX
    package's kernels K7-K10) and raises NotImplementedError.
    """
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if len(spatial_shapes) != sampling_locations.shape[3]:
        raise ValueError(
            f"{len(spatial_shapes)} spatial shapes for "
            f"{sampling_locations.shape[3]} levels of sampling locations")
    if query_segments is not None:
        query_segments = tuple((int(h), int(w)) for h, w in query_segments)
    window = int(window)
    check_window(window, query_segments, band)
    if impl not in ("auto", "pallas", "plain", "matmul", "gather"):
        raise ValueError(f"unknown msda impl: {impl!r}")
    if int8 and impl in ("matmul", "gather"):
        raise ValueError(
            f"int8 stage-1 is a kernel feature; impl={impl!r} cannot honor "
            "it (drop int8 or use impl='pallas'/'auto')")
    kernel = _takes_kernels(impl, value)
    tensors = (value, sampling_locations, attention_weights)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)
    if window > 0 and impl == "gather":
        raise ValueError("windowed MSDA is not supported on the gather path")
    if window > 0 and any(h > window for h, _ in spatial_shapes):
        if needs_grad:
            raise NotImplementedError(
                "the gradient of windowed MSDA (the banded backward kernels "
                "K7-K10 of egtr_tpu/ops/msda_pallas.py) is not ported yet; "
                "run it under torch.no_grad() or with msda_window=0")
        if impl == "matmul":
            return _matmul_windowed(*tensors[:1], spatial_shapes,
                                    *tensors[1:], window, query_segments, band)
        return _windowed_forward(*tensors[:1], spatial_shapes, *tensors[1:],
                                 window, query_segments, band, int8, kernel)
    # no level is banded: the op without a window
    if needs_grad:
        return _MSDeformAttn.apply(*tensors, spatial_shapes, kernel, int8)
    return _exact_forward(*tensors[:1], spatial_shapes, *tensors[1:], kernel,
                          int8)
