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
(``ms_deform_attn_plain_bwd`` and ``msda_bwd_win_plain``, and the CUDA
backward kernels), with the roundings and the kink rule of the JAX backward
kernels. The int8 op shares the backward of the op without int8
(straight-through), with or without a window.

How a windowed call splits into launches (and so how the launch counts are
derived): the levels with ``h <= window`` go to the exact kernel in ONE
launch over that subset of levels (``msda_fwd``, or ``msda_fwd_q`` with
``int8``), and every taller level is ONE launch of the banded kernel
(``msda_fwd_win`` for ``band="tile"``, ``msda_fwd_win_pp`` for
``band="point"``, each in a float or an int8 form). Every launch returns that
part's float32 sum; the parts are added in float32 and cast to the value dtype
once, as the JAX op does. Its backward splits the same way: the exact levels
in one launch each of ``msda_bwd_rows`` and ``msda_bwd_value``, every banded
level one launch each of the banded rows and value kernels
(``msda_bwd_win_rows`` / ``msda_bwd_win_value``, or their ``_pp`` forms for
``band="point"``).

With ``batch_p`` (by default :data:`FWD_BATCH_P`, set by the environment
variable ``EGTR_MSDA_BATCH_P=1`` as in ``msda_pallas.py:85``) every launch of
the exact forward, float or int8, whole or on a windowed call's exact levels,
goes to the batched-P kernel ``msda_fwd_bp`` (K11) in place of ``msda_fwd``
or ``msda_fwd_q``, and a CPU tensor takes its plain version
:func:`msda_fwd_bp_plain`. It computes the same function; the backward does
not read the flag.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch

from .msda_window import (Segments, check_window, query_tile,
                          segment_bounds, segment_cols, segment_rows_t,
                          unsegment_cols, unsegment_rows, window_rows,
                          windowed_level_coords)

_LANES = 128

# The default of ``batch_p``: every exact forward through the batched-P
# kernel K11, read once at import as the JAX package reads its flag
# (``msda_pallas.py:85``). Set it in-process to change the default.
FWD_BATCH_P = os.environ.get("EGTR_MSDA_BATCH_P", "0") == "1"

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
    """Pixel-space sample points (ix, iy) [B,Q,H,P] of one level."""
    loc = sampling_locations[:, :, :, lid].to(acc)           # [B,Q,H,P,2]
    return loc[..., 0] * w - 0.5, loc[..., 1] * h - 0.5


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
    """:func:`_sample_points` summed over the points: [B,Q,H,D]."""
    return _sample_points(level, ix, iy, aw, h, w, flip, round_hat, row0,
                          nrows).sum(3)


def _sample_points(level, ix, iy, aw, h: int, w: int, flip: bool, round_hat,
                   row0=None, nrows: int = 0):
    """One level's weighted bilinear samples [B,Q,H,P,D] from ``level``
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
    return t0 * c0[..., None] + t1 * c1[..., None]


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
        ix, iy = _pixel_coords(sampling_locations, lid, h, w, acc)
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
        ix, iy = _pixel_coords(sampling_locations, lid, h, w, torch.float32)
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


def msda_fwd_bp_plain(value: torch.Tensor,
                      spatial_shapes: Sequence[Tuple[int, int]],
                      sampling_locations: torch.Tensor,
                      attention_weights: torch.Tensor,
                      levels: Optional[Sequence[int]] = None,
                      out_dtype: Optional[torch.dtype] = None,
                      scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The batched-P forward (``msda_pallas.py:_fwd_body_bp``) in plain
    PyTorch, with the contract of the kernel ``msda_cuda.msda_fwd_bp``.

    Float form (``scale`` None): the contract of :func:`ms_deform_attn_plain`.
    int8 form (``value`` int8 and its ``scale`` from :func:`quantize_levels`):
    that of :func:`msda_fwd_q_plain`, float32 out. Each (level, point) term
    is computed with the roundings of those two, the L*P terms are stacked
    and summed in float32 at once, as the TPU kernel folds its points."""
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    int8 = value.dtype == torch.int8
    if int8 != (scale is not None):
        raise ValueError("msda_fwd_bp_plain takes a scale with int8 values "
                         "and only with them")
    acc = torch.float32 if int8 else _acc_dtype(value.dtype)
    round_hat = _hat_rounding(value.dtype, int8)
    rounds = int8 or value.dtype not in (torch.float32, torch.float64)
    table = value.to(acc).permute(0, 2, 1, 3)                 # [B,H,S,D]
    starts = level_starts(spatial_shapes)
    terms = []
    for lid in (range(L) if levels is None else levels):
        h, w = spatial_shapes[lid]
        aw = attention_weights[:, :, :, lid].to(acc)          # [B,Q,H,P]
        if int8:
            aw = aw * scale[:, None, :, lid, None]
        ix, iy = _pixel_coords(sampling_locations, lid, h, w, acc)
        flip = rounds and _orient(h, w, D) == "y"
        level = table[:, :, starts[lid]:starts[lid] + h * w]
        terms.append(_sample_points(level, ix, iy, aw, h, w, flip, round_hat))
    out = torch.cat(terms, dim=3).sum(3)                      # [B,Q,H,D]
    if int8:
        out_dtype = torch.float32
    return out.reshape(B, Q, H * D).to(value.dtype if out_dtype is None
                                       else out_dtype)


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
    TQ = ix.shape[-1] // bidx.shape[-1]
    int8 = value_l.dtype == torch.int8
    round_hat = _hat_rounding(value_l.dtype, int8)
    table = value_l.float().permute(0, 2, 1, 3)               # [B,H,hw,D]
    out = _sample_level(table, _rows(ix), _rows(iy_band), _rows(aw_eff), h,
                        w, False, round_hat, row0=_rows(_band_row0(bidx, ix,
                                                                   win)),
                        nrows=win)                            # [B,Qp,H,D]
    out = unsegment_cols(out.permute(0, 2, 3, 1), segs, TQ)   # [B,H,D,Q]
    return out.permute(0, 3, 1, 2).reshape(B, Q, H * D)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """Banded rows [B,H,P,Q_pad] -> [B,Q_pad,H,P] float32, the layout of
    :func:`_sample_level` and :func:`_level_bwd`."""
    return t.permute(0, 3, 1, 2).float()


def _band_row0(bidx: torch.Tensor, ix: torch.Tensor, win: int) -> torch.Tensor:
    """The band's first row for every banded row [B,H,P,Q_pad], from
    ``bidx`` [B,H,T] or [B,H,P,T]; ``ix`` gives the row shape."""
    B, H, P, Qp = ix.shape
    TQ = Qp // bidx.shape[-1]
    row0 = bidx * (win // 2)
    row0 = row0[..., None].expand(*row0.shape, TQ).reshape(*row0.shape[:-1],
                                                           Qp)
    if bidx.dim() == 3:
        row0 = row0[:, :, None, :]
    return row0.expand(B, H, P, Qp)


def _level_bwd(level, dlevel, ix, iy, aw, g, h: int, w: int, cdt,
               row0=None, nrows: int = 0):
    """One level's gradients in the backward kernels' arithmetic (see
    :func:`ms_deform_attn_plain_bwd`): returns (dix, diy, daw) [B,Q,H,P],
    the first two with respect to the pixel coordinates, and adds the value
    gradient into ``dlevel`` [B,H,hw,D]. ``level`` [B,H,hw,D]; ``ix``,
    ``iy``, ``aw`` [B,Q,H,P] and ``g`` [B,Q,H,1,D], all in the accumulation
    dtype. With ``row0`` the level is read through a band, as in
    :func:`_sample_level`."""
    B, Q, H, P = ix.shape
    D = level.shape[-1]
    x0, y0 = ix.floor(), iy.floor()
    xs, ys = (x0, x0 + 1.0), (y0, y0 + 1.0)
    hx = [cdt(_hat(ix - x)) for x in xs]
    ghx = [_hat_grad(ix - x) for x in xs]
    hy = [_hat(iy - y) for y in ys]
    ghy = [_hat_grad(iy - y) for y in ys]
    dix = torch.zeros_like(ix)
    diy = torch.zeros_like(ix)
    daw = torch.zeros_like(ix)
    for j in range(2):
        dT = cdt((hy[j] * aw)[..., None] * g)                 # [B,Q,H,P,D]
        T = torch.zeros_like(dT)
        for i in range(2):
            valid, idx = _corner_index(ys[j], xs[i], h, w, row0, nrows)
            v = _gather_corner(level, valid, idx)
            dix = dix + (v * dT).sum(-1) * ghx[i]
            T = T + v * hx[i][..., None]
            dv = torch.where(valid[..., None], dT * hx[i][..., None], 0.0)
            dlevel.scatter_add_(
                2, idx[..., None].expand(B, H, Q * P, D),
                dv.permute(0, 2, 1, 3, 4).reshape(B, H, Q * P, D))
        Tg = (T * g).sum(-1)                                  # [B,Q,H,P]
        daw = daw + hy[j] * Tg
        diy = diy + aw * ghy[j] * Tg
    return dix, diy, daw


def _cast_through(dtype: torch.dtype, acc: torch.dtype):
    """cdt of the backward: a product rounded to the value dtype where that
    is a low-precision one, as the JAX kernels feed it to the MXU."""
    if dtype in (torch.float32, torch.float64):
        return lambda t: t
    return lambda t: t.to(dtype).to(acc)


def ms_deform_attn_plain_bwd(value: torch.Tensor,
                             spatial_shapes: Sequence[Tuple[int, int]],
                             sampling_locations: torch.Tensor,
                             attention_weights: torch.Tensor,
                             grad_output: torch.Tensor,
                             levels: Optional[Sequence[int]] = None,
                             dvalue_dtype: Optional[torch.dtype] = None
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
    are those of the three inputs; ``dvalue_dtype`` (float32) keeps the value
    gradient's float32 sum instead. ``levels`` restricts the gradients to
    those level indices (a windowed call takes its banded levels elsewhere);
    the other levels' entries are zero.
    """
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    dtype = value.dtype
    acc = _acc_dtype(dtype)
    cdt = _cast_through(dtype, acc)
    table = value.to(acc).permute(0, 2, 1, 3)                 # [B,H,S,D]
    g = grad_output.reshape(B, Q, H, 1, D).to(acc)
    dtable = torch.zeros((B, H, S, D), dtype=acc, device=value.device)
    dloc = torch.zeros((B, Q, H, L, P, 2), dtype=acc, device=value.device)
    daw = torch.zeros((B, Q, H, L, P), dtype=acc, device=value.device)
    starts = level_starts(spatial_shapes)
    for lid in (range(L) if levels is None else levels):
        h, w = spatial_shapes[lid]
        level = slice(starts[lid], starts[lid] + h * w)
        ix, iy = _pixel_coords(sampling_locations, lid, h, w, acc)
        dix, diy, daw_l = _level_bwd(
            table[:, :, level], dtable[:, :, level], ix, iy,
            attention_weights[:, :, :, lid].to(acc), g, h, w, cdt)
        dloc[:, :, :, lid] = torch.stack([dix * w, diy * h], dim=-1)
        daw[:, :, :, lid] = daw_l
    dvalue = dtable.permute(0, 2, 1, 3).to(
        dtype if dvalue_dtype is None else dvalue_dtype).contiguous()
    return (dvalue, dloc.to(sampling_locations.dtype),
            daw.to(attention_weights.dtype))


def msda_bwd_win_plain(value_l: torch.Tensor, bidx: torch.Tensor,
                       ix: torch.Tensor, iy_band: torch.Tensor,
                       aw_eff: torch.Tensor, g: torch.Tensor, h: int, w: int,
                       win: int, segs: Segments, Q: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """The backward of one banded level in plain PyTorch, in the banded
    backward kernels' own terms (``msda_cuda.msda_bwd_win``): ``(dvalue_l
    float32 [B, h*w, H, D], dix, diy, daw float32 [B, H, P, Q_pad])``.

    The inputs are :func:`msda_fwd_win_plain`'s (``value_l`` float32 or
    bfloat16), plus ``g``, the op's output gradient [B, Q, H*D] (float32 or
    the value dtype), which is laid out as the rows with
    ``msda_window.segment_cols``. The arithmetic is that of
    ``_bwd_rows_body_hb`` and ``_bwd_dvtt_body`` (``msda_pallas.py:493-553,
    581-605``), the same as :func:`ms_deform_attn_plain_bwd`'s on the
    band-local coordinate, with the banded forward's reach: a corner whose
    band-local row lies outside ``[0, win)`` or at an absolute row ``>= h``
    contributes nothing. ``dix``/``diy`` are with respect to ``ix`` and
    ``iy_band``; the rows of the segment padding are zero. Nothing is masked:
    the caller masks ``diy`` where the clamp was active and ``daw`` outside
    the image."""
    B, _, H, D = value_l.shape
    TQ = ix.shape[-1] // bidx.shape[-1]
    cdt = _cast_through(value_l.dtype, torch.float32)
    g_seg = segment_cols(g.reshape(B, Q, H, D).permute(0, 2, 3, 1).float(),
                         segs, TQ)                            # [B,H,D,Qp]
    table = value_l.float().permute(0, 2, 1, 3)               # [B,H,hw,D]
    dtable = torch.zeros_like(table)
    grads = _level_bwd(table, dtable, _rows(ix), _rows(iy_band),
                       _rows(aw_eff), g_seg.permute(0, 3, 1, 2)[:, :, :, None],
                       h, w, cdt, _rows(_band_row0(bidx, ix, win)), win)
    # the kernels never visit the padding rows
    real = segment_rows_t(torch.ones(Q, device=ix.device), segs, TQ) > 0
    dix, diy, daw = (torch.where(real, t.permute(0, 2, 3, 1), 0.0)
                     for t in grads)
    return dtable.permute(0, 2, 1, 3).contiguous(), dix, diy, daw


def _exact_forward(value, spatial_shapes, sampling_locations,
                   attention_weights, kernel: bool, int8: bool,
                   batch_p: bool):
    """The op without a window: kernel or plain version, exact or int8, the
    batched-P kernel with ``batch_p``."""
    args = (spatial_shapes, sampling_locations, attention_weights)
    if kernel:
        from . import msda_cuda
    if batch_p:
        fn = msda_cuda.msda_fwd_bp if kernel else msda_fwd_bp_plain
        if int8:
            vq, scale = quantize_levels(value, spatial_shapes)
            return fn(vq, *args, scale=scale).to(value.dtype)
        return fn(value, *args)
    if kernel:
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
    ``msda_cuda.msda_fwd`` or, with ``int8``, ``msda_cuda.msda_fwd_q``, and
    with ``batch_p`` ``msda_cuda.msda_fwd_bp`` in place of either; backward
    ``msda_cuda.msda_bwd``); otherwise it runs the plain forward and
    the plain backward. The int8 forward has the exact op's backward
    (straight-through, ``msda_pallas.py:1156``). Autograd never
    differentiates through ``ms_deform_attn_plain``: its gradient would round
    other products and pick other subgradients at the hats' kinks."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights,
                spatial_shapes, kernel, int8=False, batch_p=False):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.spatial_shapes = spatial_shapes
        ctx.kernel = kernel
        return _exact_forward(value, spatial_shapes, sampling_locations,
                              attention_weights, kernel, int8, batch_p)

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
        return (*grads, None, None, None, None)


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
                      band: str, int8: bool, kernel: bool, batch_p: bool):
    """The banded forward (``msda_pallas.py:_msda_win_fwd``): exact levels in
    one launch (of K11 with ``batch_p``), one launch per banded level,
    float32 parts summed."""
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
    if exact and batch_p:
        fn = msda_cuda.msda_fwd_bp if kernel else msda_fwd_bp_plain
        if int8:
            out = fn(source, *args, levels=exact, scale=scale)
        else:
            out = fn(value, *args, levels=exact, out_dtype=torch.float32)
    elif exact and int8:
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


def _windowed_backward(value, sampling_locations, attention_weights,
                       grad_output, spatial_shapes, window: int,
                       query_segments, band: str, kernel: bool):
    """The banded backward (``msda_pallas.py:_msda_win_bwd``). The exact
    levels go through the exact backward limited to them (K2 + K3, or
    their plain version), each banded level through the banded rows and
    value kernels (or their plain version) on its recomputed rows, with the
    forward's band choice (the value kernels add into the level's slice of
    the float32 ``dvalue``). ``diy`` is masked where the clamp was active and
    ``daw`` outside the image; ``dvalue`` is summed in float32 and cast to
    the value dtype once. The int8 forward has this backward too
    (straight-through, ``msda_pallas.py:1348``)."""
    if kernel:
        from . import msda_cuda
    B, S, H, D = value.shape
    Q = sampling_locations.shape[1]
    exact = tuple(lid for lid, (h, _) in enumerate(spatial_shapes)
                  if h <= window)
    args = (value, spatial_shapes, sampling_locations, attention_weights,
            grad_output)
    if not exact:
        dvalue = torch.zeros((B, S, H, D), dtype=torch.float32,
                             device=value.device)
        dloc = torch.zeros_like(sampling_locations)
        daw = torch.zeros_like(attention_weights)
    elif kernel:
        dloc, daw = msda_cuda.msda_bwd_rows(*args, levels=exact)
        dvalue = msda_cuda.msda_bwd_value(*args, levels=exact,
                                          out_dtype=torch.float32)
    else:
        dvalue, dloc, daw = ms_deform_attn_plain_bwd(
            *args, levels=exact, dvalue_dtype=torch.float32)
    fn = msda_cuda.msda_bwd_win if kernel else msda_bwd_win_plain
    locT, awT = rows_t(sampling_locations, attention_weights)
    segs = segment_bounds(Q, query_segments)
    starts = level_starts(spatial_shapes)
    for lid, (h, w) in enumerate(spatial_shapes):
        if h <= window:
            continue
        bidx, ix, iy_band, _, aw_eff, inband, in_img = win_level_rows(
            locT, awT, lid, h, w, window, segs, D, band == "point")
        level = slice(starts[lid], starts[lid] + h * w)
        args = (value[:, level], bidx, ix, iy_band, aw_eff, grad_output, h,
                w, window, segs, Q)
        if kernel:
            # the level's slice of dvalue is zero: the kernels add into it
            _, dix, diy, daw_l = fn(*args, out=dvalue[:, level])
        else:
            dv, dix, diy, daw_l = fn(*args)
            dvalue[:, level] = dv
        TQ = query_tile(window, D, w)
        dloc[:, :, :, lid, :, 0] = unsegment_rows(dix, segs, TQ) * w
        dloc[:, :, :, lid, :, 1] = unsegment_rows(diy * inband, segs, TQ) * h
        daw[:, :, :, lid] = unsegment_rows(daw_l * in_img, segs, TQ)
    return dvalue.to(value.dtype), dloc, daw


class _MSDeformAttnWin(torch.autograd.Function):
    """The windowed op with its explicit backward
    (``msda_pallas.py:msda_pallas_win`` / ``msda_pallas_win_q``). Like the
    JAX op it saves only (value, loc, aw); the backward recomputes the band
    choice and the rows (:func:`_windowed_backward`). With ``kernel`` it
    launches the hand-written kernels both ways, otherwise their plain
    versions."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights,
                spatial_shapes, window, query_segments, band, int8, kernel,
                batch_p):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.args = (spatial_shapes, window, query_segments, band, kernel)
        return _windowed_forward(value, spatial_shapes, sampling_locations,
                                 attention_weights, window, query_segments,
                                 band, int8, kernel, batch_p)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_output):
        value, loc, aw = ctx.saved_tensors
        grads = _windowed_backward(value, loc, aw, grad_output.contiguous(),
                                   *ctx.args)
        return (*grads, None, None, None, None, None, None, None)


def _matmul_windowed(value, spatial_shapes, sampling_locations,
                     attention_weights, window: int, query_segments,
                     band: str):
    """The windowed approximation as the exact plain op on clamp-transformed
    coordinates (``egtr_tpu/ops/msda.py:_msda_matmul_windowed``): a second
    oracle for the banded kernels, which never sees a band. Compare in
    float32: in a low-precision dtype the exact plain op rounds the y hats on
    a level where it contracts y, the banded path always the x hats. Its
    gradient is autograd's through the clamp (``windowed_level_coords``)
    chained into the exact op's explicit backward, as JAX differentiates
    ``_msda_matmul_windowed``."""
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
    return _exact_op(value, spatial_shapes, loc, aw, False, False, False)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _exact_op(value, spatial_shapes, sampling_locations, attention_weights,
              kernel: bool, int8: bool, batch_p: bool):
    """The op without a window: through :class:`_MSDeformAttn` where
    autograd needs a gradient, else the bare forward."""
    tensors = (value, sampling_locations, attention_weights)
    if _needs_grad(*tensors):
        return _MSDeformAttn.apply(*tensors, spatial_shapes, kernel, int8,
                                   batch_p)
    return _exact_forward(value, spatial_shapes, sampling_locations,
                          attention_weights, kernel, int8, batch_p)


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
                   band: str = "tile", batch_p: Optional[bool] = None
                   ) -> torch.Tensor:
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
    the kernels and is refused with "matmul" and "gather". ``batch_p`` (None:
    :data:`FWD_BATCH_P`) sends every exact forward to the batched-P kernel
    K11 or its plain version; "matmul" and "gather" ignore it, as the JAX
    package's XLA paths do.

    Where autograd needs a gradient the call goes through
    :class:`_MSDeformAttn` (no banded level) or :class:`_MSDeformAttnWin`
    (the banded backward kernels K7-K10 on CUDA tensors with "auto" and
    "pallas", their plain version otherwise); the int8 op has the gradient
    of the op without int8 (straight-through). "matmul" with a window is
    differentiated through its clamp, as in the JAX package.
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
    batch_p = bool(FWD_BATCH_P if batch_p is None else batch_p) and impl in (
        "auto", "pallas", "plain")
    tensors = (value, sampling_locations, attention_weights)
    if window > 0 and impl == "gather":
        raise ValueError("windowed MSDA is not supported on the gather path")
    if window > 0 and any(h > window for h, _ in spatial_shapes):
        if impl == "matmul":
            return _matmul_windowed(value, spatial_shapes, sampling_locations,
                                    attention_weights, window, query_segments,
                                    band)
        if _needs_grad(*tensors):
            return _MSDeformAttnWin.apply(*tensors, spatial_shapes, window,
                                          query_segments, band, int8, kernel,
                                          batch_p)
        return _windowed_forward(value, spatial_shapes, sampling_locations,
                                 attention_weights, window, query_segments,
                                 band, int8, kernel, batch_p)
    # no level is banded: the op without a window
    return _exact_op(value, spatial_shapes, sampling_locations,
                     attention_weights, kernel, int8, batch_p)
