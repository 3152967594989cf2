"""Windowed (banded) approximation for multi-scale deformable attention.

PyTorch port of ``egtr_tpu/ops/msda_window.py``: band geometry, query
segmentation, runtime band selection and the coordinate transform shared by
the banded CUDA kernels (forward ``msda_cuda.msda_fwd_win`` /
``msda_fwd_win_pp``, backward ``msda_cuda.msda_bwd_win_rows`` /
``msda_bwd_win_value`` and their per-point forms), their plain versions and
the matmul oracle (``msda.py``). The backward recomputes the band choice from
the same inputs with the same tile, so it clamps as the forward did.

A level taller than the window is viewed as overlapping y-bands of height
``win`` (stride ``win/2``). Encoder queries are raster-ordered, so a tile of
adjacent queries samples a narrow y-band: one band is picked per query tile
(``band="tile"``) or per (sampling point, tile) (``band="point"``) from the
attention-weighted mean sample row, and in-image samples are clamped to it.

Approximation contract:
  - samples whose y lands inside the selected band: identical to the exact
    path;
  - in-image samples outside the band: y clamped to the band edge (x stays
    exact);
  - out-of-image samples: exactly zero, as in the exact path.

Query tiles must not straddle raster discontinuities, so the caller passes
``query_segments`` (the per-level (h, w) of the query grid; for encoder
self-attention the ``spatial_shapes``) and each segment's rows are padded to
a tile multiple on their own.

The tile sizes come from the TPU kernel's memory budget (12 MiB of VMEM,
128-lane tiles). The card has no such limit, but the tile decides which
queries share a band, so the numbers are part of the function and are kept.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

_LANES = 128

Segments = Tuple[Tuple[int, int], ...]


def fit_tile(N: int, n_bufs: int, budget=12 * 2 ** 20) -> int:
    """Largest query tile (multiple of 128 lanes) whose ~n_bufs live
    [N, TQ] f32 temporaries fit the TPU kernel's VMEM budget."""
    tq = 4 * _LANES
    while tq > _LANES and n_bufs * tq * N * 4 > budget:
        tq //= 2
    return max(tq, _LANES)


def query_tile(win: int, D: int, w: int, n_bufs: int = 3) -> int:
    """Query-tile width for a banded level: the budget-fit tile
    (``fit_tile``), capped to the largest 128*2^k tile whose raster queries
    span at most win/4 rows of a w-wide level (a tile's own query span eats
    band slack exactly like a sampling offset)."""
    cap = _LANES
    while cap * 2 <= max(w * win // 4, _LANES):
        cap *= 2
    return min(fit_tile(win * D, n_bufs), cap)


def band_stride(win: int) -> int:
    return max(win // 2, 1)


def band_starts(h: int, win: int) -> Tuple[int, ...]:
    """Static start rows of overlapping y-bands of height ``win`` covering
    [0, h). Every start is a multiple of the stride (win/2). The last band
    may overhang h; the overhang rows read as zeros, which is the exact
    path's zero padding below the image."""
    if h <= win:
        return (0,)
    stride = band_stride(win)
    n = -(-(h - win) // stride) + 1
    return tuple(b * stride for b in range(n))


def segment_bounds(Q: int, query_segments) -> Segments:
    """(start, length) per raster-contiguous query segment."""
    if not query_segments:
        return ((0, Q),)
    segs = []
    q0 = 0
    for (sh, sw) in query_segments:
        segs.append((q0, sh * sw))
        q0 += sh * sw
    if q0 != Q:
        raise ValueError(f"query_segments cover {q0} queries, expected {Q}")
    return tuple(segs)


def padded_starts(segs: Segments, TQ: int) -> Tuple[int, ...]:
    """Start of each segment in the padded row layout, and the padded total
    as the last entry."""
    out, qp0 = [], 0
    for (_, qs) in segs:
        out.append(qp0)
        qp0 += -(-qs // TQ) * TQ
    return (*out, qp0)


def segment_rows_t(t: torch.Tensor, segs: Segments, TQ: int) -> torch.Tensor:
    """[..., Q] (query minor) -> [..., Q_pad_total]: each segment zero-padded
    to a TQ multiple, so no query tile straddles two segments."""
    parts = []
    for (q0, qs) in segs:
        seg = t[..., q0:q0 + qs]
        qsp = -(-qs // TQ) * TQ
        parts.append(F.pad(seg, (0, qsp - qs)) if qsp != qs else seg)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def unsegment_cols(out: torch.Tensor, segs: Segments, TQ: int) -> torch.Tensor:
    """[..., Q_pad_total] -> [..., Q] (drops the segment padding)."""
    starts = padded_starts(segs, TQ)
    parts = [out[..., qp0:qp0 + qs]
             for qp0, (_, qs) in zip(starts, segs)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def segment_cols(g: torch.Tensor, segs: Segments, TQ: int) -> torch.Tensor:
    """[B, H, D, Q] -> [B, H, D, Q_pad_total]: the inverse of
    :func:`unsegment_cols` (the output gradient of a banded level, laid out
    as its rows; the padding is zero)."""
    return segment_rows_t(g, segs, TQ)


def unsegment_rows(rows: torch.Tensor, segs: Segments, TQ: int) -> torch.Tensor:
    """[B, H, P, Q_pad_total] -> [B, Q, H, P] (drops the segment padding)."""
    return unsegment_cols(rows, segs, TQ).permute(0, 3, 1, 2)


def window_rows(iy: torch.Tensor, aw: torch.Tensor, h: int, win: int, TQ: int,
                per_point: bool = False):
    """Runtime band selection and coordinate transform, in row space.

    iy, aw: [B, H, P, Q_pad] float32 (segmented; padded rows carry aw = 0).
    Returns ``(bidx int32, iy_band, iy_clamped_abs, aw_eff, inband,
    in_image)``, where ``iy_band = iy_clamped_abs - band_start`` is the
    band-local coordinate the banded kernel consumes.

    ``per_point=False`` (band="tile"): one band per query tile, ``bidx``
    [B,H,T], chosen from the attention-weighted mean sample row over all P
    points of the tile. ``per_point=True`` (band="point"): each of the P
    sampling points selects its own band, ``bidx`` [B,H,P,T].
    """
    B, H, P, Qp = iy.shape
    T = Qp // TQ
    in_img = (iy > -1.0) & (iy < float(h))
    awe = torch.where(in_img, aw, 0.0)

    n_bands = len(band_starts(h, win))
    stride = band_stride(win)
    # weighted mean sample row (per tile, or per (point, tile)) -> nearest band
    wt = awe.reshape(B, H, P, T, TQ)
    iyt = iy.reshape(B, H, P, T, TQ)
    red = (4,) if per_point else (2, 4)
    den = wt.sum(dim=red)
    c = (iyt * wt).sum(dim=red) / den.clamp(min=1e-6)
    ideal = (c - (win - 1) / 2.0) / stride
    # torch.round rounds half to even, as jnp.round
    bidx = ideal.round().clamp(0, n_bands - 1).to(torch.int32)

    # band j starts at row j * stride; every query of a tile gets its start
    # (an expand, not repeat_interleave: that one waits for the device)
    sb = bidx.to(iy.dtype) * stride
    sbr = sb[..., None].expand(*sb.shape, TQ).reshape(*sb.shape[:-1], Qp)
    if not per_point:
        sbr = sbr[:, :, None, :]                              # [B,H,1,Qp]
    # clamp to the band edge, except where the band touches the image edge:
    # there the hat and the in-image guard already reproduce the exact
    # partial-weight / zero-pad behaviour of the (-1, 0) and (h-1, h)
    # fringes, so clamping would promote partial weights to 1
    lo = torch.where(sbr > 0, sbr, -1.0)
    hi = torch.where(sbr + win < h, sbr + (win - 1.0), float(h))
    iyc = torch.minimum(torch.maximum(iy, lo), hi)
    inband = in_img & (iy >= lo) & (iy <= hi)
    return bidx, iyc - sbr, iyc, awe, inband, in_img


def windowed_level_coords(loc_l: torch.Tensor, aw_l: torch.Tensor, h: int,
                          w: int, win: int, query_segments, Q: int, D: int,
                          per_point: bool = False):
    """Matmul-oracle transform: absolute clamped (loc, aw) for one level.

    loc_l: [B,Q,H,P,2], aw_l: [B,Q,H,P]. Returns (loc', aw') with the
    windowed path's clamped y and zeroed out-of-image weights in the same
    layout: feeding these to the exact op reproduces the windowed
    computation (banding only restricts which rows a sample can reach, which
    the clamp encodes). ``bidx`` is returned third, for callers that count
    band choices.
    """
    TQ = query_tile(win, D, w)
    segs = segment_bounds(Q, query_segments)
    iy = segment_rows_t(
        (loc_l[..., 1].float() * h - 0.5).permute(0, 2, 3, 1), segs, TQ)
    awr = segment_rows_t(aw_l.float().permute(0, 2, 3, 1), segs, TQ)
    bidx, _, iyc, awe, _, _ = window_rows(iy, awr, h, win, TQ, per_point)
    iyc_q = unsegment_rows(iyc, segs, TQ)                     # [B,Q,H,P]
    awe_q = unsegment_rows(awe, segs, TQ)
    loc_y = (iyc_q + 0.5) / h
    loc2 = torch.stack([loc_l[..., 0].float(), loc_y], dim=-1)
    return loc2.to(loc_l.dtype), awe_q, bidx


def check_window(window: int, query_segments: Sequence, band: str) -> None:
    """The JAX dispatch's validation of the windowed arguments."""
    if window > 0 and query_segments is None:
        raise ValueError("windowed MSDA requires query_segments "
                         "(raster layout of the queries)")
    if window % 2:
        raise ValueError(f"windowed MSDA requires an even window (a band "
                         f"is two half-band blocks), got {window}")
    if band not in ("tile", "point"):
        raise ValueError(f"msda band must be 'tile' or 'point', got "
                         f"{band!r}")
