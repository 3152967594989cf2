"""The launch geometry of the exact forward (K1, msda_fwd), the backward
row kernel (K2, msda_bwd_rows), the value-gradient kernel (K3,
msda_bwd_value), the int8 forward (K4, msda_fwd_q) and the banded kernels
with lanes over (query, point, channel group) (K6, msda_fwd_win_pp; K7 and
K8, msda_bwd_win_rows and msda_bwd_win_rows_pp; K10,
msda_bwd_win_value_pp), on the CPU.

``msda_cuda.launch_geometry`` decides how a warp's lanes split over
(sample, channel group), the vector width of a corner load, the passes,
the rows a warp walks, whether a row's locations are handed out by
shuffles, and the block and grid. The kernels cannot run here, so these
tests emulate their index mapping in numpy, as the sources write it
(block, warp, row step, lane, pass, chunk -> batch, query, head, sample,
channel), and check that every (row, sample, channel) is covered exactly
once, that the sources' own geometry check would accept the launch, and
that the geometry depends on the row count B*Q*H only. K3's blocks over
(batch, head, query chunk) and its split of the adds between the block's
shared copies and global memory are emulated too, and its float64 split
sum is held to the plain backward; the lanes of K6, K8 and K10 over (query,
point, channel group) are mapped through the segment table onto the padded
rows, K6's fold of a query's points over its lanes is held to the plain
forward, and K10's hand-out of a sample's geometry is walked as the kernel
walks it. K4's short rows, several a warp, each sample worked out on one
lane and handed to the lanes that read it, are walked the same way and
its fold is held to the plain int8 forward; K7's band table, read through
K8's kernel with a point stride of 0, is checked entry by entry.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from egtr_tpu_torch.ops import msda, msda_cuda
from egtr_tpu_torch.ops.msda_window import padded_starts, segment_bounds

H, L, P = 8, 4, 4
# the main paths' calls: serving 608x1008 (S = 12738) and training 800x1344
# (S = 22323); encoder Q = S, decoder Q = 200
BUCKET_S = {"serving": 12738, "training": 22323}
CALLS = ("encoder", "decoder")
ELEMENT_SIZE = {"f32": 4, "bf16": 2}


def _accepted(geom, rows, D, ns, lp, element_size, walk=True):
    """``geometry_ok`` of ``csrc/msda_geom.cuh``, and for msda_bwd_rows
    (``walk=False``) its one row a warp without the hand-out, in Python (a
    card test in tests/test_torch_cuda.py holds the C checks to this one)."""
    lps, spp = geom.lanes_per_sample, geom.samples_per_pass
    per_block = geom.threads // 32 * geom.rows_per_warp
    return (0 <= geom.lps_log2 <= 5
            and geom.vec >= 1 and geom.vec * element_size <= 16
            and geom.vec & (geom.vec - 1) == 0
            and geom.groups * geom.vec == D
            and geom.chunks * lps >= geom.groups
            and (geom.chunks - 1) * lps < geom.groups
            and geom.passes >= 0 and geom.passes * spp >= ns
            and geom.handout in (0, 1)
            and not (geom.handout and 2 * lp > 32)
            and geom.rows_per_warp >= 1
            and 32 <= geom.threads <= 256 and geom.threads % 32 == 0
            and geom.blocks >= 1 and geom.blocks * per_block >= rows
            and (geom.blocks - 1) * per_block < rows
            and (walk or (geom.rows_per_warp == 1 and geom.handout == 0)))


def _rows_of_warps(geom, rows):
    """The row of every (block, warp, step) that has one: warp ``w`` of
    block ``k`` walks rows ``k * warps * rows_per_warp + j * warps + w``."""
    warps = geom.threads // 32
    block = np.arange(geom.blocks)[:, None, None]
    step = np.arange(geom.rows_per_warp)[None, :, None]
    wib = np.arange(warps)[None, None, :]
    row = block * warps * geom.rows_per_warp + step * warps + wib
    return row[row < rows]


def _samples_and_channels(geom, ns):
    """(sample, first channel) of every lane, pass and chunk that has work,
    as the kernels' loops walk them (passes in steps of UNROLL)."""
    passes = -(-geom.passes // msda_cuda.UNROLL) * msda_cuda.UNROLL
    pass_ = np.arange(passes)[:, None, None]
    chunk = np.arange(geom.chunks)[None, :, None]
    lane = np.arange(32)[None, None, :]
    slot = lane >> geom.lps_log2
    sub = lane & (geom.lanes_per_sample - 1)
    sample = pass_ * geom.samples_per_pass + slot
    group = chunk * geom.lanes_per_sample + sub
    work = (sample < ns) & (group < geom.groups)
    shape = np.broadcast_shapes(pass_.shape, chunk.shape, lane.shape)
    sample, group, work = (np.broadcast_to(a, shape)
                           for a in (sample, group, work))
    return sample[work], group[work] * geom.vec


def _assert_covers_once(geom, rows, D, ns, Q=None):
    row = _rows_of_warps(geom, rows)
    # every row is walked by exactly one warp, once
    per_row = np.bincount(row, minlength=rows)
    assert per_row.shape == (rows,) and (per_row == 1).all()
    if Q is not None:
        # row = (b * Q + q) * H + head covers every (batch, query, head)
        head, b, q = row % H, row // H // Q, (row // H) % Q
        assert np.array_equal(np.unique((b * Q + q) * H + head),
                              np.arange(rows))
    # within a row, the warp's lanes cover every (sample, channel) once
    sample, first = _samples_and_channels(geom, ns)
    channel = (first[:, None] + np.arange(geom.vec)[None, :]).reshape(-1)
    sample = np.repeat(sample, geom.vec)
    count = np.bincount(sample * D + channel, minlength=ns * D)
    assert count.shape == (ns * D,) and (count == 1).all()
    # a vector load starts on a multiple of its width: token * H*D + head*D
    # + channel, with D a multiple of vec
    assert D % geom.vec == 0 and (first % geom.vec == 0).all()


def _assert_handout_reaches(geom, lp, ns, P):
    """With the hand-out, every sample's location and weight lie in lanes
    0..2*lp-1 and 0..lp-1, the lanes that hold a row's entries."""
    if not geom.handout:
        return
    s = np.arange(ns)
    i = (s // P) * P + s % P  # the model's level table: lid = level
    assert (2 * i + 1 < min(32, 2 * lp)).all() and (i < min(32, lp)).all()


@pytest.mark.parametrize("dtype", sorted(ELEMENT_SIZE))
@pytest.mark.parametrize("D", [8, 12, 32, 48, 64])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("bucket", sorted(BUCKET_S))
def test_geometry_covers_the_work_once(bucket, call, B, D, dtype):
    S = BUCKET_S[bucket]
    Q = S if call == "encoder" else 200
    lp, es = L * P, ELEMENT_SIZE[dtype]
    # all levels, and a windowed call's exact levels (two of four); K1
    # (walk) and K2
    for ns in (lp, 2 * P):
        for walk in (True, False):
            geom = msda_cuda.launch_geometry(B * Q * H, D, ns, lp, es,
                                             walk=walk)
            assert _accepted(geom, B * Q * H, D, ns, lp, es, walk)
            _assert_covers_once(geom, B * Q * H, D, ns, Q)
            _assert_handout_reaches(geom, lp, ns, P)
            # K1 takes the model's rows of 16 samples by hand-out, K2 not
            assert geom.handout == int(walk)
    # the main path's widths take the 16-byte load: 8 bf16 or 4 float32
    # channels, four (bf16) or eight (f32) lanes per sample at D = 32
    if D == 32:
        assert geom.vec * es == 16
        assert geom.lanes_per_sample == (4 if dtype == "bf16" else 8)


@pytest.mark.parametrize("D,ns,rows", [
    (1, 1, 3), (3, 12, 7), (6, 4, 5000), (96, 16, 900), (128, 33, 2200),
    (256, 8, 11), (512, 16, 4300)])
def test_geometry_at_odd_shapes(D, ns, rows):
    """Head dims and sample counts the model does not use (a level subset,
    P other than 4, a head dim above 32 lanes' worth of groups), with rows
    that fit the hand-out and rows that do not."""
    for es in (4, 2):
        for align in (16, 8, 4, 2):
            if align < es:
                continue
            for lp in (ns, ns + 17):
                for walk in (True, False):
                    geom = msda_cuda.launch_geometry(rows, D, ns, lp, es,
                                                     align, walk)
                    assert geom.handout == int(walk and 2 * lp <= 32)
                    assert _accepted(geom, rows, D, ns, lp, es, walk)
                    _assert_covers_once(geom, rows, D, ns)


def test_split_depends_on_the_row_count_only():
    """Shapes with the same B*Q*H take the same launch; a warp walks
    ROWS_PER_WARP rows from MIN_ROWS_TO_WALK rows on, else one. One warp
    sums each row, so no launch moves the order of a row's float32 sums:
    the rows a warp walks change only which warp takes a row."""
    for rows in (1600, 3200, 101904):
        seen = set()
        for B in (1, 2, 4, 8):
            for Hh in (1, 2, 4, 8):
                if rows % (B * Hh):
                    continue
                Q = rows // (B * Hh)
                seen.add(msda_cuda.launch_geometry(B * Q * Hh, 32, 16, 16, 2))
        assert len(seen) == 1
    walk, many = msda_cuda.rows_per_warp_for, msda_cuda.MIN_ROWS_TO_WALK
    assert [walk(r) for r in (1, many - 1, many, 10 ** 6)] == [
        1, 1, msda_cuda.ROWS_PER_WARP, msda_cuda.ROWS_PER_WARP]
    # the main paths: the encoder calls walk rows, the decoder calls not
    assert walk(12738 * H) == walk(22323 * H) == msda_cuda.ROWS_PER_WARP
    assert walk(200 * H) == walk(2 * 200 * H) == 1
    # K2 takes one row a warp at every size
    for rows in (1600, 101904):
        assert msda_cuda.launch_geometry(rows, 32, 16, 16, 2,
                                         walk=False).rows_per_warp == 1


def test_vector_width_follows_D_and_the_alignment():
    vw = msda_cuda.vector_width
    assert [vw(32, 2, 16), vw(32, 4, 16), vw(12, 2, 16), vw(12, 4, 16),
            vw(6, 2, 16), vw(33, 2, 16), vw(48, 2, 16)] == [8, 4, 4, 4, 2, 1, 8]
    assert [vw(32, 2, 8), vw(32, 2, 4), vw(32, 2, 2), vw(32, 4, 4)] == [
        4, 2, 1, 1]
    base = torch.zeros(4096, dtype=torch.bfloat16)
    assert msda_cuda.pointer_alignment(base) == 16  # the allocator's
    align = msda_cuda.pointer_alignment
    assert [align(base[1:]), align(base[2:]), align(base[4:]),
            align(base[8:])] == [2, 4, 8, 16]
    assert align(base, base[1:]) == 2
    f32 = torch.zeros(64)
    geom = msda_cuda.launch_geometry(10, 32, 16, 16, 4, align(f32[2:]))
    assert geom.vec == 2 and geom.groups == 16 and geom.lps_log2 == 4


def test_the_shared_header_keys_both_libraries(tmp_path, monkeypatch):
    """msda_fwd.cu, msda_bwd.cu and msda_fwd_q.cu include msda_geom.cuh,
    msda_fwd_win.cu and msda_bwd_win.cu include it through msda_band.cuh:
    an edited header builds all five libraries anew, under new names."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    sources = {"msda_fwd": ("SOURCE", "msda_geom.cuh"),
               "msda_bwd": ("SOURCE_BWD", "msda_geom.cuh"),
               "msda_fwd_q": ("SOURCE_Q", "msda_geom.cuh"),
               "msda_fwd_win": ("SOURCE_WIN", "msda_band.cuh"),
               "msda_bwd_win": ("SOURCE_BWD_WIN", "msda_band.cuh")}
    for name in (*(f"{n}.cu" for n in sources), "msda_geom.cuh",
                 "msda_band.cuh"):
        (csrc / name).write_text((msda_cuda._CSRC / name).read_text())
    assert '#include "msda_geom.cuh"' in (csrc / "msda_band.cuh").read_text()
    monkeypatch.setattr(msda_cuda, "_CSRC", csrc)
    for lib, (attr, header) in sources.items():
        assert f'#include "{header}"' in (csrc / f"{lib}.cu").read_text()
        monkeypatch.setattr(msda_cuda, attr, csrc / f"{lib}.cu")
    for header in ("msda_geom.cuh", "msda_band.cuh"):
        before = {n: msda_cuda.library_path(n) for n in sources}
        with open(csrc / header, "a") as f:
            f.write("// edited\n")
        after = {n: msda_cuda.library_path(n) for n in sources}
        assert all(before[n] != after[n] for n in before)


# --------------------------------------------------------------------------
# K3 (msda_bwd_value): blocks over (batch, head, query chunk), levels kept
# in shared memory where the block's queries hit them densely
# --------------------------------------------------------------------------

# the level tables of the two buckets (serving 608x1008, training 800x1344)
BUCKET_LEVELS = {"serving": ((76, 126), (38, 63), (19, 32), (10, 16)),
                 "training": ((100, 168), (50, 84), (25, 42), (13, 21))}


def _accepted_value(geom, B, Q, H, D, level_hw, P, element_size):
    """msda_bwd.cu's ``value_geometry_ok`` in Python (at most four channels
    a lane, whatever the element size)."""
    lps = geom.lanes_per_sample
    floats = sum(h * w * (D + 1) for k, (h, w) in enumerate(level_hw)
                 if geom.private >> k & 1)
    return (0 <= geom.lps_log2 <= 5
            and 1 <= geom.vec <= 4 and geom.vec & (geom.vec - 1) == 0
            and geom.groups * geom.vec == D
            and geom.chunks * lps >= geom.groups
            and (geom.chunks - 1) * lps < geom.groups
            and geom.passes >= 0
            and geom.passes * geom.samples_per_pass >= len(level_hw) * P
            and 32 <= geom.threads <= 1024 and geom.threads % 32 == 0
            and 1 <= geom.query_chunks <= max(Q, 1)
            and geom.blocks == B * H * geom.query_chunks
            and 0 <= geom.private < 1 << len(level_hw)
            and geom.smem_bytes == 4 * floats
            and geom.smem_bytes <= msda_cuda.SMEM_PER_BLOCK)


def _value_rows(geom, B, Q, H):
    """(block, b, q, head) of every query a warp of K3 takes, as the kernel
    walks them: block -> (b * H + head, chunk), warp w -> chunk + (w + j *
    warps) * query_chunks."""
    warps = geom.threads // 32
    block = np.arange(geom.blocks)
    bh, chunk = block // geom.query_chunks, block % geom.query_chunks
    per_warp = -(-Q // (geom.query_chunks * warps))
    m = (np.arange(warps)[:, None]
         + np.arange(per_warp)[None, :] * warps).reshape(-1)
    q = chunk[:, None] + m[None, :] * geom.query_chunks
    blk = np.broadcast_to(block[:, None], q.shape)
    keep = q < Q
    blk, q = blk[keep], q[keep]
    return blk, bh[blk] // H, q, bh[blk] % H


@pytest.mark.parametrize("dtype", sorted(ELEMENT_SIZE))
@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("bucket", sorted(BUCKET_LEVELS))
def test_value_geometry_covers_every_add_once(bucket, call, B, dtype):
    """At the main paths' shapes every (batch, query, head) is taken by one
    warp once, a warp's lanes cover every (sample, channel) once, and each
    level's adds go either to the block's shared copy or to global memory;
    the encoder calls keep the coarsest level in shared memory, the decoder
    calls and a call on one level none."""
    level_hw = BUCKET_LEVELS[bucket]
    S = sum(h * w for h, w in level_hw)
    Q = S if call == "encoder" else 200
    es = ELEMENT_SIZE[dtype]
    for levels in (level_hw, level_hw[3:]):  # all, a windowed call's exact
        geom = msda_cuda.value_geometry(B, Q, H, 32, levels, P, es)
        assert _accepted_value(geom, B, Q, H, 32, levels, P, es)
        blk, b, q, head = _value_rows(geom, B, Q, H)
        count = np.bincount((b * Q + q) * H + head, minlength=B * Q * H)
        assert count.shape == (B * Q * H,) and (count == 1).all()
        ns = len(levels) * P
        sample, first = _samples_and_channels(geom, ns)
        channel = (first[:, None] + np.arange(geom.vec)).reshape(-1)
        count = np.bincount(np.repeat(sample, geom.vec) * 32 + channel,
                            minlength=ns * 32)
        assert (count == 1).all()
        # the global reductions are vectors of vec floats on vec-aligned
        # channels of a row of D = 32 floats
        assert (first % geom.vec == 0).all() and 32 % geom.vec == 0
    # a call on one level (the adaptation's encoder call) keeps none
    assert msda_cuda.value_geometry(B, Q, H, 32, level_hw[3:], P,
                                    es).private == 0
    full = msda_cuda.value_geometry(B, Q, H, 32, level_hw, P, es)
    private = [k for k in range(L) if full.private >> k & 1]
    if call == "encoder":
        assert private == [3] and full.threads == msda_cuda.PRIVATE_THREADS
        # one wave: the blocks fit the SMs at the blocks an SM holds by
        # threads, registers and shared memory
        per_sm = msda_cuda.private_blocks_per_sm(full.smem_bytes)
        assert per_sm * full.threads * msda_cuda.VALUE_REGISTERS <= (
            msda_cuda.REGISTERS_PER_SM)
        assert full.blocks <= msda_cuda.N_SMS * per_sm or full.query_chunks == 1
    else:
        assert private == [] and full.smem_bytes == 0


@pytest.mark.parametrize("D,B,Q,H,n_levels", [
    (1, 1, 5, 1, 1), (6, 2, 300, 3, 3), (48, 1, 4000, 2, 4),
    (64, 3, 9000, 8, 2), (256, 1, 50, 8, 4), (512, 2, 7000, 1, 1)])
def test_value_geometry_at_odd_shapes(D, B, Q, H, n_levels):
    """Head dims, batches, query counts and level subsets the model does
    not use, in both element sizes and every alignment."""
    levels = ((40, 60), (20, 30), (10, 15), (5, 8))[4 - n_levels:]
    for es in (4, 2):
        for align in (16, 8, 4, 2):
            if align < es:
                continue
            geom = msda_cuda.value_geometry(B, Q, H, D, levels, P, es, align)
            assert _accepted_value(geom, B, Q, H, D, levels, P, es)
            blk, b, q, head = _value_rows(geom, B, Q, H)
            count = np.bincount((b * Q + q) * H + head, minlength=B * Q * H)
            assert (count == 1).all()
            sample, first = _samples_and_channels(geom, len(levels) * P)
            channel = (first[:, None] + np.arange(geom.vec)).reshape(-1)
            count = np.bincount(np.repeat(sample, geom.vec) * D + channel,
                                minlength=len(levels) * P * D)
            assert (count == 1).all()


def _hat(t):
    return np.maximum(0.0, 1.0 - np.abs(t))


def _k3_split_sum(geom, shapes, levels, loc, aw, g):
    """K3's value gradient in float64, as the kernel adds it: per block, the
    private levels' adds into its shared copy (D + 1 floats a pixel) and
    flushed into the gradient at the end, the other levels' adds straight
    into the gradient. Also counts each (sample, corner, channel) add."""
    B, Q, H, L_, P_, _ = loc.shape
    D = g.shape[-1] // H
    S = sum(h * w for h, w in shapes)
    starts = msda_cuda.level_starts(shapes)
    dv = np.zeros(B * S * H * D)
    adds = np.zeros((B, Q, H, len(levels), P_, 4, D), dtype=int)
    table = [(shapes[l][0], shapes[l][1], starts[l], l) for l in levels]
    offs, off = {}, 0
    for k, (h, w, _, _) in enumerate(table):
        if geom.private >> k & 1:
            offs[k] = off
            off += h * w * (D + 1)
    assert off * 4 == geom.smem_bytes
    blk, bs, qs, heads = _value_rows(geom, B, Q, H)
    sample, first = _samples_and_channels(geom, len(levels) * P_)
    for block in range(geom.blocks):
        priv = np.zeros(off)
        sel = blk == block
        for b, q, head in zip(bs[sel], qs[sel], heads[sel]):
            gq = g[b, q, head * D:(head + 1) * D]
            for s, d0 in zip(sample, first):
                k, p = divmod(int(s), P_)
                h, w, start, lid = table[k]
                a = aw[b, q, head, lid, p]
                ix = loc[b, q, head, lid, p, 0] * w - 0.5
                iy = loc[b, q, head, lid, p, 1] * h - 0.5
                x0, y0 = int(np.floor(ix)), int(np.floor(iy))
                corners = ((y0, x0), (y0, x0 + 1), (y0 + 1, x0),
                           (y0 + 1, x0 + 1))
                for c, (y, x) in enumerate(corners):
                    if not (0 <= x < w and 0 <= y < h):
                        continue
                    wgt = _hat(iy - y) * a * _hat(ix - x)
                    for d in range(d0, d0 + geom.vec):
                        adds[b, q, head, k, p, c, d] += 1
                        if k in offs:
                            priv[offs[k] + (y * w + x) * (D + 1) + d] += (
                                wgt * gq[d])
                        else:
                            dv[((b * S + start + y * w + x) * H + head) * D
                               + d] += wgt * gq[d]
        b, head = divmod(block // geom.query_chunks, H)
        for k, o in offs.items():
            h, w, start, _ = table[k]
            for px in range(h * w):
                row = ((b * S + start + px) * H + head) * D
                dv[row:row + D] += priv[o + px * (D + 1):
                                        o + px * (D + 1) + D]
    return dv.reshape(B, S, H, D), adds


@pytest.mark.parametrize("levels", [(0, 1, 2, 3), (3,), (0, 2)])
@pytest.mark.parametrize("raster", [False, True], ids=["uniform", "raster"])
@pytest.mark.parametrize("private", ["natural", "coarse", "all"])
def test_value_split_sum_matches_plain(private, raster, levels):
    """K3's split sum (shared copies flushed, plus global adds) against
    ``ms_deform_attn_plain_bwd``'s dvalue in float64, every in-map (sample,
    corner, channel) added exactly once; uniform locations reach outside
    the map, raster ones sit near each query's pixel."""
    shapes = ((6, 9), (3, 5), (2, 3), (1, 2))
    B, H, D = 2, 2, 8
    S = sum(h * w for h, w in shapes)
    Q = S if raster else 13
    rng = np.random.default_rng(7)
    if raster:
        ref = np.concatenate([np.stack(np.meshgrid(
            (np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h),
            -1).reshape(-1, 2) for h, w in shapes])
        loc = ref[None, :, None, None, None] + rng.uniform(
            -0.3, 0.3, (B, Q, H, L, P, 2))
    else:
        loc = rng.uniform(-0.2, 1.2, (B, Q, H, L, P, 2))
    aw = rng.random((B, Q, H, L, P))
    g = rng.standard_normal((B, Q, H * D))
    value = rng.standard_normal((B, S, H, D))
    level_hw = tuple(shapes[l] for l in levels)
    geom = msda_cuda.value_geometry(B, Q, H, D, level_hw, P, 4)
    if private != "natural":
        # the kernel takes any mask: here the coarse half, or every level
        mask = ((1 << len(levels)) - 1 if private == "all"
                else sum(1 << k for k, l in enumerate(levels) if l >= 2))
        floats = sum(h * w * (D + 1) for k, (h, w) in enumerate(level_hw)
                     if mask >> k & 1)
        geom = replace(geom, private=mask, smem_bytes=4 * floats,
                       threads=128, query_chunks=3, blocks=B * H * 3)
    assert _accepted_value(geom, B, Q, H, D, level_hw, P, 4)
    got, adds = _k3_split_sum(geom, shapes, levels, loc, aw, g)
    ref, _, _ = msda.ms_deform_attn_plain_bwd(
        *(torch.from_numpy(t) for t in (value,)), shapes,
        torch.from_numpy(loc), torch.from_numpy(aw), torch.from_numpy(g),
        levels=levels)
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-12, atol=1e-12)
    # each in-map corner once per channel, an out-of-map corner never
    assert adds.max() == 1 and adds.sum() > 0
    assert ((adds == 1).all(-1) | (adds == 0).all(-1)).all()


# --------------------------------------------------------------------------
# K6 (msda_fwd_win_pp), K8 (msda_bwd_win_rows_pp) and K10
# (msda_bwd_win_value_pp): lanes over (query, point, channel group)
# --------------------------------------------------------------------------

# a channel as a lane loads it, by the banded kernels' value types
WIN_ELEMENT_SIZE = {"f32": 4, "bf16": 2, "int8": 1}


def _accepted_win(geom, BH, Q, D, P_, element_size, form="rows"):
    """msda_band.cuh's ``win_geometry_ok`` in Python (``element_size`` 4
    for K10, whose adds are float32)."""
    lps, spp = geom.lanes_per_sample, geom.samples_per_pass
    n_warps = BH * -(-Q // geom.queries)
    per_block = geom.threads // 32
    samples = geom.queries * (1 if form == "fwd" and not geom.fold else P_)
    return (0 <= geom.lps_log2 <= 5 and P_ >= 1
            and geom.vec >= 1 and geom.vec * element_size <= 16
            and geom.vec & (geom.vec - 1) == 0
            and geom.groups * geom.vec == D
            and geom.chunks * lps >= geom.groups
            and (geom.chunks - 1) * lps < geom.groups
            and (geom.fold == 0 or (form == "fwd" and geom.fold == 1
                                    and spp % P_ == 0))
            and geom.queries >= 1 and geom.passes >= 0
            and geom.passes * spp >= samples
            and 32 <= geom.threads <= 256 and geom.threads % 32 == 0
            and geom.blocks >= 1 and geom.blocks * per_block >= n_warps
            and (geom.blocks - 1) * per_block < n_warps)


def _padded(q, segs, TQ):
    """A query's padded row through the segment table."""
    starts = padded_starts(segs, TQ)
    q_starts = np.array([q0 for q0, _ in segs])
    seg = np.searchsorted(q_starts, q, side="right") - 1
    return np.array(starts[:-1])[seg] + (q - q_starts[seg])


def _warps(geom, BH, Q):
    """(b * H + head, first query) of every warp that has work."""
    per_bh = -(-Q // geom.queries)
    warp = np.arange(geom.blocks * geom.threads // 32)
    warp = warp[warp < BH * per_bh]
    return warp // per_bh, (warp % per_bh) * geom.queries


def _k8_entries(geom, BH, Q, D, P_, segs, TQ):
    """(row entry, channel) of every lane, pass and chunk of K8 (and of
    K6 with ``fold``) that has work, as the kernel maps them: warp -> (b *
    H + head, first query), sample k of the warp -> (query first + k // P,
    point k % P), the query to its padded row through the segment table."""
    Qp = padded_starts(segs, TQ)[-1]
    bh, q0 = _warps(geom, BH, Q)
    sample, first = _samples_and_channels(geom, geom.queries * P_)
    q = q0[:, None] + sample[None, :] // P_
    p = np.broadcast_to(sample % P_, q.shape)
    first = np.broadcast_to(first, q.shape)
    bh = np.broadcast_to(bh[:, None], q.shape)
    keep = q < Q
    q, p, first, bh = q[keep], p[keep], first[keep], bh[keep]
    entry = (bh * P_ + p) * Qp + _padded(q, segs, TQ)
    return entry, first, Qp


def _assert_rows_once(entry, first, geom, BH, D, P_, segs, TQ, Qp):
    """Every real row and channel taken once, no padding row."""
    channel = (first[:, None] + np.arange(geom.vec)).reshape(-1)
    count = np.bincount(np.repeat(entry, geom.vec) * D + channel,
                        minlength=BH * P_ * Qp * D).reshape(BH, P_, Qp, D)
    real = np.zeros(Qp, dtype=bool)
    for (_, qs), qp0 in zip(segs, padded_starts(segs, TQ)):
        real[qp0:qp0 + qs] = True
    assert (count[:, :, real] == 1).all()
    assert (count[:, :, ~real] == 0).all()


@pytest.mark.parametrize("D,dtype", [(32, "bf16"), (32, "f32"), (8, "bf16"),
                                     (64, "f32"), (48, "bf16"),
                                     (256, "f32")])
@pytest.mark.parametrize("TQ", [8, 128])
def test_k8_lane_map_covers_rows_once(D, dtype, TQ):
    """Every real (batch, head, point, query) row of a banded level, and
    every channel of it, is taken by exactly one lane once, across segment
    boundaries (a warp's queries may straddle two) and the Q tail; no
    padding row is ever visited (the wrapper zeroes them)."""
    shapes = BUCKET_LEVELS["serving"]
    Q = sum(h * w for h, w in shapes)
    segs = segment_bounds(Q, shapes)
    es = ELEMENT_SIZE[dtype]
    BH = 2
    geom = msda_cuda.win_geometry(BH, Q, D, P, es)
    assert _accepted_win(geom, BH, Q, D, P, es)
    entry, first, Qp = _k8_entries(geom, BH, Q, D, P, segs, TQ)
    _assert_rows_once(entry, first, geom, BH, D, P, segs, TQ, Qp)


@pytest.mark.parametrize("Q,P_", [(1, 4), (7, 4), (129, 4), (33, 8), (5, 1),
                                  (40, 3)])
def test_k8_geometry_at_odd_shapes(Q, P_):
    """Few queries, a Q tail inside a warp, 8, 3 or 1 points, two segments
    with padding (at Q = 129 a warp's queries straddle their boundary),
    every alignment."""
    segs = ((0, Q - Q // 2), (Q - Q // 2, Q // 2)) if Q > 1 else ((0, 1),)
    for D in (6, 32, 96):
        for es in (4, 2):
            for align in (16, 8, 4, 2):
                if align < es:
                    continue
                geom = msda_cuda.win_geometry(3, Q, D, P_, es, align)
                assert _accepted_win(geom, 3, Q, D, P_, es)
                entry, first, Qp = _k8_entries(geom, 3, Q, D, P_, segs, 4)
                channel = (first[:, None] + np.arange(geom.vec)).reshape(-1)
                count = np.bincount(np.repeat(entry, geom.vec) * D + channel,
                                    minlength=3 * P_ * Qp * D)
                assert count.sum() == 3 * P_ * Q * D and count.max() == 1


@pytest.mark.parametrize("ns", [1, 7, 16, 31, 32, 33, 64, 100])
def test_value_hand_out_covers_every_pass_once(ns):
    """msda_bwd_value works out the geometry of a row's samples in groups of
    32, lane l sample base + l, and hands sample base + pp * spp + slot to
    the lanes of slot in the group's pass pp < min(lanes a sample, passes -
    base / spp): every pass of the geometry is walked once, from a lane of
    the warp that holds its sample."""
    for lps_log2 in range(6):
        spp = 32 >> lps_log2
        passes = -(-ns // spp)
        walked = []
        for base in range(0, ns, 32):
            for pp in range(min(1 << lps_log2, passes - base // spp)):
                walked.append(base // spp + pp)
                for slot in range(spp):
                    src = pp * spp + slot
                    assert src < 32 and base + src == walked[-1] * spp + slot
        assert walked == list(range(passes))


@pytest.mark.parametrize("P_", [1, 2, 3, 4, 8])
def test_value_level_and_point_without_division(P_):
    """msda_bwd_value finds a lane's (level, point) without a division where
    P divides the samples a pass takes: sample pass * spp + slot is point
    slot % P of level pass * (spp / P) + slot // P."""
    for lps_log2 in range(6):
        spp = 32 >> lps_log2
        if spp % P_:
            continue
        for slot in range(spp):
            for pass_ in range(6):
                s = pass_ * spp + slot
                assert divmod(s, P_) == (pass_ * (spp // P_) + slot // P_,
                                         slot % P_)


def _k6_lanes(geom, BH, Q, P_):
    """K6's lanes as the kernel walks them, over (warp, pass, chunk, lane):
    the (b * H + head) pair, the query, the point (with ``fold``; without,
    the lane walks all P of its query), the first channel, whether the lane
    has work and whether it stores its query's channels."""
    bh, q0 = _warps(geom, BH, Q)
    passes = -(-geom.passes // msda_cuda.UNROLL) * msda_cuda.UNROLL
    t = np.arange(passes)[:, None, None]
    chunk = np.arange(geom.chunks)[None, :, None]
    lane = np.arange(32)[None, None, :]
    lps, spp = geom.lanes_per_sample, geom.samples_per_pass
    slot, sub = lane >> geom.lps_log2, lane & (lps - 1)
    k = t * spp + slot
    qi = k // P_ if geom.fold else k
    p = k % P_ if geom.fold else np.zeros_like(k)
    group = chunk * lps + sub
    shape = (len(bh), passes, geom.chunks, 32)
    q = np.broadcast_to(q0[:, None, None, None] + qi[None], shape)
    live = np.broadcast_to((t < geom.passes) & (qi < geom.queries)
                           & (group < geom.groups), shape) & (q < Q)
    return dict(bh=np.broadcast_to(bh[:, None, None, None], shape), q=q,
                p=np.broadcast_to(p, shape), live=live,
                first=np.broadcast_to(group * geom.vec, shape),
                store=live & (np.broadcast_to(p, shape) == 0))


def _assert_k6_covers_once(geom, BH, Q, D, P_, segs, TQ):
    """Every real row and channel read once (each point of a query by its
    own lane with ``fold``, by the query's lane in turn without), no padding
    row; every (batch, head, query, channel) stored once, by the lane whose
    fold group holds exactly that query's P points."""
    m = _k6_lanes(geom, BH, Q, P_)
    live = m["live"]
    Qp = padded_starts(segs, TQ)[-1]
    qp = _padded(m["q"][live], segs, TQ)
    points = [m["p"][live]] if geom.fold else [
        np.full(qp.shape, pt) for pt in range(P_)]
    entry = np.concatenate([(m["bh"][live] * P_ + p) * Qp + qp
                            for p in points])
    first = np.concatenate([m["first"][live]] * len(points))
    _assert_rows_once(entry, first, geom, BH, D, P_, segs, TQ, Qp)
    store = m["store"]
    channel = (m["first"][store][:, None] + np.arange(geom.vec)).reshape(-1)
    out = (m["bh"][store] * Q + m["q"][store])
    count = np.bincount(np.repeat(out, geom.vec) * D + channel,
                        minlength=BH * Q * D)
    assert (count == 1).all()
    if geom.fold:
        # the fold's partners lane ^ (lps * j) hold the query's P points
        lps = geom.lanes_per_sample
        w, t, c, lane = np.nonzero(store)
        for j in range(P_):
            partner = lane ^ (lps * j)
            assert (m["q"][w, t, c, partner] == m["q"][w, t, c, lane]).all()
            assert (m["p"][w, t, c, partner] == j).all()
            assert m["live"][w, t, c, partner].all()


@pytest.mark.parametrize("D", [8, 32, 48, 64])
@pytest.mark.parametrize("dtype", sorted(WIN_ELEMENT_SIZE))
@pytest.mark.parametrize("TQ", [8, 128])
def test_k6_lane_map_covers_rows_once(D, dtype, TQ):
    """K6 at the served encoder call's queries (every segment of the
    serving bucket, a warp's queries straddling segment boundaries, the Q
    tail): every real row and channel read once, no padding row, every
    output channel stored once from a fold of exactly its query's points
    (or, where a pass holds fewer than P samples, by the lane that walks
    them); bfloat16 at D = 32 takes 8 channels a lane, 4 lanes a sample, 2
    queries x 4 points a pass, int8 16 channels and 2 lanes."""
    shapes = BUCKET_LEVELS["serving"]
    Q = sum(h * w for h, w in shapes)
    segs = segment_bounds(Q, shapes)
    es = WIN_ELEMENT_SIZE[dtype]
    geom = msda_cuda.win_geometry(2, Q, D, P, es, form="fwd")
    assert _accepted_win(geom, 2, Q, D, P, es, "fwd")
    assert geom.fold == int(geom.samples_per_pass % P == 0)
    if D == 32:
        assert (geom.vec, geom.lanes_per_sample) == {
            "f32": (4, 8), "bf16": (8, 4), "int8": (16, 2)}[dtype]
        assert geom.samples_per_pass == 32 // geom.lanes_per_sample
    _assert_k6_covers_once(geom, 2, Q, D, P, segs, TQ)


@pytest.mark.parametrize("Q,P_", [(1, 4), (7, 4), (129, 4), (33, 8), (5, 1),
                                  (40, 3)])
def test_k6_geometry_at_odd_shapes(Q, P_):
    """K6 with few queries, a Q tail, 8, 3 or 1 points (3: no fold, the
    lane walks its query's points; 8 at 4 lanes a sample and more), D of 6,
    32, 96 and 256 (a sample over the whole warp in two chunks: no fold),
    every value type and alignment."""
    segs = ((0, Q - Q // 2), (Q - Q // 2, Q // 2)) if Q > 1 else ((0, 1),)
    for D in (6, 32, 96, 256):
        for es in (4, 2, 1):
            for align in (16, 8, 4, 2, 1):
                if align < es:
                    continue
                geom = msda_cuda.win_geometry(3, Q, D, P_, es, align, "fwd")
                assert _accepted_win(geom, 3, Q, D, P_, es, "fwd")
                spp = geom.samples_per_pass
                assert geom.fold == int(spp % P_ == 0)
                _assert_k6_covers_once(geom, 3, Q, D, P_, segs, 4)


@pytest.mark.parametrize("P_,D,per_point", [
    (4, 8, True), (3, 8, True), (4, 256, True), (4, 8, False), (3, 8, False)],
    ids=["4-8", "3-8", "4-256", "tile-4-8", "tile-3-8"])
def test_k6_fold_sums_match_plain(P_, D, per_point):
    """K6's sums as its lanes make them: each point's float32 contribution
    (the plain version with the other points' weights zeroed), summed over
    the stored lane's fold group (or, without a fold, the lane's walk) in
    float64, against the plain version's float32 sum; with one band per
    tile (``tile-*``) the same for K5, which runs K6's kernel and launch."""
    shapes = ((21, 11), (11, 7))
    h, w = shapes[0]
    Q, B, H_ = sum(a * b for a, b in shapes), 2, 3
    rng = np.random.default_rng(0)
    value = torch.from_numpy(rng.standard_normal((B, Q, H_, D),
                                                 dtype=np.float32))
    loc_ref = []
    for hh, ww in shapes:
        yy, xx = np.meshgrid(np.arange(hh), np.arange(ww), indexing="ij")
        loc_ref.append(np.stack([(xx.ravel() + 0.5) / ww,
                                 (yy.ravel() + 0.5) / hh], -1))
    loc = np.concatenate(loc_ref)[None, :, None, None, None, :] + (
        rng.uniform(-3, 3, (B, Q, H_, 2, P_, 2)) / np.array([w, h]))
    aw = rng.random((B, Q, H_, 2, P_)).astype(np.float32)
    locT, awT = msda.rows_t(torch.from_numpy(loc.astype(np.float32)),
                            torch.from_numpy(aw))
    segs = segment_bounds(Q, shapes)
    bidx, ix, iy_band, _, aw_eff, _, _ = msda.win_level_rows(
        locT, awT, 0, h, w, 8, segs, D, per_point)
    assert bidx.dim() == (4 if per_point else 3)
    args = (value[:, :h * w], bidx, ix, iy_band)
    ref = msda.msda_fwd_win_plain(*args, aw_eff, h, w, 8, segs, Q)
    parts = []
    for p in range(P_):
        one = torch.zeros_like(aw_eff)
        one[:, :, p] = aw_eff[:, :, p]
        parts.append(msda.msda_fwd_win_plain(*args, one, h, w, 8, segs, Q)
                     .reshape(B, Q, H_, D).double().numpy())
    geom = msda_cuda.win_geometry(B * H_, Q, D, P_, 4, form="fwd")
    assert geom.fold == int(P_ == 4 and D == 8)
    m = _k6_lanes(geom, B * H_, Q, P_)
    got = np.zeros((B, Q, H_, D))
    w_, t, c, lane = np.nonzero(m["store"])
    lps = geom.lanes_per_sample
    for j in range(P_):
        partner = lane ^ (lps * j) if geom.fold else lane
        pt = m["p"][w_, t, c, partner] if geom.fold else np.full(lane.shape, j)
        bh, q = m["bh"][w_, t, c, partner], m["q"][w_, t, c, partner]
        first = m["first"][w_, t, c, lane]
        for v in range(geom.vec):
            got[bh // H_, q, bh % H_, first + v] += np.stack(parts)[
                pt, bh // H_, q, bh % H_, first + v]
    np.testing.assert_allclose(got.reshape(B, Q, H_ * D), ref.numpy(),
                               rtol=1e-5, atol=1e-6)


def _k10_lanes(geom, BH, Q, P_):
    """K10's adds as the kernel walks them: lane ``l`` works out sample
    ``base + l`` of its warp, and in pass ``pp < min(lanes a sample, passes
    - base / spp)`` of that group the lanes of slot ``s`` take sample ``base
    + pp * spp + s`` from lane ``pp * spp + s``. Returns (b * H + head,
    query, point, first channel) of every (lane, pass, chunk) with work,
    each taken from the lane that works its sample out."""
    bh, q0 = _warps(geom, BH, Q)
    lps, spp = geom.lanes_per_sample, geom.samples_per_pass
    ns = geom.queries * P_
    out = []
    for base in range(0, ns, 32):
        for pp in range(min(lps, geom.passes - base // spp)):
            for lane in range(32):
                slot, sub = lane >> geom.lps_log2, lane & (lps - 1)
                src = pp * spp + slot
                assert src < 32
                k = base + src  # worked out on lane src
                if k >= ns:
                    continue
                qi, p = divmod(k, P_)
                for chunk in range(geom.chunks):
                    group = chunk * lps + sub
                    if group >= geom.groups:
                        break
                    q = q0 + qi
                    keep = q < Q
                    out.append((bh[keep], q[keep], np.full(keep.sum(), p),
                                np.full(keep.sum(), group * geom.vec)))
    return [np.concatenate(a) for a in zip(*out)]


@pytest.mark.parametrize("D", [8, 32, 48, 64])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("TQ", [8, 128])
def test_k10_lane_map_covers_rows_once(D, dtype, TQ):
    """K10 at the adaptation's encoder call (batch 4, 8 heads: every
    segment of the 608x1008 bucket, a warp's queries straddling segment
    boundaries, the Q tail): every real row's every channel added once,
    no padding row; at most four float32 channels a lane, 32 / P queries a
    warp, one sample a lane for the hand-out."""
    shapes = BUCKET_LEVELS["serving"]
    Q = sum(h * w for h, w in shapes)
    segs = segment_bounds(Q, shapes)
    BH = 4 * H
    geom = msda_cuda.win_geometry(BH, Q, D, P, ELEMENT_SIZE[dtype],
                                  form="value")
    assert _accepted_win(geom, BH, Q, D, P, 4, "value")
    assert geom.vec <= 4 and geom.queries * P == 32 and not geom.fold
    bh, q, p, first = _k10_lanes(geom, BH, Q, P)
    Qp = padded_starts(segs, TQ)[-1]
    _assert_rows_once((bh * P + p) * Qp + _padded(q, segs, TQ), first, geom,
                      BH, D, P, segs, TQ, Qp)


@pytest.mark.parametrize("Q,P_", [(1, 4), (7, 4), (129, 4), (33, 8), (5, 1),
                                  (40, 3), (9, 40)])
def test_k10_geometry_at_odd_shapes(Q, P_):
    """K10 with few queries, a Q tail, 8, 3, 1 or 40 points (more samples a
    query than lanes: the hand-out in groups of 32), D of 6, 32 and 96,
    every alignment of g and of the gradient slice."""
    segs = ((0, Q - Q // 2), (Q - Q // 2, Q // 2)) if Q > 1 else ((0, 1),)
    for D in (6, 32, 96):
        for align in (16, 8, 4):
            geom = msda_cuda.win_geometry(3, Q, D, P_, 2, align, "value")
            assert _accepted_win(geom, 3, Q, D, P_, 4, "value")
            assert geom.vec * 4 <= align
            bh, q, p, first = _k10_lanes(geom, 3, Q, P_)
            Qp = padded_starts(segs, 4)[-1]
            entry = (bh * P_ + p) * Qp + _padded(q, segs, 4)
            channel = (first[:, None] + np.arange(geom.vec)).reshape(-1)
            count = np.bincount(np.repeat(entry, geom.vec) * D + channel,
                                minlength=3 * P_ * Qp * D)
            assert count.sum() == 3 * P_ * Q * D and count.max() == 1


def test_win_geometry_refuses_what_misses_work():
    """The Python model of win_geometry_ok refuses a geometry whose index
    math would miss or repeat work, or a form it does not fit (a fold
    outside K6, a fold where P does not divide a pass, K10 above four
    float32 channels)."""
    Q = 100
    fwd = msda_cuda.win_geometry(2, Q, 32, 4, 2, form="fwd")
    value = msda_cuda.win_geometry(2, Q, 32, 4, 2, form="value")
    rows = msda_cuda.win_geometry(2, Q, 32, 4, 2)
    assert _accepted_win(fwd, 2, Q, 32, 4, 2, "fwd")
    bad = [(replace(fwd, passes=fwd.passes - 1), "fwd", 4),
           (replace(fwd, blocks=fwd.blocks + 1), "fwd", 4),
           (replace(fwd, fold=0, passes=0), "fwd", 4),
           (fwd, "fwd", 3),
           (replace(rows, fold=1), "rows", 4),
           (replace(value, fold=1), "value", 4),
           (replace(value, vec=8, groups=4, lps_log2=2), "value", 4)]
    for geom, form, P_ in bad:
        es = 4 if form == "value" else 2
        assert not _accepted_win(geom, 2, Q, 32, P_, es, form)
    with pytest.raises(ValueError, match="form must be"):
        msda_cuda.win_geometry(2, Q, 32, 4, 2, form="tile")


# --------------------------------------------------------------------------
# K4 (msda_fwd_q): several short int8 rows a warp, each sample's geometry
# worked out on one lane and handed out
# --------------------------------------------------------------------------


def _accepted_q(geom, rows, D, ns):
    """msda_fwd_q.cu's ``q_geometry_ok`` in Python (a card test in
    tests/test_torch_cuda.py holds the C check to this one)."""
    lps = geom.lanes_per_sample
    if not (0 <= geom.lps_log2 <= 5 and 0 <= geom.slots_log2
            <= 5 - geom.lps_log2):
        return False
    per_block = geom.threads // 32 * geom.rows_per_warp
    return (1 <= geom.vec <= 16 and geom.vec & (geom.vec - 1) == 0
            and geom.groups * geom.vec == D
            and geom.chunks * lps >= geom.groups
            and (geom.chunks - 1) * lps < geom.groups
            and geom.passes >= 0 and geom.passes << geom.slots_log2 >= ns
            and 32 <= geom.threads <= 256 and geom.threads % 32 == 0
            and geom.blocks >= 1 and geom.blocks * per_block >= rows
            and (geom.blocks - 1) * per_block < rows)


def _k4_lanes(geom, rows, ns):
    """K4's reads as the kernel walks them, over (warp, chunk, pass, lane):
    the row and sample each lane reads, from the lane that works the
    sample out (``src``, which must hold the same row), the first channel,
    and whether the lane has work. Returns a dict of flat arrays over the
    lanes with work, and the stores (row, first channel) of the lanes of
    each row's first slot."""
    lps, spp = geom.lanes_per_sample, geom.samples_per_pass
    slots, rpw = geom.row_slots, geom.rows_per_warp
    first = np.arange(geom.blocks * geom.threads // 32) * rpw
    first = first[first < rows][:, None]
    lane = np.arange(32)[None, :]
    slot, sub = lane >> geom.lps_log2, lane & (lps - 1)
    row = first + (slot >> geom.slots_log2)
    reads = {k: [] for k in ("row", "j", "first")}
    for c in range(geom.chunks):
        group = c * lps + sub
        on = (row < rows) & (group < geom.groups)
        for t0 in range(0, geom.passes, lps):
            for u in range(min(lps, geom.passes - t0)):
                src = u * spp + slot
                assert (src < 32).all()
                # what lane src works out: slot src % spp of pass src / spp
                mine_slot = src & (spp - 1)
                mine_row = first + (mine_slot >> geom.slots_log2)
                j = ((t0 << geom.slots_log2)
                     + ((src >> (5 - geom.lps_log2)) << geom.slots_log2)
                     + (mine_slot & (slots - 1)))
                valid = (mine_row < rows) & (j < ns)
                assert (mine_row == row).all()  # the hand-out's right row
                work = np.broadcast_to(on & valid, row.shape)
                reads["row"].append(np.broadcast_to(row, work.shape)[work])
                reads["j"].append(np.broadcast_to(j, work.shape)[work])
                reads["first"].append(
                    np.broadcast_to(group * geom.vec, work.shape)[work])
    reads = {k: np.concatenate(v) for k, v in reads.items()}
    stores = []
    for c in range(geom.chunks):
        group = c * lps + sub
        store = ((row < rows) & (group < geom.groups)
                 & ((slot & (slots - 1)) == 0))
        store = np.broadcast_to(store, row.shape)
        stores.append((np.broadcast_to(row, store.shape)[store],
                       np.broadcast_to(group * geom.vec, store.shape)[store]))
    return reads, tuple(np.concatenate(a) for a in zip(*stores))


def _assert_k4_covers_once(geom, rows, D, ns):
    """Every (row, sample, channel) read once, every (row, channel) stored
    once, and a row's fold partners hold the same row."""
    reads, (srow, sfirst) = _k4_lanes(geom, rows, ns)
    groups = geom.groups
    count = np.bincount((reads["row"] * ns + reads["j"]) * groups
                        + reads["first"] // geom.vec,
                        minlength=rows * ns * groups)
    assert count.shape == (rows * ns * groups,) and (count == 1).all()
    count = np.bincount(srow * groups + sfirst // geom.vec,
                        minlength=rows * groups)
    assert count.shape == (rows * groups,) and (count == 1).all()
    assert (reads["first"] % geom.vec == 0).all() and D % geom.vec == 0
    # the fold's partners lane ^ off (off = lps, 2 lps, ... below
    # lps * row_slots) lie in the same row and channel group
    lps = geom.lanes_per_sample
    lane = np.arange(32)
    off = lps
    while off < lps * geom.row_slots:
        partner = lane ^ off
        assert ((lane >> geom.lps_log2 >> geom.slots_log2)
                == (partner >> geom.lps_log2 >> geom.slots_log2)).all()
        assert ((lane & (lps - 1)) == (partner & (lps - 1))).all()
        off <<= 1


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("call", ["encoder_served", "encoder", "decoder"])
def test_k4_lane_map_covers_the_served_calls_once(call, B):
    """K4 at the served calls of the 608x1008 bucket (the served encoder
    call on its one exact level, 4 samples a row; the int8 encoder call on
    every level and the decoder call, 16): every (row, sample, channel
    group) read once, from the lane that works the sample out, every
    output channel stored once; at D = 32 a lane loads 16 channels, a
    4-sample row takes 2 slots (8 rows a warp, all 4 samples of each in
    flight over two passes) and a 16-sample row 8 (2 rows a warp)."""
    S = BUCKET_S["serving"]
    Q = 200 if call == "decoder" else S
    ns = P if call == "encoder_served" else L * P
    geom = msda_cuda.q_geometry(B * Q * H, 32, ns)
    assert _accepted_q(geom, B * Q * H, 32, ns)
    assert geom.vec == msda_cuda.Q_VEC_BYTES == 16
    assert geom.passes == msda_cuda.UNROLL
    assert geom.rows_per_warp == {4: 8, 16: 2}[ns]
    _assert_k4_covers_once(geom, B * Q * H, 32, ns)


@pytest.mark.parametrize("D", [8, 16, 32, 64, 48])
@pytest.mark.parametrize("ns,rows", [(4, 1), (4, 203), (16, 203), (3, 77),
                                     (12, 50), (1, 9), (40, 31)])
def test_k4_geometry_at_odd_shapes(D, ns, rows):
    """Head dims 8-64, rows of 4 and 16 samples, 3 and 12 (P or a level
    subset that does not divide a pass), 1 and 40 (more samples than a
    pass: the row's slots are the whole pass), row counts that are not a
    multiple of a warp's rows, every alignment of the values, and corner
    loads of at most 8 bytes."""
    for align in (16, 8, 4, 2, 1):
        for cap in (16, 8):
            msda_cuda.q_geometry.cache_clear()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(msda_cuda, "Q_VEC_BYTES", cap)
                geom = msda_cuda.q_geometry(rows, D, ns, align)
            assert geom.vec <= min(align, cap)
            assert _accepted_q(geom, rows, D, ns)
            _assert_k4_covers_once(geom, rows, D, ns)
    msda_cuda.q_geometry.cache_clear()


@pytest.mark.parametrize("levels,D,P_", [((0, 1, 2), 8, 4), ((2,), 16, 4),
                                         ((1,), 8, 3), ((0, 2), 64, 2)])
def test_k4_fold_sums_match_plain(levels, D, P_):
    """K4's sums as its lanes make them: each sample's float32 contribution
    (``msda_fwd_q_plain`` with the other samples' weights zeroed), summed
    in float64 over the lane's passes and its row's fold partners, against
    ``msda_fwd_q_plain``'s float32 sum; a level subset, P that does not
    divide a pass, a batch of 2, a level whose stage 1 contracts y."""
    shapes = ((9, 13), (3, 140), (4, 6))  # level 1: w > 128 >= h, flipped
    B, Q, H_ = 2, 11, 3
    S = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(3)
    value = torch.from_numpy(rng.standard_normal((B, S, H_, D),
                                                 dtype=np.float32))
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (B, Q, H_, 3, P_, 2))
                           .astype(np.float32))
    aw = torch.from_numpy(rng.random((B, Q, H_, 3, P_)).astype(np.float32))
    vq, scale = msda.quantize_levels(value, shapes)
    ref = msda.msda_fwd_q_plain(vq, scale, shapes, loc, aw, levels)
    ns = len(levels) * P_
    parts = np.zeros((ns, B, Q, H_, D))
    for j in range(ns):
        one = torch.zeros_like(aw)
        k, p = divmod(j, P_)
        one[:, :, :, levels[k], p] = aw[:, :, :, levels[k], p]
        parts[j] = msda.msda_fwd_q_plain(vq, scale, shapes, loc, one,
                                         levels).reshape(B, Q, H_, D).numpy()
    rows = B * Q * H_
    parts = parts.reshape(ns, rows, D)
    geom = msda_cuda.q_geometry(rows, D, ns)
    reads, _ = _k4_lanes(geom, rows, ns)
    got = np.zeros((rows, D))
    for v in range(geom.vec):
        np.add.at(got, (reads["row"], reads["first"] + v),
                  parts[reads["j"], reads["row"], reads["first"] + v])
    np.testing.assert_allclose(got.reshape(B, Q, H_ * D), ref.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_k4_geometry_refuses_what_misses_work():
    """The Python model of q_geometry_ok refuses a geometry whose index math
    would miss or repeat work."""
    rows, D, ns = 1000, 32, 4
    geom = msda_cuda.q_geometry(rows, D, ns)
    assert _accepted_q(geom, rows, D, ns)
    bad = [replace(geom, passes=geom.passes - 1),
           replace(geom, blocks=geom.blocks + 1),
           replace(geom, blocks=geom.blocks - 1),
           replace(geom, slots_log2=5),
           replace(geom, slots_log2=geom.slots_log2 - 1),
           replace(geom, vec=32, groups=1),
           replace(geom, groups=geom.groups + 1),
           replace(geom, lps_log2=geom.lps_log2 + 1),
           replace(geom, threads=512)]
    for g in bad:
        assert not _accepted_q(g, rows, D, ns), g


# --------------------------------------------------------------------------
# K5, K7 and K9 through K6's, K8's and K10's kernels: the band table's
# strides
# --------------------------------------------------------------------------


def _band_entry(bh, p, qp, P_, T, TQ, per_point):
    """The band table entry a banded kernel reads for (b * H + head, point,
    padded row), as msda_band.cuh's band_entry writes it: bidx[bh *
    bh_stride + p * p_stride + qp / TQ] with strides P * T and T for the
    point forms' [B, H, P, T] table (K6, K8, K10), T and 0 for the tile
    forms' [B, H, T] (K5, K7, K9)."""
    p_stride = T if per_point else 0
    bh_stride = P_ * T if per_point else T
    return bh * bh_stride + p * p_stride + qp // TQ


@pytest.mark.parametrize("per_point", [False, True], ids=["K7", "K8"])
@pytest.mark.parametrize("D,dtype", [(32, "bf16"), (32, "f32"), (8, "bf16"),
                                     (64, "f32")])
@pytest.mark.parametrize("TQ", [8, 128])
def test_rows_kernel_band_lookup(per_point, D, dtype, TQ):
    """Under K8's lane map (K7 takes the same launch) every (query, point)
    of the served encoder call's segments reads its tile's band: bidx[b, h,
    tile] for K7, whatever the point, and bidx[b, h, p, tile] for K8; the
    lookup stays inside the table."""
    shapes = BUCKET_LEVELS["serving"]
    Q = sum(h * w for h, w in shapes)
    segs = segment_bounds(Q, shapes)
    B, H_ = 2, 3
    geom = msda_cuda.win_geometry(B * H_, Q, D, P, ELEMENT_SIZE[dtype])
    entry, _, Qp = _k8_entries(geom, B * H_, Q, D, P, segs, TQ)
    T = Qp // TQ
    bh, rest = divmod(entry, P * Qp)
    p, qp = divmod(rest, Qp)
    rng = np.random.default_rng(int(per_point))
    shape = (B, H_, P, T) if per_point else (B, H_, T)
    bidx = rng.integers(0, 100, shape)
    got = bidx.reshape(-1)[_band_entry(bh, p, qp, P, T, TQ, per_point)]
    b, h = divmod(bh, H_)
    want = (bidx[b, h, p, qp // TQ] if per_point
            else bidx[b, h, qp // TQ])
    assert (got == want).all()
    # K7's table broadcast over the points is K8's table for the same bands
    if not per_point:
        wide = np.broadcast_to(bidx[:, :, None, :], (B, H_, P, T))
        assert (wide.reshape(-1)[_band_entry(bh, p, qp, P, T, TQ, True)]
                == got).all()


def _band_readers(form, geom, BH, Q, P_, segs, TQ):
    """(b * H + head, point, padded row) of every sample a banded kernel
    looks its band up for, under the lane map of ``form``: K6's lanes (with
    ``fold`` each lane's point, without it the lane's walk over its query's
    points) or the lanes of K10 that work a sample out."""
    if form == "fwd":
        m = _k6_lanes(geom, BH, Q, P_)
        live = m["live"]
        points = [m["p"][live]] if geom.fold else [
            np.full(live.sum(), pt) for pt in range(P_)]
        bh = np.concatenate([m["bh"][live]] * len(points))
        q = np.concatenate([m["q"][live]] * len(points))
        p = np.concatenate(points)
    else:
        bh, q, p, _ = _k10_lanes(geom, BH, Q, P_)
    return bh, p, _padded(q, segs, TQ)


@pytest.mark.parametrize("per_point", [False, True], ids=["tile", "point"])
@pytest.mark.parametrize("form,D,dtype", [
    ("fwd", 32, "bf16"), ("fwd", 32, "int8"), ("fwd", 32, "f32"),
    ("fwd", 256, "f32"), ("value", 32, "bf16"), ("value", 8, "f32"),
    ("value", 64, "f32")])
@pytest.mark.parametrize("TQ", [8, 128])
def test_fwd_and_value_kernels_band_lookup(form, D, dtype, per_point, TQ):
    """Under K6's lane map (K5 takes the same launch; a fold, or the walk
    over a query's points at D = 256) and K10's (K9 likewise), every (query,
    point) of the served encoder call's segments reads its tile's band:
    bidx[b, h, tile] for the tile form, whatever the point, and bidx[b, h,
    p, tile] for the point form; the lookup stays inside the table, and the
    tile table broadcast over the points gives the point form the same
    bands."""
    shapes = BUCKET_LEVELS["serving"]
    Q = sum(h * w for h, w in shapes)
    segs = segment_bounds(Q, shapes)
    B, H_ = 2, 3
    geom = msda_cuda.win_geometry(B * H_, Q, D, P, WIN_ELEMENT_SIZE[dtype],
                                  form=form)
    assert geom.fold == int(form == "fwd" and D < 256)
    bh, p, qp = _band_readers(form, geom, B * H_, Q, P, segs, TQ)
    Qp = padded_starts(segs, TQ)[-1]
    T = Qp // TQ
    # every real (batch, head, point, query) looks its band up
    seen = np.zeros((B * H_, P, Qp), dtype=bool)
    seen[bh, p, qp] = True
    assert seen.sum() == B * H_ * P * Q
    rng = np.random.default_rng(int(per_point))
    shape = (B, H_, P, T) if per_point else (B, H_, T)
    bidx = rng.integers(0, 100, shape)
    entry = _band_entry(bh, p, qp, P, T, TQ, per_point)
    assert 0 <= entry.min() and entry.max() < bidx.size
    got = bidx.reshape(-1)[entry]
    b, h = divmod(bh, H_)
    want = (bidx[b, h, p, qp // TQ] if per_point
            else bidx[b, h, qp // TQ])
    assert (got == want).all()
    if not per_point:
        wide = np.broadcast_to(bidx[:, :, None, :], (B, H_, P, T))
        assert (wide.reshape(-1)[_band_entry(bh, p, qp, P, T, TQ, True)]
                == got).all()
