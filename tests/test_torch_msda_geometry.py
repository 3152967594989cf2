"""The launch geometry of the exact forward (K1, msda_fwd) and the backward
row kernel (K2, msda_bwd_rows), on the CPU.

``msda_cuda.launch_geometry`` decides how a warp's lanes split over
(sample, channel group), the vector width of a corner load, the passes,
the rows a warp walks, whether a row's locations are handed out by
shuffles, and the block and grid. The kernels cannot run here, so these
tests emulate their index mapping in numpy, as the sources write it
(block, warp, row step, lane, pass, chunk -> batch, query, head, sample,
channel), and check that every (row, sample, channel) is covered exactly
once, that the sources' own geometry check would accept the launch, and
that the geometry depends on the row count B*Q*H only.
"""

import numpy as np
import pytest
import torch

from egtr_tpu_torch.ops import msda_cuda

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
    """msda_fwd.cu and msda_bwd.cu include msda_geom.cuh: an edited header
    builds both libraries anew, under new names."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("msda_fwd.cu", "msda_bwd.cu", "msda_geom.cuh"):
        (csrc / name).write_text((msda_cuda._CSRC / name).read_text())
    for src in ("msda_fwd.cu", "msda_bwd.cu"):
        assert '#include "msda_geom.cuh"' in (csrc / src).read_text()
    monkeypatch.setattr(msda_cuda, "_CSRC", csrc)
    monkeypatch.setattr(msda_cuda, "SOURCE", csrc / "msda_fwd.cu")
    monkeypatch.setattr(msda_cuda, "SOURCE_BWD", csrc / "msda_bwd.cu")
    before = {n: msda_cuda.library_path(n) for n in ("msda_fwd", "msda_bwd")}
    with open(csrc / "msda_geom.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: msda_cuda.library_path(n) for n in ("msda_fwd", "msda_bwd")}
    assert all(before[n] != after[n] for n in before)
