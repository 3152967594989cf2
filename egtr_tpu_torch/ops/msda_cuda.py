"""Wrappers, build step and launch counters of the hand-written MSDA kernels
and of the matcher's assignment kernel.

Eleven kernels, in six sources under ``egtr_tpu_torch/csrc``, replace the JAX
package's Pallas kernels:

- ``msda_fwd`` (``msda_fwd.cu``) replaces ``msda_pallas.py:_fwd_kernel``;
- ``msda_bwd_rows`` (``msda_bwd.cu``) replaces ``_bwd_rows_kernel``: the
  gradients of the sampling locations and the attention weights;
  both lay a warp's lanes over (sample, channel group) as
  :func:`launch_geometry` says;
- ``msda_bwd_value`` (``msda_bwd.cu``) replaces ``_bwd_dvtt_kernel``: the
  gradient of the values, summed over the queries with float32 atomics,
  the levels a block hits densely in its own shared-memory copy first, as
  :func:`value_geometry` says;
- ``msda_fwd_q`` (``msda_fwd_q.cu``) replaces the int8 branch of
  ``_fwd_body``: the forward with an integer stage 1, several short rows a
  warp as :func:`q_geometry` says;
- ``msda_fwd_win`` and ``msda_fwd_win_pp`` (``msda_fwd_win.cu``) replace
  ``_fwd_kernel_win`` and ``_fwd_kernel_win_pp``: one banded level with one
  band per query tile, or one per (sampling point, tile), each with float32,
  bfloat16 or int8 values;
- ``msda_bwd_win_rows`` and ``msda_bwd_win_rows_pp`` (``msda_bwd_win.cu``)
  replace ``_bwd_rows_kernel_win`` and ``_bwd_rows_kernel_win_pp``: the row
  gradients of one banded level;
- ``msda_bwd_win_value`` and ``msda_bwd_win_value_pp`` (``msda_bwd_win.cu``)
  replace ``_bwd_dvtt_kernel_win`` and ``_bwd_dvtt_kernel_win_pp``: the value
  gradient of one banded level, with float32 vector reductions, added into
  the caller's slice of the layer's gradient where it is given one;
- each of these pairs is one kernel whose band table has a point stride (0
  for the tile form), and its lanes lie over (query, point, channel group)
  as :func:`win_geometry` says;
- ``msda_fwd_bp`` replaces ``_fwd_kernel_bp`` (the forward with all
  sampling points in one stage, ``EGTR_MSDA_BATCH_P=1``): its bfloat16 form
  runs K1's kernel, its int8 form K4's, its float32 form its own
  (``msda_fwd_bp.cu``), as ``BP_ROUTES`` says.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``. The libraries are built
at first use from the sources in the checkout, all ``nvcc`` processes started
together, into ``build/`` at the repository root, each under a name keyed by
a hash of its source, the headers beside it (``msda_geom.cuh``,
``msda_band.cuh``) and the compiler flags, so an edited source or header is
rebuilt.

There is no fallback: if ``nvcc`` is missing or a build fails, a call on
CUDA tensors raises. The plain versions (``msda.ms_deform_attn_plain``,
``msda.ms_deform_attn_plain_bwd``, ``msda.msda_fwd_q_plain``,
``msda.msda_fwd_win_plain``, ``msda.msda_bwd_win_plain``,
``msda.msda_fwd_bp_plain``) run for CPU
tensors, or where the caller asks for them by name, through the dispatch in
``msda.ms_deform_attn``.

One more kernel shares the build and the counters: ``lsap`` (``lsap.cu``),
the Hungarian matcher's assignment, which replaces the JAX package's in-jit
solver ``egtr_tpu/ops/matcher.py:_lsa_single`` (device code outside Pallas);
``matcher.hungarian_match`` launches it on CUDA tensors and runs its plain
version ``matcher.lsap_plain`` on CPU tensors.

And one more: ``frozen_bn`` (``frozen_bn.cu``), the ResNet trunk's frozen-BN
epilogue (the norm's affine, the residual, itself through a norm or not,
and the ReLU) in one pass over a channels_last map, which replaces the
chain of PyTorch kernels that ``models/backbone.py``'s expression launches
(XLA fuses it for the JAX package). ``backbone.frozen_bn_act`` launches it
on a CUDA map with grad mode off and runs the expression otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import astuple, dataclass
from functools import cached_property, lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .msda import _orient, level_starts
from .msda_window import Segments, padded_starts

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = _CSRC / "msda_fwd.cu"
SOURCE_BWD = _CSRC / "msda_bwd.cu"
SOURCE_Q = _CSRC / "msda_fwd_q.cu"
SOURCE_WIN = _CSRC / "msda_fwd_win.cu"
SOURCE_BWD_WIN = _CSRC / "msda_bwd_win.cu"
SOURCE_BP = _CSRC / "msda_fwd_bp.cu"
SOURCE_LSAP = _CSRC / "lsap.cu"
SOURCE_FROZEN_BN = _CSRC / "frozen_bn.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_LEVELS = 8  # MSDA_MAX_LEVELS in the sources
MAX_SEGMENTS = 8  # MSDA_MAX_SEGMENTS in msda_band.cuh

# The kernels, by the name of their wrapper (the forms of a kernel, float or
# int8, share its name).
KERNELS = ("msda_fwd", "msda_bwd_rows", "msda_bwd_value", "msda_fwd_q",
           "msda_fwd_win", "msda_fwd_win_pp", "msda_bwd_win_rows",
           "msda_bwd_win_rows_pp", "msda_bwd_win_value",
           "msda_bwd_win_value_pp", "msda_fwd_bp")

# The matcher's assignment kernel, counted beside the MSDA kernels.
MATCHER_KERNELS = ("lsap",)

# The trunk's frozen-BN epilogue, counted beside them.
BACKBONE_KERNELS = ("frozen_bn",)

# Kernel launches since the counts were last set to 0 (reset_launches), by
# kernel; a wrapper raises its kernel's count by one per launch
# (``_count``) and nowhere else. A call made while a CUDA graph is being
# captured (utils/aot.py) launches nothing: it records the kernel into the
# graph, whose replays launch it without the wrapper, so these counts are
# the eager launches only; chip_smoke.py counts the replays' from a
# torch.profiler trace of the card.
launches: Dict[str, int] = dict.fromkeys(
    KERNELS + MATCHER_KERNELS + BACKBONE_KERNELS, 0)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _count(name: str, launched: bool = True) -> None:
    """One launch of kernel ``name`` where the wrapper ``launched`` it on
    a stream that is not being captured."""
    if launched and not torch.cuda.is_current_stream_capturing():
        launches[name] += 1


_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def sources() -> Dict[str, Path]:
    """Library name -> its source."""
    return {"msda_fwd": SOURCE, "msda_bwd": SOURCE_BWD,
            "msda_fwd_q": SOURCE_Q, "msda_fwd_win": SOURCE_WIN,
            "msda_bwd_win": SOURCE_BWD_WIN, "msda_fwd_bp": SOURCE_BP,
            "lsap": SOURCE_LSAP, "frozen_bn": SOURCE_FROZEN_BN}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and in {cuda_home}/bin): the "
            "MSDA CUDA kernel cannot be built")
    return nvcc


def library_path(name: str = "msda_fwd") -> Path:
    """Where a built library lives: keyed by its source, the headers beside
    it and the flags."""
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    key = hashlib.sha256(sources()[name].read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_command(nvcc: str, out: Path, name: str = "msda_fwd") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(sources()[name])]


def build() -> Dict[str, Path]:
    """Compile every library whose source has not been built yet, all
    compilers started together. Returns library name -> path."""
    paths = {name: library_path(name) for name in sources()}
    missing = [name for name, path in paths.items() if not path.exists()]
    if not missing:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile to a private name, then rename: a process building at the
    # same time never loads a half-written library
    procs, tmps = {}, {}
    try:
        for name in missing:
            fd, tmps[name] = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = subprocess.Popen(
                build_command(nvcc, Path(tmps[name]), name),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        failed = []
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {sources()[name]} "
                              f"(exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmps[name], paths[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in tmps.values():
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths


# Launch geometry of msda_fwd and msda_bwd_rows. A row is one (batch, query,
# head); its samples are its n*P (level, point) pairs.
WARPS_PER_BLOCK = 8
UNROLL = 2  # MSDA_UNROLL in the sources: passes whose loads go together
# msda_fwd: a warp walks ROWS_PER_WARP rows where the call has at least
# MIN_ROWS_TO_WALK rows (16 blocks an SM of the card's 132 at one row a
# warp), else one. Measured on the H100: two rows a warp beat one, four and
# eight at the encoder calls (101,904 and 178,584 rows); one beat two at the
# decoder calls (1,600 and 3,200 rows).
ROWS_PER_WARP = 2
MIN_ROWS_TO_WALK = 132 * 16 * WARPS_PER_BLOCK


class _Lanes:
    """What the launch geometries share: lane ``l`` of a warp takes sample
    slot ``l >> lps_log2`` and channel group ``l & (lanes_per_sample -
    1)``, and the fields go to the kernel as an int array in their order."""

    @property
    def lanes_per_sample(self) -> int:
        return 1 << self.lps_log2

    @property
    def samples_per_pass(self) -> int:
        return 32 >> self.lps_log2

    @cached_property
    def c_array(self):
        """The fields as the kernel's geometry struct takes them, in their
        order (a launch only reads them)."""
        values = astuple(self)
        return (ctypes.c_int * len(values))(*values)


def lane_split(D: int, vec: int) -> Tuple[int, int, int]:
    """(groups, lps_log2, chunks): D's groups of ``vec`` channels, spread
    over up to 32 lanes a sample, in chunks where there are more."""
    groups = D // vec
    lps_log2 = min(5, (groups - 1).bit_length())
    return groups, lps_log2, -(-groups // (1 << lps_log2))


@dataclass(frozen=True)
class Geometry(_Lanes):
    """How msda_fwd and msda_bwd_rows lay a row's work on a warp's lanes.

    Lane ``l`` of a warp takes sample slot ``l >> lps_log2`` and channel
    group ``l & (lanes_per_sample - 1)`` (plus ``chunk * lanes_per_sample``
    over the chunks); in pass ``t`` its sample is ``t * samples_per_pass +
    slot``. Warp ``w`` of block ``k`` walks rows ``k * warps * rows_per_warp
    + j * warps + w`` for ``j < rows_per_warp`` (``warps = threads // 32``).
    A group is ``vec`` consecutive channels, read with one vector load. With
    ``handout`` a row's locations and weights are read one per lane and
    handed out with shuffles. msda_bwd_rows takes one row a warp and no
    hand-out."""

    vec: int            # channels per lane load
    lps_log2: int       # log2 of the lanes per sample
    groups: int         # D / vec channel groups
    chunks: int         # ceil(groups / lanes_per_sample)
    passes: int         # ceil(n * P / samples_per_pass)
    handout: int        # 1: a row's L*P*2 locations fit one per lane
    rows_per_warp: int
    threads: int
    blocks: int



def rows_per_warp_for(rows: int) -> int:
    """Rows a warp of msda_fwd walks: a function of the row count B*Q*H
    alone. Each row is summed by one warp in one order, so this moves no
    bit of the result."""
    return ROWS_PER_WARP if rows >= MIN_ROWS_TO_WALK else 1


def vector_width(D: int, element_size: int, alignment: int) -> int:
    """Channels per lane load: the widest load of at most 16 bytes that D
    and the pointers' alignment (bytes) allow."""
    vec = 16 // element_size
    while vec > 1 and (D % vec or alignment % (vec * element_size)):
        vec //= 2
    return vec


def pointer_alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides every data pointer."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


@lru_cache(maxsize=256)
def launch_geometry(rows: int, D: int, n_samples: int, row_samples: int,
                    element_size: int, alignment: int = 16,
                    walk: bool = True) -> Geometry:
    """The launch for ``rows`` = B*Q*H rows of ``n_samples`` summed samples
    (the levels taken times P), each row holding ``row_samples`` = L*P
    entries in the location and weight tensors: msda_fwd's, whose warps
    walk rows and take a row's entries by hand-out, or with ``walk=False``
    msda_bwd_rows', one row a warp that reads its own."""
    vec = vector_width(D, element_size, alignment)
    groups, lps_log2, chunks = lane_split(D, vec)
    rows_per_warp = rows_per_warp_for(rows) if walk else 1
    return Geometry(
        vec=vec, lps_log2=lps_log2, groups=groups, chunks=chunks,
        passes=-(-n_samples // (32 >> lps_log2)),
        handout=int(walk and 2 * row_samples <= 32),
        rows_per_warp=rows_per_warp,
        threads=32 * WARPS_PER_BLOCK,
        blocks=-(-rows // (WARPS_PER_BLOCK * rows_per_warp)))


# Launch geometry of msda_fwd_q (K4). A row is one (batch, query, head) of
# n*P int8 samples; a warp's lanes split over (sample slot, channel group)
# as in Geometry, and a row takes a power of two of a pass's slots, so that
# a warp sums several short rows at once.
# The widest corner load of a lane, in bytes (int8 channels): measured on
# the H100 at chip_smoke's K4 calls (scripts/time_msda_kernels.py
# graph_ms_by_vec_bytes)
Q_VEC_BYTES = 16


@dataclass(frozen=True)
class QGeometry(_Lanes):
    """How msda_fwd_q (K4) lays rows on a warp's lanes.

    Lane ``l`` takes sample slot ``l >> lps_log2`` and channel group ``l &
    (lanes_per_sample - 1)`` (plus ``chunk * lanes_per_sample``). Slot ``s``
    sums row ``first + (s >> slots_log2)`` of the warp's
    ``rows_per_warp`` consecutive rows from ``first = warp *
    rows_per_warp``, and in pass ``t`` that row's sample ``t * row_slots +
    (s & (row_slots - 1))``. The passes go in groups of ``lanes_per_sample``
    (32 samples): lane ``l`` works out slot ``l % samples_per_pass`` of
    pass ``l // samples_per_pass`` of the group and hands it to the
    slot's lanes. A group is ``vec`` consecutive int8 channels, read with
    one vector load."""

    vec: int
    lps_log2: int
    groups: int
    chunks: int
    slots_log2: int     # log2 of the slots a row takes in a pass
    passes: int         # ceil(n * P / row_slots)
    threads: int
    blocks: int

    @property
    def row_slots(self) -> int:
        return 1 << self.slots_log2

    @property
    def rows_per_warp(self) -> int:
        return self.samples_per_pass >> self.slots_log2


@lru_cache(maxsize=256)
def q_geometry(rows: int, D: int, n_samples: int,
               alignment: int = 16) -> QGeometry:
    """K4's launch for ``rows`` = B*Q*H rows of ``n_samples`` = n*P summed
    samples, ``alignment`` that of the int8 values' pointer: a row's
    samples spread over UNROLL passes (their corner loads go together) on
    the fewest slots that hold them, a power of two, at most a pass."""
    vec = vector_width(D, 1, min(alignment, Q_VEC_BYTES))
    groups, lps_log2, chunks = lane_split(D, vec)
    spp = 32 >> lps_log2
    per_pass = -(-max(1, n_samples) // UNROLL)
    slots_log2 = min((per_pass - 1).bit_length(), 5 - lps_log2)
    n_warps = -(-rows // (spp >> slots_log2))
    return QGeometry(
        vec=vec, lps_log2=lps_log2, groups=groups, chunks=chunks,
        slots_log2=slots_log2, passes=-(-n_samples // (1 << slots_log2)),
        threads=32 * WARPS_PER_BLOCK,
        blocks=max(1, -(-n_warps // WARPS_PER_BLOCK)))


# Launch geometry of msda_bwd_value (K3). A block takes one (batch, head)
# and every query_chunks-th query from its chunk on, one warp a query in
# turn; a warp's lanes split over (sample, channel group) as launch_geometry
# says. The levels the block's queries hit densely enough are summed in a
# float32 copy in shared memory (D + 1 floats a pixel, so that a pass's
# samples spread over the banks) and added into the gradient once at the
# end; the others go to global memory as vector reductions.
N_SMS = 132               # the H100 SXM's streaming multiprocessors
SMEM_PER_SM = 233472      # 228 KB an SM
SMEM_PER_BLOCK = 232448   # 227 KB a block (MSDA_MAX_DYNAMIC_SMEM)
SMEM_RESERVED = 1024      # what the runtime keeps of an SM per block
# the most a block keeps in shared memory: the coarsest level at both
# buckets (36 KB at 800x1344, 21 KB at 608x1008). Shared-memory float
# atomics are compare-and-swap loops on sm_90 (ATOMS.CAST.SPIN), so a copy
# pays only where many adds meet: at the bf16 training encoder call on the
# H100, keeping no level measured 1.30x and keeping the two coarsest
# (175 KB) 1.17x the time of keeping the coarsest alone
PRIVATE_BYTES = 48 * 1024
PRIVATE_THREADS = 1024    # a block with private levels
VALUE_THREADS = 256       # a block without
REGISTERS_PER_SM = 65536
# msda_bwd_value's __launch_bounds__(1024, 1) holds it to 64 registers a
# thread, so an SM holds one block of 1024 threads, two of 512
VALUE_REGISTERS = 64
# a level is kept in shared memory where the block's queries add at least
# this many corner rows per pixel: zeroing and flushing the copy costs about
# one global add a pixel
PRIVATE_MIN_ADDS = 8


@dataclass(frozen=True)
class ValueGeometry(_Lanes):
    """How msda_bwd_value (K3) lays its work out.

    Block ``k`` takes (batch, head) ``k // query_chunks`` and queries
    ``k % query_chunks + m * query_chunks``; warp ``w`` of ``warps =
    threads // 32`` takes those with ``m = w, w + warps, ...``, one after
    another. A lane's sample slot, channel group and passes are
    :class:`Geometry`'s. Bit ``k`` of ``private`` keeps the ``k``-th level
    of the level table in the block's shared memory."""

    vec: int            # channels a lane, at most 4 (16 bytes of float32)
    lps_log2: int
    groups: int
    chunks: int
    passes: int
    private: int
    query_chunks: int
    threads: int
    blocks: int
    smem_bytes: int



def private_bytes(h: int, w: int, D: int) -> int:
    """Shared memory of one level's private copy: D + 1 floats a pixel."""
    return h * w * (D + 1) * 4


def private_blocks_per_sm(smem_bytes: int) -> int:
    """K3's blocks of PRIVATE_THREADS an SM holds at once: by threads, by
    registers and by shared memory."""
    return max(1, min(2048 // PRIVATE_THREADS,
                      REGISTERS_PER_SM // (VALUE_REGISTERS * PRIVATE_THREADS),
                      SMEM_PER_SM // (smem_bytes + SMEM_RESERVED)))


@lru_cache(maxsize=256)
def value_geometry(B: int, Q: int, H: int, D: int,
                   level_hw: Tuple[Tuple[int, int], ...], P: int,
                   element_size: int, alignment: int = 16) -> ValueGeometry:
    """K3's launch for ``level_hw``, the (h, w) of the levels taken, in the
    level table's order.

    The smallest levels are kept in shared memory, up to PRIVATE_BYTES
    and never all of them; the blocks per (batch, head) fill the card's SMs
    once, at the blocks an SM holds (:func:`private_blocks_per_sm`); a
    level whose block-share of corner adds falls below PRIVATE_MIN_ADDS a
    pixel goes back to global memory (the decoder calls' 200 queries keep
    none). Without private levels a block of VALUE_THREADS takes one query
    a warp."""
    # at most four channels a lane, so that a lane's reduction covers one
    # 16-byte float32 vector and a sample's lanes cover its row's sectors
    # whole (eight bf16 channels a lane added two half sectors each and
    # measured 1.4x slower on the H100)
    vec = min(4, vector_width(D, element_size, alignment))
    groups, lps_log2, chunks = lane_split(D, vec)
    sizes = [private_bytes(h, w, D) for h, w in level_hw]
    private, total = [], 0
    # at least one level stays in global memory: with every add in shared
    # memory the compare-and-swap loops carry all the work while L2's
    # reduction units idle (at the adaptation step's one-level call, on the
    # H100, keeping its level measured 1.13x the time of keeping none)
    for k in sorted(range(len(level_hw)), key=sizes.__getitem__)[:-1]:
        if total + sizes[k] <= PRIVATE_BYTES:
            private.append(k)
            total += sizes[k]
    query_chunks = 1
    while private:
        per_sm = private_blocks_per_sm(total)
        query_chunks = max(1, min(Q, N_SMS * per_sm // (B * H)))
        per_block = -(-Q // query_chunks)
        dense = [k for k in private if per_block * P * 4
                 >= PRIVATE_MIN_ADDS * level_hw[k][0] * level_hw[k][1]]
        if dense == private:
            break
        private, total = dense, sum(sizes[k] for k in dense)
    threads = PRIVATE_THREADS if private else VALUE_THREADS
    if not private:
        query_chunks = max(1, -(-Q // (threads // 32)))
    return ValueGeometry(
        vec=vec, lps_log2=lps_log2, groups=groups, chunks=chunks,
        passes=-(-len(level_hw) * P // (32 >> lps_log2)),
        private=sum(1 << k for k in private), query_chunks=query_chunks,
        threads=threads, blocks=B * H * query_chunks, smem_bytes=total)


# The banded kernels' lanes over (query, point, channel group), by the form
# of win_geometry: the row gradients (K7, K8), the forward (K5, K6), the
# value gradient (K9, K10); WinForm in msda_band.cuh.
WIN_FORMS = ("rows", "fwd", "value")
# K6 (with its fold) takes twice the queries that UNROLL passes hold, at
# most this many: measured on the H100 at the served encoder call (B=1) and
# at B=4, at three blocks an SM, twice the queries took 0.90x (f32) and
# 0.96x (bf16) the time of once, 0.86x at bf16 B=4; at int8, whose UNROLL
# passes hold 8 queries, 16 took 1.05x
WIN_FWD_QUERIES = 8


@dataclass(frozen=True)
class WinGeometry(_Lanes):
    """How the banded kernels (K5-K10) lay a level's work on a warp.

    Warp ``n`` (``blocks * threads // 32`` of them, the last block's spare
    warps idle) takes (batch, head) ``n // groups`` with ``groups =
    ceil(Q / queries)``, and the ``queries`` neighbouring queries from
    ``(n % groups) * queries`` on; its samples are those queries' P points,
    query-major. Lane ``l`` takes sample slot ``l >> lps_log2`` and channel
    group ``l & (lanes_per_sample - 1)`` (plus ``chunk *
    lanes_per_sample``); in pass ``t`` its sample is ``t * samples_per_pass
    + slot``. A query maps to its padded row through the segment table.
    The forward with ``fold`` folds a query's P points, which lie in
    neighbouring slots of one pass, over those slots; without it (P does not
    divide the samples a pass holds) a slot takes a whole query and the lane
    walks its points. The value gradient works out sample ``base + l`` on
    lane ``l`` and hands it out to the slot's lanes with shuffles."""

    vec: int
    lps_log2: int
    groups: int
    chunks: int
    queries: int
    passes: int
    fold: int
    threads: int
    blocks: int


@lru_cache(maxsize=256)
def win_geometry(BH: int, Q: int, D: int, P: int, element_size: int,
                 alignment: int = 16, form: str = "rows") -> WinGeometry:
    """The launch of a banded kernel for B*H = ``BH`` (batch, head) pairs
    of ``Q`` queries of ``P`` points, ``element_size`` the bytes of a value
    (the value gradient: ignored, its adds are float32) and ``alignment``
    that of the pointers its lanes load from or add to. The tile and point
    forms of a kernel take the same launch.

    ``"rows"`` (K7, K8): a warp takes as many neighbouring queries as UNROLL
    passes hold (at least one), so that their corner loads go together.
    ``"fwd"`` (K5, K6): it folds a query's points where P divides the
    samples a pass holds, and then takes twice the queries UNROLL passes
    hold, at most WIN_FWD_QUERIES; otherwise a slot walks a whole query's
    points and a warp takes the queries UNROLL passes hold. ``"value"`` (K9,
    K10): at most four float32 channels a lane (one 16-byte reduction a
    corner), and 32 / P queries a warp, one sample a lane for the hand-out
    of its geometry."""
    if form not in WIN_FORMS:
        raise ValueError(f"form must be one of {WIN_FORMS}, got {form!r}")
    vec = vector_width(D, 4 if form == "value" else element_size, alignment)
    groups, lps_log2, chunks = lane_split(D, vec)
    spp = 32 >> lps_log2
    fold = int(form == "fwd" and spp % P == 0)
    if form == "value":
        queries = max(1, 32 // P)
    elif form == "fwd" and fold:
        queries = max(1, min(WIN_FWD_QUERIES, 2 * UNROLL * spp // P))
    elif form == "fwd":
        queries = UNROLL * spp
    else:
        queries = max(1, UNROLL * spp // P)
    samples = queries if form == "fwd" and not fold else queries * P
    n_warps = BH * -(-Q // queries)
    return WinGeometry(
        vec=vec, lps_log2=lps_log2, groups=groups, chunks=chunks,
        queries=queries, passes=-(-samples // spp), fold=fold,
        threads=32 * WARPS_PER_BLOCK,
        blocks=max(1, -(-n_warps // WARPS_PER_BLOCK)))


_VOID_P, _INT = ctypes.c_void_p, ctypes.c_int
_GEOM_ARG = [ctypes.POINTER(_INT), _VOID_P]  # a launch geometry, the stream
# the banded kernels, tile and point forms alike: pointers, the segment
# table, the shapes, a batch stride, the value type, the lanes' layout
_WIN_ARGS = ([_VOID_P] * 6 + [ctypes.POINTER(_INT)] + [_INT] * 11
             + [ctypes.c_long, _INT] + _GEOM_ARG)
_BWD_WIN_ROWS_ARGS = [_VOID_P] * 3 + _WIN_ARGS
# per exported function: its library and its C argument types
_FUNCTIONS = {
    "msda_fwd": ("msda_fwd", [_VOID_P] * 4 + [ctypes.POINTER(_INT)]
                 + [_INT] * 10 + [ctypes.POINTER(_INT), _VOID_P]),
    "msda_fwd_q": ("msda_fwd_q", [_VOID_P] * 5 + [ctypes.POINTER(_INT)]
                   + [_INT] * 9 + _GEOM_ARG),
    "msda_fwd_win": ("msda_fwd_win", _WIN_ARGS),
    "msda_fwd_win_pp": ("msda_fwd_win", _WIN_ARGS),
    "msda_bwd_rows": ("msda_bwd", [_VOID_P] * 6 + [ctypes.POINTER(_INT)]
                      + [_INT] * 9 + [ctypes.POINTER(_INT), _VOID_P]),
    "msda_bwd_value": ("msda_bwd", [_VOID_P] * 4 + [ctypes.POINTER(_INT)]
                       + [_INT] * 9 + [ctypes.POINTER(_INT), _VOID_P]),
    "msda_bwd_win_rows": ("msda_bwd_win", _BWD_WIN_ROWS_ARGS),
    "msda_bwd_win_rows_pp": ("msda_bwd_win", _BWD_WIN_ROWS_ARGS),
    "msda_bwd_win_value": ("msda_bwd_win", _WIN_ARGS),
    "msda_bwd_win_value_pp": ("msda_bwd_win", _WIN_ARGS),
    "msda_fwd_bp": ("msda_fwd_bp", [_VOID_P] * 4 + [ctypes.POINTER(_INT)]
                    + [_INT] * 8 + [_VOID_P]),
    "lsap": ("lsap", [_VOID_P] * 5 + [_INT] * 3 + _GEOM_ARG),
    "frozen_bn": ("frozen_bn", [_VOID_P] * 11 + [ctypes.c_long] + [_INT] * 3
                  + _GEOM_ARG),
}


def source_of(function: str) -> Path:
    """The source of the library that exports the C function ``function``."""
    return sources()[_FUNCTIONS[function][0]]


def _function(name: str):
    """The C function ``name``, from its library (built and loaded at first
    use)."""
    lib_name, argtypes = _FUNCTIONS[name]
    with _lib_lock:
        if lib_name not in _libs:
            lib = ctypes.CDLL(str(build()[lib_name]))
            for fn, (owner, types) in _FUNCTIONS.items():
                if owner == lib_name:
                    getattr(lib, fn).argtypes = types
                    getattr(lib, fn).restype = _INT
            _libs[lib_name] = lib
    return getattr(_libs[lib_name], name)


def check_inputs(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                 sampling_locations: torch.Tensor,
                 attention_weights: torch.Tensor) -> None:
    """Raise on anything the kernel does not take (device aside)."""
    if value.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    if sampling_locations.dtype != torch.float32:
        raise TypeError("sampling_locations must be float32, got "
                        f"{sampling_locations.dtype}")
    if attention_weights.dtype != value.dtype:
        raise TypeError(f"attention_weights must have the value dtype "
                        f"{value.dtype}, got {attention_weights.dtype}")
    _check_shapes(value, spatial_shapes, sampling_locations,
                  attention_weights)


def _check_shapes(value, spatial_shapes, sampling_locations,
                  attention_weights) -> None:
    """The shape, contiguity and size checks the forward kernels share."""
    if value.dim() != 4:
        raise ValueError(f"value must be [B,S,H,D], got {tuple(value.shape)}")
    B, S, H, D = value.shape
    L = len(spatial_shapes)
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1..{MAX_LEVELS} levels, got {L}")
    if sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"spatial shapes {tuple(spatial_shapes)} do not "
                         f"cover S={S}")
    loc_shape = tuple(sampling_locations.shape)
    if (len(loc_shape) != 6 or loc_shape[0] != B or loc_shape[2] != H
            or loc_shape[3] != L or loc_shape[5] != 2):
        raise ValueError(f"sampling_locations must be [B,Q,H,L,P,2] = "
                         f"[{B},Q,{H},{L},P,2], got {loc_shape}")
    if tuple(attention_weights.shape) != loc_shape[:5]:
        raise ValueError(f"attention_weights must be {loc_shape[:5]}, got "
                         f"{tuple(attention_weights.shape)}")
    for name, t in (("value", value), ("sampling_locations",
                                       sampling_locations),
                    ("attention_weights", attention_weights)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(value.numel(), sampling_locations.numel()) >= 2 ** 31:
        raise ValueError("tensors of 2**31 or more elements are not supported")


def level_table(spatial_shapes: Sequence[Tuple[int, int]], D: int,
                levels: Tuple[int, ...], rounds: bool) -> List[int]:
    """Per summed (or differentiated) level: h, w, start token, round the y
    weights, index into the L axis of the locations. ``rounds``: stage 1
    rounds its hats at all (a low-precision dtype, or int8), and then those
    of y on a level that contracts y; the backward kernels read no rounding
    flag (they always round the x hats)."""
    starts = level_starts(spatial_shapes)
    table = []
    for lid in levels:
        h, w = spatial_shapes[lid]
        round_y = rounds and _orient(h, w, D) == "y"
        table += [h, w, starts[lid], int(round_y), lid]
    return table


def _one_cuda_device(name: str, tensors) -> None:
    if any(t.device.type != "cuda" for t in tensors) or len(
            {t.device for t in tensors}) != 1:
        raise ValueError(f"{name} takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")


def _levels_arg(spatial_shapes, D: int, levels: Tuple[int, ...],
                rounds: bool):
    table = level_table(spatial_shapes, D, levels, rounds)
    return (ctypes.c_int * len(table))(*table)


def _check_levels(levels, L: int) -> Tuple[int, ...]:
    levels = tuple(range(L)) if levels is None else tuple(
        int(l) for l in levels)
    if not levels or len(set(levels)) != len(levels) or not all(
            0 <= l < L for l in levels):
        raise ValueError(f"levels must be distinct indices into the {L} "
                         f"levels, got {levels}")
    return levels


def _refuse_grad(name: str, tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is the bare forward kernel and has no backward of its "
            "own; call msda.ms_deform_attn where a gradient is needed")


def _fwd(name: str, value: torch.Tensor,
         spatial_shapes: Sequence[Tuple[int, int]],
         sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
         levels: Optional[Sequence[int]], out_dtype: Optional[torch.dtype]
         ) -> Tuple[torch.Tensor, bool]:
    """Check, allocate and launch K1's kernel for the wrapper ``name``
    (``msda_fwd``, and ``msda_fwd_bp`` for its bfloat16 form); returns the
    output and whether a kernel was launched (an empty output needs none)."""
    tensors = (value, sampling_locations, attention_weights)
    _one_cuda_device(name, tensors)
    _refuse_grad(name, tensors)
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    check_inputs(value, spatial_shapes, sampling_locations, attention_weights)
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    levels = _check_levels(levels, L)
    out_dtype = value.dtype if out_dtype is None else out_dtype
    if out_dtype not in (value.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {value.dtype} or float32, got "
                        f"{out_dtype}")
    fn = _function("msda_fwd")
    out = torch.empty((B, Q, H * D), dtype=out_dtype, device=value.device)
    if out.numel() == 0:
        return out, False
    table = _levels_arg(spatial_shapes, D, levels,
                        value.dtype != torch.float32)
    geometry = launch_geometry(B * Q * H, D, len(levels) * P, L * P,
                               value.element_size(), pointer_alignment(value))
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(),
                table, len(levels), L, B, S, Q, H, D, P,
                int(value.dtype == torch.bfloat16),
                int(out_dtype == torch.float32), geometry.c_array, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out, True


def msda_fwd(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor,
             levels: Optional[Sequence[int]] = None,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the forward kernel: same contract as
    ``msda.ms_deform_attn_plain``, ``levels`` and ``out_dtype`` (the value
    dtype or float32) included.

    The bare kernel records nothing for autograd and raises where a gradient
    would be needed: ``msda.ms_deform_attn`` wraps it in the op that carries
    the backward kernels.
    """
    out, launched = _fwd("msda_fwd", value, spatial_shapes,
                         sampling_locations, attention_weights, levels,
                         out_dtype)
    _count("msda_fwd", launched)
    return out


def check_inputs_q(vq: torch.Tensor, scale: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> None:
    """Raise on anything ``msda_fwd_q`` does not take (device aside)."""
    if vq.dtype != torch.int8:
        raise TypeError(f"vq must be int8, got {vq.dtype}")
    if attention_weights.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("attention_weights must be float32 or bfloat16, got "
                        f"{attention_weights.dtype}")
    if sampling_locations.dtype != torch.float32:
        raise TypeError("sampling_locations must be float32, got "
                        f"{sampling_locations.dtype}")
    _check_shapes(vq, spatial_shapes, sampling_locations, attention_weights)
    B, _, H, _ = vq.shape
    L = len(spatial_shapes)
    if (scale.dtype != torch.float32 or tuple(scale.shape) != (B, H, L)
            or not scale.is_contiguous()):
        raise ValueError(f"scale must be contiguous float32 [B,H,L] = "
                         f"[{B},{H},{L}], got {scale.dtype} "
                         f"{tuple(scale.shape)}")


def _fwd_q(name: str, vq: torch.Tensor, scale: torch.Tensor,
           spatial_shapes: Sequence[Tuple[int, int]],
           sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
           levels: Optional[Sequence[int]]) -> Tuple[torch.Tensor, bool]:
    """Check, allocate and launch K4's kernel for the wrapper ``name``
    (``msda_fwd_q``, and ``msda_fwd_bp`` for its int8 form); returns the
    output and whether a kernel was launched."""
    tensors = (vq, scale, sampling_locations, attention_weights)
    _one_cuda_device(name, tensors)
    _refuse_grad(name, tensors)
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    check_inputs_q(vq, scale, spatial_shapes, sampling_locations,
                   attention_weights)
    B, S, H, D = vq.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    levels = _check_levels(levels, L)
    fn = _function("msda_fwd_q")
    out = torch.empty((B, Q, H * D), dtype=torch.float32, device=vq.device)
    if out.numel() == 0:
        return out, False
    table = _levels_arg(spatial_shapes, D, levels, True)
    geometry = q_geometry(B * Q * H, D, len(levels) * P,
                          pointer_alignment(vq))
    with torch.cuda.device(vq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(vq.data_ptr(), scale.data_ptr(),
                sampling_locations.data_ptr(), attention_weights.data_ptr(),
                out.data_ptr(), table, len(levels), L, B, S, Q, H, D, P,
                int(attention_weights.dtype == torch.bfloat16),
                geometry.c_array, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out, True


def msda_fwd_q(vq: torch.Tensor, scale: torch.Tensor,
               spatial_shapes: Sequence[Tuple[int, int]],
               sampling_locations: torch.Tensor,
               attention_weights: torch.Tensor,
               levels: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Launch the int8-stage-1 forward kernel: the contract of
    ``msda.msda_fwd_q_plain`` (``(vq, scale)`` from
    ``msda.quantize_levels``; float32 [B, Q, H*D] out)."""
    out, launched = _fwd_q("msda_fwd_q", vq, scale, spatial_shapes,
                           sampling_locations, attention_weights, levels)
    _count("msda_fwd_q", launched)
    return out


# The kernel that serves each form of msda_fwd_bp (K11), by value dtype: the
# kernel of the same function where it measured no slower on the H100 (K1's
# at bfloat16, K4's at int8: their outputs bit for bit), K11's own at
# float32, where K1's measured 1.17-1.20x its time at the encoder calls
# (PERF.md, scripts/time_msda_kernels.py --kernels K1,K11)
BP_ROUTES = {torch.bfloat16: "msda_fwd", torch.int8: "msda_fwd_q",
             torch.float32: "msda_fwd_bp"}


def check_inputs_bp(value: torch.Tensor,
                    spatial_shapes: Sequence[Tuple[int, int]],
                    sampling_locations: torch.Tensor,
                    attention_weights: torch.Tensor,
                    scale: Optional[torch.Tensor]) -> str:
    """Raise on anything ``msda_fwd_bp`` does not take (device aside): what
    the kernel that serves the form refuses. Returns that kernel's C function
    (``BP_ROUTES``): ``msda_fwd`` for bfloat16 values (K1's inputs),
    ``msda_fwd_q`` for int8 values with their ``scale`` (K4's), and
    ``msda_fwd_bp`` for float32 values (K1's inputs, and K11's own lane
    split: P dividing 32, D a multiple of 4, a value pointer aligned for a
    four-channel load)."""
    if value.dtype == torch.int8:
        if scale is None:
            raise ValueError("int8 values need their scale (int8 form)")
        check_inputs_q(value, scale, spatial_shapes, sampling_locations,
                       attention_weights)
    else:
        if scale is not None:
            raise ValueError("scale is for int8 values only")
        check_inputs(value, spatial_shapes, sampling_locations,
                     attention_weights)
    route = BP_ROUTES[value.dtype]
    if route != "msda_fwd_bp":
        return route
    D, P = value.shape[3], sampling_locations.shape[4]
    if P < 1 or 32 % P:
        raise ValueError(f"msda_fwd_bp's float32 kernel splits a warp's 32 "
                         f"lanes over the sampling points: P must divide 32, "
                         f"got P = {P}")
    if D % 4:
        raise ValueError(f"msda_fwd_bp's float32 kernel reads four channels "
                         f"per lane: D must be a multiple of 4, got D = {D}")
    if value.data_ptr() % 16:
        raise ValueError("float32 value must be aligned to four channels (a "
                         "tensor whose storage starts at an element offset "
                         "that is not a multiple of 4 is not)")
    return route


def msda_fwd_bp(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                sampling_locations: torch.Tensor,
                attention_weights: torch.Tensor,
                levels: Optional[Sequence[int]] = None,
                out_dtype: Optional[torch.dtype] = None,
                scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the batched-P forward (K11): the contract of
    ``msda.msda_fwd_bp_plain``. Float form: K1's (``msda_fwd``), ``levels``
    and ``out_dtype`` included. int8 form (``value`` int8 from
    ``msda.quantize_levels`` with its ``scale``): K4's (``msda_fwd_q``),
    float32 out. Each form runs the kernel ``BP_ROUTES`` names (bfloat16:
    K1's launch, bit-equal to ``msda_fwd``; int8: K4's, bit-equal to
    ``msda_fwd_q``; float32: K11's own) and counts as a launch of
    ``msda_fwd_bp`` alone."""
    tensors = (value, sampling_locations, attention_weights) + (
        () if scale is None else (scale,))
    _one_cuda_device("msda_fwd_bp", tensors)
    _refuse_grad("msda_fwd_bp", tensors)
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    route = check_inputs_bp(value, spatial_shapes, sampling_locations,
                            attention_weights, scale)
    if route == "msda_fwd":
        out, launched = _fwd("msda_fwd_bp", value, spatial_shapes,
                             sampling_locations, attention_weights, levels,
                             out_dtype)
    elif route == "msda_fwd_q":
        if out_dtype not in (None, torch.float32):
            raise TypeError(f"the int8 form returns float32, got out_dtype "
                            f"{out_dtype}")
        out, launched = _fwd_q("msda_fwd_bp", value, scale, spatial_shapes,
                               sampling_locations, attention_weights, levels)
    else:
        out, launched = _fwd_bp_own(value, spatial_shapes, sampling_locations,
                                    attention_weights, levels, out_dtype)
    _count("msda_fwd_bp", launched)
    return out


def _fwd_bp_own(value, spatial_shapes, sampling_locations, attention_weights,
                levels, out_dtype) -> Tuple[torch.Tensor, bool]:
    """Allocate and launch K11's own (float32) kernel on checked inputs;
    returns the output and whether a kernel was launched."""
    if out_dtype not in (None, torch.float32):
        raise TypeError(f"out_dtype must be float32, got {out_dtype}")
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    levels = _check_levels(levels, L)
    fn = _function("msda_fwd_bp")
    out = torch.empty((B, Q, H * D), dtype=torch.float32, device=value.device)
    if out.numel() == 0:
        return out, False
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(),
                _levels_arg(spatial_shapes, D, levels, False), len(levels),
                L, B, S, Q, H, D, P, stream)
    if rc != 0:
        raise RuntimeError(f"msda_fwd_bp kernel launch failed: CUDA error {rc}")
    return out, True


_WIN_VTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def check_inputs_win(value_l: torch.Tensor, bidx: torch.Tensor,
                     ix: torch.Tensor, iy_band: torch.Tensor,
                     aw_eff: torch.Tensor, h: int, w: int, win: int,
                     segs: Segments, Q: int, per_point: bool) -> int:
    """Raise on anything the banded kernels do not take (device aside);
    returns the query tile TQ."""
    if value_l.dtype not in _WIN_VTYPES:
        raise TypeError("value_l must be float32, bfloat16 or int8, got "
                        f"{value_l.dtype}")
    if value_l.dim() != 4 or value_l.shape[1] != h * w:
        raise ValueError(f"value_l must be [B,h*w,H,D] with h*w = {h * w}, "
                         f"got {tuple(value_l.shape)}")
    B, _, H, D = value_l.shape
    if value_l.stride()[1:] != (H * D, D, 1):
        raise ValueError("value_l must be contiguous within a batch (a slice "
                         "of [B,S,H,D] over tokens), got strides "
                         f"{value_l.stride()}")
    if win < 2 or win % 2 or h <= win:
        raise ValueError(f"a banded level needs an even window below its "
                         f"height, got window {win} for h = {h}")
    if ix.dim() != 4 or tuple(ix.shape[:2]) != (B, H):
        raise ValueError(f"ix must be [B,H,P,Q_pad] = [{B},{H},P,Q_pad], got "
                         f"{tuple(ix.shape)}")
    P, Qp = ix.shape[2:]
    for name, t in (("ix", ix), ("iy_band", iy_band), ("aw_eff", aw_eff)):
        if t.dtype != torch.float32 or t.shape != ix.shape:
            raise ValueError(f"{name} must be float32 {tuple(ix.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    want = (B, H, P) if per_point else (B, H)
    if (bidx.dtype != torch.int32 or tuple(bidx.shape[:-1]) != want
            or bidx.shape[-1] == 0 or Qp % bidx.shape[-1]):
        raise ValueError(f"bidx must be int32 {[*want, 'T']} with T dividing "
                         f"Q_pad = {Qp}, got {bidx.dtype} "
                         f"{tuple(bidx.shape)}")
    TQ = Qp // bidx.shape[-1]
    if not 1 <= len(segs) <= MAX_SEGMENTS:
        raise ValueError(f"the kernel takes 1..{MAX_SEGMENTS} query "
                         f"segments, got {len(segs)}")
    if sum(qs for _, qs in segs) != Q or padded_starts(segs, TQ)[-1] != Qp:
        raise ValueError(f"segments {segs} padded to tiles of {TQ} do not "
                         f"give Q = {Q} and Q_pad = {Qp}")
    for name, t in (("bidx", bidx), ("ix", ix), ("iy_band", iy_band),
                    ("aw_eff", aw_eff)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(B * value_l.stride(0), ix.numel(), B * Q * H * D) >= 2 ** 31:
        raise ValueError("tensors of 2**31 or more elements are not supported")
    return TQ


def _fwd_win(name: str, per_point: bool, value_l, bidx, ix, iy_band, aw_eff,
             h: int, w: int, win: int, segs: Segments, Q: int
             ) -> Tuple[torch.Tensor, bool]:
    """Check, allocate and launch for both banded forwards (one kernel,
    the tile form's band table with a point stride of 0); returns the
    output and whether a kernel was launched (an empty output needs none)."""
    tensors = (value_l, bidx, ix, iy_band, aw_eff)
    _one_cuda_device(name, tensors)
    _refuse_grad(name, tensors)
    h, w, win, Q = int(h), int(w), int(win), int(Q)
    segs = tuple((int(q0), int(qs)) for q0, qs in segs)
    TQ = check_inputs_win(value_l, bidx, ix, iy_band, aw_eff, h, w, win,
                          segs, Q, per_point)
    B, _, H, D = value_l.shape
    P, Qp = ix.shape[2:]
    fn = _function(name)
    out = torch.empty((B, Q, H * D), dtype=torch.float32,
                      device=value_l.device)
    if out.numel() == 0:
        return out, False
    table = [v for (q0, _), qp0 in zip(segs, padded_starts(segs, TQ))
             for v in (q0, qp0)]
    # the lanes' layout, as an int array
    layout = win_geometry(B * H, Q, D, P, value_l.element_size(),
                          pointer_alignment(value_l, out), "fwd")
    with torch.cuda.device(value_l.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(value_l.data_ptr(), bidx.data_ptr(), ix.data_ptr(),
                iy_band.data_ptr(), aw_eff.data_ptr(), out.data_ptr(),
                (ctypes.c_int * len(table))(*table), len(segs), B, Q, Qp, H,
                D, P, h, w, win, TQ, value_l.stride(0),
                _WIN_VTYPES[value_l.dtype], layout.c_array, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out, True


def msda_fwd_win(value_l: torch.Tensor, bidx: torch.Tensor, ix: torch.Tensor,
                 iy_band: torch.Tensor, aw_eff: torch.Tensor, h: int, w: int,
                 win: int, segs: Segments, Q: int) -> torch.Tensor:
    """Launch the banded kernel with one band per query tile (``bidx``
    [B, H, T]): the contract of ``msda.msda_fwd_win_plain``, float32
    [B, Q, H*D] out. int8 values select the kernel's int8 form.
    Deterministic: :func:`msda_fwd_win_pp`'s kernel and launch, whose every
    point reads its tile's band, so bit-equal to it given ``bidx`` broadcast
    over the points."""
    out, launched = _fwd_win("msda_fwd_win", False, value_l, bidx, ix,
                             iy_band, aw_eff, h, w, win, segs, Q)
    _count("msda_fwd_win", launched)
    return out


def msda_fwd_win_pp(value_l: torch.Tensor, bidx: torch.Tensor,
                    ix: torch.Tensor, iy_band: torch.Tensor,
                    aw_eff: torch.Tensor, h: int, w: int, win: int,
                    segs: Segments, Q: int) -> torch.Tensor:
    """Launch the banded kernel with one band per (sampling point, query
    tile) (``bidx`` [B, H, P, T]): the contract of
    ``msda.msda_fwd_win_plain``, float32 [B, Q, H*D] out. int8 values select
    the kernel's int8 form."""
    out, launched = _fwd_win("msda_fwd_win_pp", True, value_l, bidx, ix,
                             iy_band, aw_eff, h, w, win, segs, Q)
    _count("msda_fwd_win_pp", launched)
    return out


def check_grad_output(value: torch.Tensor, sampling_locations: torch.Tensor,
                      grad_output: torch.Tensor) -> None:
    """Raise unless ``grad_output`` is the forward's output gradient:
    contiguous [B, Q, H*D] in the value dtype."""
    B, _, H, D = value.shape
    Q = sampling_locations.shape[1]
    if tuple(grad_output.shape) != (B, Q, H * D):
        raise ValueError(f"grad_output must be [B,Q,H*D] = [{B},{Q},{H * D}],"
                         f" got {tuple(grad_output.shape)}")
    if grad_output.dtype != value.dtype:
        raise TypeError(f"grad_output must have the value dtype "
                        f"{value.dtype}, got {grad_output.dtype}")
    if not grad_output.is_contiguous():
        raise ValueError("grad_output must be contiguous")


def _bwd_args(name, value, spatial_shapes, sampling_locations,
              attention_weights, grad_output):
    tensors = (value, sampling_locations, attention_weights, grad_output)
    _one_cuda_device(name, tensors)
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    check_inputs(value, spatial_shapes, sampling_locations, attention_weights)
    check_grad_output(value, sampling_locations, grad_output)
    return spatial_shapes


def msda_bwd_rows(value: torch.Tensor,
                  spatial_shapes: Sequence[Tuple[int, int]],
                  sampling_locations: torch.Tensor,
                  attention_weights: torch.Tensor, grad_output: torch.Tensor,
                  levels: Optional[Sequence[int]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the row-gradient kernel: ``(dloc [B,Q,H,L,P,2] float32,
    daw [B,Q,H,L,P] in the weights' dtype)``, as the last two results of
    ``msda.ms_deform_attn_plain_bwd``, ``levels`` included (the other
    levels' entries are zero). Deterministic."""
    spatial_shapes = _bwd_args("msda_bwd_rows", value, spatial_shapes,
                               sampling_locations, attention_weights,
                               grad_output)
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    levels = _check_levels(levels, L)
    fn = _function("msda_bwd_rows")
    # the kernel writes the entries of its levels only
    alloc = torch.empty_like if len(levels) == L else torch.zeros_like
    dloc = alloc(sampling_locations)
    daw = alloc(attention_weights)
    if daw.numel() == 0:
        return dloc, daw
    table = _levels_arg(spatial_shapes, D, levels, False)
    geometry = launch_geometry(B * Q * H, D, len(levels) * P, L * P,
                               value.element_size(),
                               pointer_alignment(value, grad_output),
                               walk=False)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), grad_output.data_ptr(),
                dloc.data_ptr(), daw.data_ptr(), table, len(levels), L, B, S,
                Q, H, D, P, int(value.dtype == torch.bfloat16),
                geometry.c_array, stream)
    if rc != 0:
        raise RuntimeError(
            f"msda_bwd_rows kernel launch failed: CUDA error {rc}")
    _count("msda_bwd_rows")
    return dloc, daw


def msda_bwd_value(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor, grad_output: torch.Tensor,
                   levels: Optional[Sequence[int]] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the value-gradient kernel: ``dvalue [B,S,H,D]`` in the value
    dtype, as the first result of ``msda.ms_deform_attn_plain_bwd``;
    ``levels`` restricts it to those levels (zero elsewhere), ``out_dtype``
    float32 returns the float32 sum as it is (``dvalue_dtype`` there).

    The kernel adds into a zeroed float32 buffer with atomics, which is cast
    to the value dtype once at the end; the order of the additions, and with
    it the last bits of the float32 sums, varies from run to run. ``value``
    gives the shape and dtype only: the kernel does not read it.
    """
    spatial_shapes = _bwd_args("msda_bwd_value", value, spatial_shapes,
                               sampling_locations, attention_weights,
                               grad_output)
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    levels = _check_levels(levels, L)
    out_dtype = value.dtype if out_dtype is None else out_dtype
    if out_dtype not in (value.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {value.dtype} or float32, got "
                        f"{out_dtype}")
    fn = _function("msda_bwd_value")
    acc = torch.zeros((B, S, H, D), dtype=torch.float32, device=value.device)
    if acc.numel() == 0 or Q == 0:
        return acc.to(out_dtype)
    table = _levels_arg(spatial_shapes, D, levels, False)
    geometry = value_geometry(B, Q, H, D,
                              tuple(spatial_shapes[l] for l in levels), P,
                              value.element_size(),
                              pointer_alignment(grad_output))
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(sampling_locations.data_ptr(), attention_weights.data_ptr(),
                grad_output.data_ptr(), acc.data_ptr(), table, len(levels), L,
                B, S, Q, H, D, P, int(value.dtype == torch.bfloat16),
                geometry.c_array, stream)
    if rc != 0:
        raise RuntimeError(
            f"msda_bwd_value kernel launch failed: CUDA error {rc}")
    _count("msda_bwd_value")
    return acc.to(out_dtype)


def msda_bwd(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor, grad_output: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both backward kernels: ``(dvalue, dloc, daw)``, the contract of
    ``msda.ms_deform_attn_plain_bwd``."""
    dloc, daw = msda_bwd_rows(value, spatial_shapes, sampling_locations,
                              attention_weights, grad_output)
    dvalue = msda_bwd_value(value, spatial_shapes, sampling_locations,
                            attention_weights, grad_output)
    return dvalue, dloc, daw


def check_inputs_bwd_win(value_l: torch.Tensor, bidx: torch.Tensor,
                         ix: torch.Tensor, iy_band: torch.Tensor,
                         aw_eff: torch.Tensor, g: torch.Tensor, h: int,
                         w: int, win: int, segs: Segments, Q: int,
                         per_point: bool) -> int:
    """Raise on anything the banded backward kernels do not take (device
    aside): the banded forward's inputs with float32 or bfloat16 values, and
    ``g`` contiguous [B, Q, H*D] in the value dtype. Returns the tile TQ."""
    if value_l.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("the banded backward takes float32 or bfloat16 "
                        f"values, got {value_l.dtype}")
    TQ = check_inputs_win(value_l, bidx, ix, iy_band, aw_eff, h, w, win, segs,
                          Q, per_point)
    B, _, H, D = value_l.shape
    if tuple(g.shape) != (B, Q, H * D):
        raise ValueError(f"g must be [B,Q,H*D] = [{B},{Q},{H * D}], got "
                         f"{tuple(g.shape)}")
    if g.dtype != value_l.dtype:
        raise TypeError(f"g must have the value dtype {value_l.dtype}, got "
                        f"{g.dtype}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    if max(B * h * w * H * D, g.numel()) >= 2 ** 31:
        raise ValueError("tensors of 2**31 or more elements are not supported")
    return TQ


def check_value_out(out: torch.Tensor, value_l: torch.Tensor, h: int,
                    w: int) -> None:
    """Raise unless ``out`` is a float32 [B, h*w, H, D] view on the values'
    device that is contiguous within a batch (the level's slice of a
    layer's [B, S, H, D] gradient, or a buffer of its own)."""
    B, _, H, D = value_l.shape
    if (out.dtype != torch.float32 or tuple(out.shape) != (B, h * w, H, D)
            or out.stride()[1:] != (H * D, D, 1)
            or (B > 1 and out.stride(0) < h * w * H * D)
            or out.device != value_l.device):
        raise ValueError(f"out must be float32 [B,h*w,H,D] = "
                         f"[{B},{h * w},{H},{D}] on {value_l.device}, "
                         f"contiguous within a batch, got {out.dtype} "
                         f"{tuple(out.shape)} strides {out.stride()} on "
                         f"{out.device}")
    if B * out.stride(0) >= 2 ** 31:
        raise ValueError("tensors of 2**31 or more elements are not supported")


def _bwd_win_launch(name: str, per_point: bool, rows: bool, value_l, bidx, ix,
                    iy_band, aw_eff, g, h: int, w: int, win: int,
                    segs: Segments, Q: int, out=None):
    """Check, allocate and launch for the four banded backward wrappers
    (two kernels, each with a tile form whose band table has a point stride
    of 0). Returns (outputs, launched): (dix, diy, daw) rows for a rows
    kernel, (dvalue_l,) for a value kernel (``out`` where it is given)."""
    tensors = (value_l, bidx, ix, iy_band, aw_eff, g)
    _one_cuda_device(name, tensors)
    h, w, win, Q = int(h), int(w), int(win), int(Q)
    segs = tuple((int(q0), int(qs)) for q0, qs in segs)
    TQ = check_inputs_bwd_win(value_l, bidx, ix, iy_band, aw_eff, g, h, w,
                              win, segs, Q, per_point)
    B, _, H, D = value_l.shape
    P, Qp = ix.shape[2:]
    fn = _function(name)
    # the kernels never visit the padding rows, which stay zero
    if rows:
        outs = (torch.zeros_like(ix), torch.zeros_like(ix),
                torch.zeros_like(ix))
    elif out is not None:
        check_value_out(out, value_l, h, w)
        outs = (out,)
    else:
        outs = (torch.zeros((B, h * w, H, D), dtype=torch.float32,
                            device=ix.device),)
    if B * H * Q == 0:
        return outs, False
    table = [v for (q0, _), qp0 in zip(segs, padded_starts(segs, TQ))
             for v in (q0, qp0)]
    geometry = ((ctypes.c_int * len(table))(*table), len(segs), B, Q, Qp, H,
                D, P, h, w, win, TQ)
    is_bf16 = int(value_l.dtype == torch.bfloat16)
    with torch.cuda.device(ix.device):
        stream = torch.cuda.current_stream().cuda_stream
        if rows:
            # the lanes' layout as an int array
            layout = win_geometry(B * H, Q, D, P, value_l.element_size(),
                                  pointer_alignment(value_l, g))
            rc = fn(value_l.data_ptr(), bidx.data_ptr(), ix.data_ptr(),
                    iy_band.data_ptr(), aw_eff.data_ptr(), g.data_ptr(),
                    *(t.data_ptr() for t in outs), *geometry,
                    value_l.stride(0), is_bf16, layout.c_array, stream)
        else:
            # the lanes' layout, and the batch stride of the output, to
            # whose alignment the vector adds keep
            dv = outs[0]
            align = pointer_alignment(g, dv)
            while (dv.stride(0) * 4) % align:
                align //= 2
            layout = win_geometry(B * H, Q, D, P, 4, align, "value")
            rc = fn(bidx.data_ptr(), ix.data_ptr(), iy_band.data_ptr(),
                    aw_eff.data_ptr(), g.data_ptr(), dv.data_ptr(),
                    *geometry, dv.stride(0), is_bf16, layout.c_array, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return outs, True


def msda_bwd_win_rows(value_l: torch.Tensor, bidx: torch.Tensor,
                      ix: torch.Tensor, iy_band: torch.Tensor,
                      aw_eff: torch.Tensor, g: torch.Tensor, h: int, w: int,
                      win: int, segs: Segments, Q: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the banded row-gradient kernel with one band per query tile
    (``bidx`` [B, H, T]): ``(dix, diy, daw)`` float32 [B, H, P, Q_pad], as
    the last three results of ``msda.msda_bwd_win_plain``. Deterministic:
    K8's kernel and launch, whose every point reads its tile's band, so
    bit-equal to :func:`msda_bwd_win_rows_pp` given ``bidx`` broadcast over
    the points."""
    outs, launched = _bwd_win_launch("msda_bwd_win_rows", False, True,
                                     value_l, bidx, ix, iy_band, aw_eff, g, h,
                                     w, win, segs, Q)
    _count("msda_bwd_win_rows", launched)
    return outs


def msda_bwd_win_rows_pp(value_l: torch.Tensor, bidx: torch.Tensor,
                         ix: torch.Tensor, iy_band: torch.Tensor,
                         aw_eff: torch.Tensor, g: torch.Tensor, h: int,
                         w: int, win: int, segs: Segments, Q: int
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """:func:`msda_bwd_win_rows` with one band per (sampling point, query
    tile) (``bidx`` [B, H, P, T])."""
    outs, launched = _bwd_win_launch("msda_bwd_win_rows_pp", True, True,
                                     value_l, bidx, ix, iy_band, aw_eff, g, h,
                                     w, win, segs, Q)
    _count("msda_bwd_win_rows_pp", launched)
    return outs


def msda_bwd_win_value(value_l: torch.Tensor, bidx: torch.Tensor,
                       ix: torch.Tensor, iy_band: torch.Tensor,
                       aw_eff: torch.Tensor, g: torch.Tensor, h: int, w: int,
                       win: int, segs: Segments, Q: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the banded value-gradient kernel with one band per query tile
    (``bidx`` [B, H, T]): ``dvalue_l`` float32 [B, h*w, H, D], the first
    result of ``msda.msda_bwd_win_plain``, in a zeroed buffer of its own.
    With ``out``, a float32 [B, h*w, H, D] view contiguous within a batch
    (the level's slice of the layer's gradient), the kernel adds into it and
    returns it instead. :func:`msda_bwd_win_value_pp`'s kernel and launch,
    whose every point reads its tile's band; float32 vector reductions, so
    the last bits vary from run to run. ``value_l`` gives the shape and
    dtype only."""
    outs, launched = _bwd_win_launch("msda_bwd_win_value", False, False,
                                     value_l, bidx, ix, iy_band, aw_eff, g, h,
                                     w, win, segs, Q, out)
    _count("msda_bwd_win_value", launched)
    return outs[0]


def msda_bwd_win_value_pp(value_l: torch.Tensor, bidx: torch.Tensor,
                          ix: torch.Tensor, iy_band: torch.Tensor,
                          aw_eff: torch.Tensor, g: torch.Tensor, h: int,
                          w: int, win: int, segs: Segments, Q: int,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`msda_bwd_win_value` with one band per (sampling point, query
    tile) (``bidx`` [B, H, P, T])."""
    outs, launched = _bwd_win_launch("msda_bwd_win_value_pp", True, False,
                                     value_l, bidx, ix, iy_band, aw_eff, g, h,
                                     w, win, segs, Q, out)
    _count("msda_bwd_win_value_pp", launched)
    return outs[0]


def msda_bwd_win(value_l: torch.Tensor, bidx: torch.Tensor, ix: torch.Tensor,
                 iy_band: torch.Tensor, aw_eff: torch.Tensor, g: torch.Tensor,
                 h: int, w: int, win: int, segs: Segments, Q: int,
                 out: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Both banded backward kernels of one level, per tile or per point as
    ``bidx`` says: ``(dvalue_l, dix, diy, daw)``, the contract of
    ``msda.msda_bwd_win_plain``. With ``out`` (see
    :func:`msda_bwd_win_value`) the value kernel adds into it, and it is
    returned as ``dvalue_l``."""
    per_point = bidx.dim() == 4
    args = (value_l, bidx, ix, iy_band, aw_eff, g, h, w, win, segs, Q)
    value = msda_bwd_win_value_pp if per_point else msda_bwd_win_value
    rows = msda_bwd_win_rows_pp if per_point else msda_bwd_win_rows
    return (value(*args, out=out), *rows(*args))


# The matcher's assignment kernel (lsap.cu), two routes: "warp" (one block
# an image stages its cost, transposed, into shared memory; one warp
# searches) and "cluster" (a thread-block cluster an image, each block a
# slice of the columns, the slots of its warps' minima read through
# distributed shared memory).
LSAP_MAX_G = 1024           # LSAP_MAX_G: the shared-memory row state
LSAP_SMEM_BYTES = 227 * 1024  # LSAP_MAX_SMEM: a block's shared memory
LSAP_STAGE_THREADS = 256    # LSAP_STAGE_THREADS: warp route, staging
LSAP_CLUSTER_THREADS = 256  # LSAP_CLUSTER_THREADS: cluster route
LSAP_MAX_CLUSTER = 16       # the card's largest (non-portable) cluster
LSAP_CAND_BYTES = 16 * 2 * (LSAP_CLUSTER_THREADS // 32)  # the slots
# columns a thread: the kernels' templates, by route
LSAP_WARP_CPTS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 20, 24, 28, 32)
LSAP_CLUSTER_CPTS = (1, 2, 3, 4, 6, 8, 12, 16)
LSAP_MAX_Q = LSAP_MAX_CLUSTER * LSAP_CLUSTER_THREADS * LSAP_CLUSTER_CPTS[-1]
LSAP_ROUTES = ("warp", "cluster")


@dataclass(frozen=True)
class LsapGeometry:
    """The launch of ``lsap`` for cost [B, Q, G]; the fields after
    ``route`` go to the kernel as an int array, in their order, with the
    route's index first (``geometry_ok`` in lsap.cu re-checks them)."""

    route: str     # "warp" or "cluster"
    cluster: int   # blocks an image (1 on the warp route)
    threads: int   # a block's
    cpt: int       # columns a searching thread
    width: int     # columns a block (Q on the warp route)
    pitch: int     # floats between two staged costT rows
    rows: int      # costT rows a block holds in shared memory
    smem: int      # dynamic shared-memory bytes a block

    @cached_property
    def c_array(self):
        values = (LSAP_ROUTES.index(self.route), self.cluster, self.threads,
                  self.cpt, self.width, self.pitch, self.rows, self.smem)
        return (ctypes.c_int * len(values))(*values)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _fewest(cpts: Tuple[int, ...], need: int) -> Optional[int]:
    return next((c for c in cpts if c >= need), None)


def lsap_warp_smem(Q: int, G: int) -> int:
    """Shared-memory bytes of the warp route: costT [G, Q | 1] float32, row4col
    [Q], and the row state (u, reach, col4row, the visited marks and the
    reached rows' paths) [G]."""
    return 4 * G * (Q | 1) + 4 * Q + 20 * G


def lsap_cluster_smem(width: int, pitch: int, rows: int, G: int) -> int:
    """Shared-memory bytes of a cluster block: the warps' slots (two sets),
    ``rows`` costT rows of ``pitch`` floats, row4col over its ``width``
    columns, the row state."""
    return LSAP_CAND_BYTES + 4 * rows * pitch + 4 * width + 20 * G


def lsap_geometry(B: int, Q: int, G: int) -> LsapGeometry:
    """The launch of ``lsap`` for cost [B, Q, G] (``B`` only sizes the
    grid). The warp route where the image's cost, transposed, fits in a
    block's shared memory beside the search state and one warp's lanes
    cover Q with a template's columns; else the cluster route with the
    fewest blocks (up to 16) whose slices hold all G rows in shared memory,
    or 16 blocks holding as many rows as fit (the others are read from
    global memory)."""
    if not 1 <= Q <= LSAP_MAX_Q:
        raise ValueError(f"lsap takes 1..{LSAP_MAX_Q} queries, got {Q}")
    if not 0 <= G <= min(Q, LSAP_MAX_G):
        raise ValueError(f"lsap needs 0 <= G <= Q (at least as many queries "
                         f"as padded targets) and G <= {LSAP_MAX_G}, got "
                         f"G={G}, Q={Q}")
    del B  # one block, or one cluster, an image
    cpt = _fewest(LSAP_WARP_CPTS, -(-Q // 32))
    smem = _round_up(lsap_warp_smem(Q, G), 16)
    if cpt is not None and smem <= LSAP_SMEM_BYTES:
        return LsapGeometry("warp", 1, LSAP_STAGE_THREADS, cpt, Q, Q | 1, G,
                            smem)
    best = None
    for cluster in range(1, LSAP_MAX_CLUSTER + 1):
        width = -(-Q // cluster)
        if width * (cluster - 1) >= Q:
            continue  # a block without columns
        cpt = _fewest(LSAP_CLUSTER_CPTS, -(-width // LSAP_CLUSTER_THREADS))
        if cpt is None:
            continue
        pitch = _round_up(width, 32) + 1
        room = LSAP_SMEM_BYTES - lsap_cluster_smem(width, pitch, 0, G)
        rows = min(G, max(0, room // (4 * pitch)))
        best = LsapGeometry(
            "cluster", cluster, LSAP_CLUSTER_THREADS, cpt, width, pitch, rows,
            _round_up(lsap_cluster_smem(width, pitch, rows, G), 16))
        if rows == G:
            break
    if best is None or best.smem > LSAP_SMEM_BYTES:
        raise ValueError(f"lsap has no launch for Q={Q}, G={G}")
    return best


def check_inputs_lsap(cost: torch.Tensor, num_boxes: torch.Tensor) -> None:
    """Raise on anything ``lsap`` does not take (device aside)."""
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    if cost.dim() != 3:
        raise ValueError(f"cost must be [B,Q,G], got {tuple(cost.shape)}")
    B, Q, G = cost.shape
    if Q:
        lsap_geometry(B, Q, G)
    elif G:
        raise ValueError("need at least as many queries as (padded) targets")
    if num_boxes.dtype != torch.int32:
        raise TypeError(f"num_boxes must be int32, got {num_boxes.dtype}")
    if tuple(num_boxes.shape) != (B,):
        raise ValueError(f"num_boxes must be [{B}], got "
                         f"{tuple(num_boxes.shape)}")
    for name, t in (("cost", cost), ("num_boxes", num_boxes)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cost.numel() >= 2 ** 31:
        raise ValueError("tensors of 2**31 or more elements are not supported")


def lsap(cost: torch.Tensor, num_boxes: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the assignment kernel: same contract as
    ``matcher.lsap_plain`` (``query_index`` [B, G] int64, ``matching_cost``
    [B, G] float32, ``gt_index`` [B, Q] int64), for cost [B, Q, G] float32
    and num_boxes [B] int32 on one card."""
    _one_cuda_device("lsap", (cost, num_boxes))
    check_inputs_lsap(cost, num_boxes)
    B, Q, G = cost.shape
    dev = cost.device
    query_index = torch.empty((B, G), dtype=torch.int64, device=dev)
    matching_cost = torch.empty((B, G), dtype=torch.float32, device=dev)
    gt_index = torch.empty((B, Q), dtype=torch.int64, device=dev)
    if B == 0 or Q == 0:  # nothing to solve (Q == 0 leaves G == 0)
        return query_index, matching_cost, gt_index
    geom = lsap_geometry(B, Q, G)
    fn = _function("lsap")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(cost.data_ptr(), num_boxes.data_ptr(),
                query_index.data_ptr(), matching_cost.data_ptr(),
                gt_index.data_ptr(), B, Q, G, geom.c_array, stream)
    if rc != 0:
        raise RuntimeError(f"lsap kernel launch failed: CUDA error {rc}")
    _count("lsap")
    return query_index, matching_cost, gt_index


# The trunk's frozen-BN epilogue (frozen_bn.cu): one pass over a
# channels_last map in 16-byte vectors of one pixel's channels.
FBN_THREADS = 256   # FBN_THREADS in frozen_bn.cu
FBN_UNROLL = 4      # FBN_UNROLL: vectors a thread, all loaded before use
FBN_VEC_BYTES = 16  # FBN_VEC_BYTES: a vector


@dataclass(frozen=True)
class FrozenBnGeometry:
    """The launch of ``frozen_bn`` on a map; the fields go to the kernel as
    an int array, in their order (``geometry_ok`` in frozen_bn.cu re-checks
    them). Vector v holds elements [v * vec, v * vec + vec) of the map, the
    channels from (v % (C / vec)) * vec, and falls to thread v % threads of
    block v // (threads * unroll)."""

    vec: int      # channels a vector
    unroll: int   # vectors a thread
    threads: int  # a block's
    blocks: int

    @cached_property
    def c_array(self):
        values = astuple(self)
        return (ctypes.c_int * len(values))(*values)


def frozen_bn_geometry(numel: int, C: int,
                       element_size: int) -> FrozenBnGeometry:
    """The launch of ``frozen_bn`` on a map of ``numel`` (> 0) elements and
    ``C`` channels: 16-byte vectors, four float32 channels or eight
    bfloat16, so C % 4 == 0 in float32 and C % 8 == 0 in bfloat16."""
    vec = FBN_VEC_BYTES // element_size
    if C % vec:
        raise ValueError(f"frozen_bn takes C % {vec} == 0 at "
                         f"{element_size}-byte elements, got C={C}")
    per_block = FBN_THREADS * FBN_UNROLL
    return FrozenBnGeometry(vec, FBN_UNROLL, FBN_THREADS,
                            -(-(numel // vec) // per_block))


def check_inputs_frozen_bn(x: torch.Tensor, params: Sequence[torch.Tensor],
                           residual: Optional[torch.Tensor],
                           residual_params: Optional[Sequence[torch.Tensor]],
                           out: Optional[torch.Tensor]
                           ) -> Optional[FrozenBnGeometry]:
    """Raise on anything ``frozen_bn`` does not take (device aside);
    returns its launch (None for an empty map)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [N,C,H,W], got {tuple(x.shape)}")
    if residual_params is not None and residual is None:
        raise ValueError("residual_params without a residual")
    maps = {"x": x, "residual": residual, "out": out}
    for name, t in maps.items():
        if t is None:
            continue
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must have x's dtype {x.dtype}, got "
                            f"{t.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"{name} must be {tuple(x.shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name} must be channels_last-contiguous")
    C = x.shape[1]
    for group in (params, residual_params):
        if group is None:
            continue
        if len(group) != 4:
            raise ValueError("a norm's parameters are (weight, bias, "
                             "running_mean, running_var)")
        for t in group:
            if t.dtype != torch.float32:
                raise TypeError(f"a norm's parameters must be float32, got "
                                f"{t.dtype}")
            if tuple(t.shape) != (C,) or not t.is_contiguous():
                raise ValueError(f"a norm's parameters must be contiguous "
                                 f"[{C}], got {tuple(t.shape)}")
    if x.numel() >= 2 ** 31:
        raise ValueError("tensors of 2**31 or more elements are not supported")
    if residual is not None and out is not None and (
            out.data_ptr() == residual.data_ptr()):
        raise ValueError("out must not be the residual")
    if x.numel() == 0:
        return None
    geom = frozen_bn_geometry(x.numel(), C, x.element_size())
    vec_bytes = geom.vec * x.element_size()
    for name, t in maps.items():
        if t is not None and t.data_ptr() % vec_bytes:
            raise ValueError(f"{name} must be {vec_bytes}-byte aligned")
    return geom


def frozen_bn(x: torch.Tensor, params: Sequence[torch.Tensor],
              residual: Optional[torch.Tensor] = None,
              residual_params: Optional[Sequence[torch.Tensor]] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the frozen-BN epilogue: relu(bn(x) [+ bn_r(residual) |
    + residual]) for a channels_last map x [N, C, H, W] of float32 (C % 4
    == 0) or bfloat16 (C % 8 == 0), ``params`` (weight, bias, running_mean,
    running_var) [C] float32 of x's norm and ``residual_params`` of the
    residual's, bit for bit what ``backbone.frozen_bn_act_plain``
    computes, into ``out`` (a new map if None; x itself may be given)."""
    tensors = [t for t in (x, *params, residual, *(residual_params or ()),
                           out) if t is not None]
    _one_cuda_device("frozen_bn", tensors)
    _refuse_grad("frozen_bn", tensors)
    geom = check_inputs_frozen_bn(x, params, residual, residual_params, out)
    if out is None:
        out = torch.empty_like(x, memory_format=torch.channels_last)
    if geom is None:
        return out
    mode = 0 if residual is None else 1 if residual_params is None else 2
    pointers = [None if t is None else t.data_ptr()
                for t in (x, *params, residual,
                          *(residual_params or (None,) * 4))]
    fn = _function("frozen_bn")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*pointers, out.data_ptr(), x.numel(), x.shape[1],
                int(x.dtype == torch.bfloat16), mode, geom.c_array, stream)
    if rc != 0:
        raise RuntimeError(f"frozen_bn kernel launch failed: CUDA error {rc}")
    _count("frozen_bn")
    return out
