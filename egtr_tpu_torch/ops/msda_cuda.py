"""Wrappers, build step and launch counters of the hand-written MSDA kernels.

Six kernels, in four sources under ``egtr_tpu_torch/csrc``, replace the JAX
package's Pallas kernels:

- ``msda_fwd`` (``msda_fwd.cu``) replaces ``msda_pallas.py:_fwd_kernel``;
- ``msda_bwd_rows`` (``msda_bwd.cu``) replaces ``_bwd_rows_kernel``: the
  gradients of the sampling locations and the attention weights;
- ``msda_bwd_value`` (``msda_bwd.cu``) replaces ``_bwd_dvtt_kernel``: the
  gradient of the values, summed over the queries with float32 atomics;
- ``msda_fwd_q`` (``msda_fwd_q.cu``) replaces the int8 branch of
  ``_fwd_body``: the forward with an integer stage 1;
- ``msda_fwd_win`` and ``msda_fwd_win_pp`` (``msda_fwd_win.cu``) replace
  ``_fwd_kernel_win`` and ``_fwd_kernel_win_pp``: one banded level with one
  band per query tile, or one per (sampling point, tile), each with float32,
  bfloat16 or int8 values.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``. The libraries are built
at first use from the sources in the checkout, all ``nvcc`` processes started
together, into ``build/`` at the repository root, each under a name keyed by
a hash of its source and the compiler flags, so an edited source is rebuilt.

There is no fallback: if ``nvcc`` is missing or a build fails, a call on
CUDA tensors raises. The plain versions (``msda.ms_deform_attn_plain``,
``msda.ms_deform_attn_plain_bwd``, ``msda.msda_fwd_q_plain``,
``msda.msda_fwd_win_plain``) run for CPU tensors, or where the caller asks
for them by name, through the dispatch in ``msda.ms_deform_attn``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
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
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_LEVELS = 8  # MSDA_MAX_LEVELS in the sources
MAX_SEGMENTS = 8  # MSDA_MAX_SEGMENTS in msda_fwd_win.cu

# Kernel launches since each count was last set to 0; a wrapper raises its
# kernel's count by one per launch and nowhere else. chip_smoke.py reads them
# to show that the main path went through the kernels.
launches = 0            # msda_fwd
bwd_rows_launches = 0   # msda_bwd_rows
bwd_value_launches = 0  # msda_bwd_value
fwd_q_launches = 0      # msda_fwd_q
fwd_win_launches = 0    # msda_fwd_win (float and int8 forms)
fwd_win_pp_launches = 0  # msda_fwd_win_pp (float and int8 forms)

_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def sources() -> Dict[str, Path]:
    """Library name -> its source."""
    return {"msda_fwd": SOURCE, "msda_bwd": SOURCE_BWD,
            "msda_fwd_q": SOURCE_Q, "msda_fwd_win": SOURCE_WIN}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and in {cuda_home}/bin): the "
            "MSDA CUDA kernel cannot be built")
    return nvcc


def library_path(name: str = "msda_fwd") -> Path:
    """Where a built library lives: keyed by its source and the flags."""
    key = hashlib.sha256(sources()[name].read_bytes()
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


_VOID_P, _INT = ctypes.c_void_p, ctypes.c_int
_WIN_ARGS = ([_VOID_P] * 6 + [ctypes.POINTER(_INT)] + [_INT] * 11
             + [ctypes.c_long, _INT, _VOID_P])
# per exported function: its library and its C argument types
_FUNCTIONS = {
    "msda_fwd": ("msda_fwd", [_VOID_P] * 4 + [ctypes.POINTER(_INT)]
                 + [_INT] * 10 + [_VOID_P]),
    "msda_fwd_q": ("msda_fwd_q", [_VOID_P] * 5 + [ctypes.POINTER(_INT)]
                   + [_INT] * 9 + [_VOID_P]),
    "msda_fwd_win": ("msda_fwd_win", _WIN_ARGS),
    "msda_fwd_win_pp": ("msda_fwd_win", _WIN_ARGS),
    "msda_bwd_rows": ("msda_bwd", [_VOID_P] * 6 + [ctypes.POINTER(_INT)]
                      + [_INT] * 8 + [_VOID_P]),
    "msda_bwd_value": ("msda_bwd", [_VOID_P] * 4 + [ctypes.POINTER(_INT)]
                       + [_INT] * 8 + [_VOID_P]),
}


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
                dtype: torch.dtype) -> List[int]:
    """Per level (h, w, start token, round the y weights) for the kernel."""
    table, start = [], 0
    for h, w in spatial_shapes:
        round_y = dtype != torch.float32 and _orient(h, w, D) == "y"
        table += [h, w, start, int(round_y)]
        start += h * w
    return table


def _one_cuda_device(name: str, tensors) -> None:
    if any(t.device.type != "cuda" for t in tensors) or len(
            {t.device for t in tensors}) != 1:
        raise ValueError(f"{name} takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")


def _levels_arg(spatial_shapes, D: int, dtype: torch.dtype):
    table = level_table(spatial_shapes, D, dtype)
    return (ctypes.c_int * len(table))(*table)


def _check_levels(levels, L: int) -> Tuple[int, ...]:
    levels = tuple(range(L)) if levels is None else tuple(
        int(l) for l in levels)
    if not levels or len(set(levels)) != len(levels) or not all(
            0 <= l < L for l in levels):
        raise ValueError(f"levels must be distinct indices into the {L} "
                         f"levels, got {levels}")
    return levels


def _fwd_levels_arg(spatial_shapes, D: int, levels: Tuple[int, ...],
                    rounds: bool):
    """Per summed level (h, w, start token, round the y weights, index into
    the L axis of the locations) for the forward kernels. ``rounds``: stage 1
    rounds its hats at all (a low-precision dtype, or int8), and then those
    of y on a level that contracts y."""
    starts = level_starts(spatial_shapes)
    table = []
    for lid in levels:
        h, w = spatial_shapes[lid]
        round_y = rounds and _orient(h, w, D) == "y"
        table += [h, w, starts[lid], int(round_y), lid]
    return (ctypes.c_int * len(table))(*table)


def _refuse_grad(name: str, tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is the bare forward kernel and has no backward of its "
            "own; call msda.ms_deform_attn where a gradient is needed")


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
    global launches
    tensors = (value, sampling_locations, attention_weights)
    _one_cuda_device("msda_fwd", tensors)
    _refuse_grad("msda_fwd", tensors)
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
        return out
    table = _fwd_levels_arg(spatial_shapes, D, levels,
                            value.dtype != torch.float32)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), out.data_ptr(),
                table, len(levels), L, B, S, Q, H, D, P,
                int(value.dtype == torch.bfloat16),
                int(out_dtype == torch.float32), stream)
    if rc != 0:
        raise RuntimeError(f"msda_fwd kernel launch failed: CUDA error {rc}")
    launches += 1
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


def msda_fwd_q(vq: torch.Tensor, scale: torch.Tensor,
               spatial_shapes: Sequence[Tuple[int, int]],
               sampling_locations: torch.Tensor,
               attention_weights: torch.Tensor,
               levels: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Launch the int8-stage-1 forward kernel: the contract of
    ``msda.msda_fwd_q_plain`` (``(vq, scale)`` from
    ``msda.quantize_levels``; float32 [B, Q, H*D] out)."""
    global fwd_q_launches
    tensors = (vq, scale, sampling_locations, attention_weights)
    _one_cuda_device("msda_fwd_q", tensors)
    _refuse_grad("msda_fwd_q", tensors)
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    check_inputs_q(vq, scale, spatial_shapes, sampling_locations,
                   attention_weights)
    B, S, H, D = vq.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    levels = _check_levels(levels, L)
    fn = _function("msda_fwd_q")
    out = torch.empty((B, Q, H * D), dtype=torch.float32, device=vq.device)
    if out.numel() == 0:
        return out
    table = _fwd_levels_arg(spatial_shapes, D, levels, True)
    with torch.cuda.device(vq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(vq.data_ptr(), scale.data_ptr(),
                sampling_locations.data_ptr(), attention_weights.data_ptr(),
                out.data_ptr(), table, len(levels), L, B, S, Q, H, D, P,
                int(attention_weights.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"msda_fwd_q kernel launch failed: CUDA error {rc}")
    fwd_q_launches += 1
    return out


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
    """Check, allocate and launch for both banded kernels; returns the
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
    with torch.cuda.device(value_l.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(value_l.data_ptr(), bidx.data_ptr(), ix.data_ptr(),
                iy_band.data_ptr(), aw_eff.data_ptr(), out.data_ptr(),
                (ctypes.c_int * len(table))(*table), len(segs), B, Q, Qp, H,
                D, P, h, w, win, TQ, value_l.stride(0),
                _WIN_VTYPES[value_l.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return out, True


def msda_fwd_win(value_l: torch.Tensor, bidx: torch.Tensor, ix: torch.Tensor,
                 iy_band: torch.Tensor, aw_eff: torch.Tensor, h: int, w: int,
                 win: int, segs: Segments, Q: int) -> torch.Tensor:
    """Launch the banded kernel with one band per query tile (``bidx``
    [B, H, T]): the contract of ``msda.msda_fwd_win_plain``, float32
    [B, Q, H*D] out. int8 values select the kernel's int8 form."""
    global fwd_win_launches
    out, launched = _fwd_win("msda_fwd_win", False, value_l, bidx, ix,
                             iy_band, aw_eff, h, w, win, segs, Q)
    if launched:
        fwd_win_launches += 1
    return out


def msda_fwd_win_pp(value_l: torch.Tensor, bidx: torch.Tensor,
                    ix: torch.Tensor, iy_band: torch.Tensor,
                    aw_eff: torch.Tensor, h: int, w: int, win: int,
                    segs: Segments, Q: int) -> torch.Tensor:
    """Launch the banded kernel with one band per (sampling point, query
    tile) (``bidx`` [B, H, P, T]): the contract of
    ``msda.msda_fwd_win_plain``, float32 [B, Q, H*D] out. int8 values select
    the kernel's int8 form."""
    global fwd_win_pp_launches
    out, launched = _fwd_win("msda_fwd_win_pp", True, value_l, bidx, ix,
                             iy_band, aw_eff, h, w, win, segs, Q)
    if launched:
        fwd_win_pp_launches += 1
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
                  attention_weights: torch.Tensor, grad_output: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the row-gradient kernel: ``(dloc [B,Q,H,L,P,2] float32,
    daw [B,Q,H,L,P] in the weights' dtype)``, as the last two results of
    ``msda.ms_deform_attn_plain_bwd``. Deterministic."""
    global bwd_rows_launches
    spatial_shapes = _bwd_args("msda_bwd_rows", value, spatial_shapes,
                               sampling_locations, attention_weights,
                               grad_output)
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    fn = _function("msda_bwd_rows")
    dloc = torch.empty_like(sampling_locations)
    daw = torch.empty_like(attention_weights)
    if daw.numel() == 0:
        return dloc, daw
    levels = _levels_arg(spatial_shapes, D, value.dtype)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(value.data_ptr(), sampling_locations.data_ptr(),
                attention_weights.data_ptr(), grad_output.data_ptr(),
                dloc.data_ptr(), daw.data_ptr(), levels, L, B, S, Q, H, D, P,
                int(value.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(
            f"msda_bwd_rows kernel launch failed: CUDA error {rc}")
    bwd_rows_launches += 1
    return dloc, daw


def msda_bwd_value(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor, grad_output: torch.Tensor
                   ) -> torch.Tensor:
    """Launch the value-gradient kernel: ``dvalue [B,S,H,D]`` in the value
    dtype, as the first result of ``msda.ms_deform_attn_plain_bwd``.

    The kernel adds into a zeroed float32 buffer with atomics, which is cast
    to the value dtype once at the end; the order of the additions, and with
    it the last bits of the float32 sums, varies from run to run. ``value``
    gives the shape and dtype only: the kernel does not read it.
    """
    global bwd_value_launches
    spatial_shapes = _bwd_args("msda_bwd_value", value, spatial_shapes,
                               sampling_locations, attention_weights,
                               grad_output)
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    fn = _function("msda_bwd_value")
    acc = torch.zeros((B, S, H, D), dtype=torch.float32, device=value.device)
    if acc.numel() == 0 or Q == 0:
        return acc.to(value.dtype)
    levels = _levels_arg(spatial_shapes, D, value.dtype)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(sampling_locations.data_ptr(), attention_weights.data_ptr(),
                grad_output.data_ptr(), acc.data_ptr(), levels, L, B, S, Q, H,
                D, P, int(value.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(
            f"msda_bwd_value kernel launch failed: CUDA error {rc}")
    bwd_value_launches += 1
    return acc.to(value.dtype)


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
