"""Wrapper, build step and launch counter of the hand-written MSDA forward kernel.

The kernel (``egtr_tpu_torch/csrc/msda_fwd.cu``) replaces the JAX package's
Pallas forward kernel ``msda_pallas.py:_fwd_kernel``. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes``. The library is built at first use from the sources in
the checkout, into ``build/`` at the repository root, under a name keyed by a
hash of the source and the compiler flags, so an edited source is rebuilt.

There is no fallback: if ``nvcc`` is missing or the build fails, a call on
CUDA tensors raises. The plain version (``msda.ms_deform_attn_plain``) runs
only for CPU tensors, through the dispatch in ``msda.ms_deform_attn``.
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
from typing import List, Sequence, Tuple

import torch

from .msda import _orient

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "msda_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_LEVELS = 8  # MSDA_MAX_LEVELS in the source

# Kernel launches since the count was last set to 0; raised by one per
# launch and nowhere else. chip_smoke.py reads it to show that the main path
# went through the kernel.
launches = 0

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and in {cuda_home}/bin): the "
            "MSDA CUDA kernel cannot be built")
    return nvcc


def library_path() -> Path:
    """Where the built library lives: keyed by the source and the flags."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmsda_fwd-{key}.so"


def build_command(nvcc: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(SOURCE)]


def build() -> Path:
    """Compile the kernel library if this source has not been built yet."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a process building at the
    # same time never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(build_command(_nvcc(), Path(tmp)),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {SOURCE} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.msda_fwd.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)]
                + [ctypes.c_int] * 8 + [ctypes.c_void_p])
            lib.msda_fwd.restype = ctypes.c_int
            _lib = lib
    return _lib


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


def msda_fwd(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
             sampling_locations: torch.Tensor,
             attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: same contract as ``msda.ms_deform_attn``.

    Inference only: it raises where autograd would need a gradient, since
    the backward kernels are not ported yet.
    """
    global launches
    tensors = (value, sampling_locations, attention_weights)
    if any(t.device.type != "cuda" for t in tensors) or len(
            {t.device for t in tensors}) != 1:
        raise ValueError("msda_fwd takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the MSDA CUDA kernel has no backward yet; run under "
            "torch.no_grad() or torch.inference_mode()")
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    check_inputs(value, spatial_shapes, sampling_locations, attention_weights)
    B, S, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    lib = _library()
    out = torch.empty((B, Q, H * D), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    table = level_table(spatial_shapes, D, value.dtype)
    levels = (ctypes.c_int * len(table))(*table)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msda_fwd(value.data_ptr(), sampling_locations.data_ptr(),
                          attention_weights.data_ptr(), out.data_ptr(),
                          levels, L, B, S, Q, H, D, P,
                          int(value.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"msda_fwd kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
