"""Dequantize — the hand-written CUDA kernel's launcher.

The kernel (``csrc/dequant.cu``) replaces the TPU kernel
``repro.kernels.dequant.kernel.dequant_call``.  It streams the flat
row-major ``(R, C)`` int8 array with 16-byte loads, takes each value's
column scale and writes bf16 or f32 in one pass; it masks the ragged tail
itself, so nothing is padded.  A base pointer that is not 16-byte aligned
(a view with a storage offset) takes the kernel's scalar loop.  The library
is built from the source at first launch (``repro_torch.kernels._build``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build

__all__ = ["dequant_call", "launches"]

# kernel launches in this process; the smoke run reads it to show that a
# caller went through the kernel
launches = 0
_launches_lock = threading.Lock()

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("dequant")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dequant.argtypes = [p, p, p, ctypes.c_longlong, i, i, p]
    lib.dequant.restype = i
    lib.dequant_error_string.argtypes = [i]
    lib.dequant_error_string.restype = ctypes.c_char_p
    return lib


def dequant_call(
    x: torch.Tensor,  # (R, C) int8, contiguous CUDA
    scale: torch.Tensor,  # (C,) float32, contiguous
    *,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Launch on x's current stream; returns the ``(R, C)`` output."""
    global launches
    if not (x.is_cuda and scale.is_cuda and x.device == scale.device):
        raise ValueError("dequant_call takes CUDA tensors on one device")
    if x.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"x must be int8 and scale float32, got {x.dtype}/{scale.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {list(_OUT_DTYPES)}, got {out_dtype}")
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"x {tuple(x.shape)} and scale {tuple(scale.shape)} are not (R, C) and (C,)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("x and scale must be contiguous")
    R, C = x.shape
    if C >= 2**31:
        raise ValueError(f"{C} columns do not fit the kernel's 32-bit column index")
    out = torch.empty((R, C), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.dequant(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), R, C,
            _OUT_DTYPES[out_dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
        with _launches_lock:
            launches += 1
    if rc != 0:
        msg = lib.dequant_error_string(rc).decode()
        raise RuntimeError(f"dequant launch failed: {msg} (cuda error {rc})")
    return out
