"""Mamba2 SSD scan — the hand-written CUDA kernel's launcher.

The kernel (``csrc/mamba2_ssd.cu``) replaces the TPU kernel
``repro.kernels.mamba2_ssd.kernel.ssd_call``: one block per (head, batch)
walks the chunks in order and carries the state in shared memory.  It masks
a ragged last chunk itself, so S need not be a multiple of the chunk.  The
library is built from the source at first launch
(``repro_torch.kernels._build``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_call", "launches"]

# kernel launches in this process; the smoke run reads it to show that the
# serve path went through the kernel
launches = 0
_launches_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (head dim P, state N) pairs the kernel is built for: zamba2-1.2b,
# mamba2-780m, and their reduced configs
WIDTHS = ((64, 64), (64, 128), (32, 16))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba2_ssd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mamba2_ssd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.mamba2_ssd.restype = i
    lib.mamba2_ssd_error_string.argtypes = [i]
    lib.mamba2_ssd_error_string.restype = ctypes.c_char_p
    return lib


def ssd_call(
    xh: torch.Tensor,  # (B, S, H, P) contiguous CUDA, f32 or bf16
    dt: torch.Tensor,  # (B, S, H) f32
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, S, N), xh's dtype
    Cm: torch.Tensor,  # (B, S, N), xh's dtype
    *,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch on xh's current stream; returns (y (B,S,H,P) in xh's dtype,
    final state (B,H,P,N) f32).  ``chunk`` must not exceed S."""
    global launches
    tensors = (xh, dt, A, Bm, Cm)
    if not all(t.is_cuda and t.device == xh.device for t in tensors):
        raise ValueError("ssd_call takes CUDA tensors on one device")
    if xh.dtype not in _DTYPES or Bm.dtype != xh.dtype or Cm.dtype != xh.dtype:
        raise TypeError(f"xh, Bm and Cm must share one of {list(_DTYPES)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("dt and A must be float32")
    if xh.dim() != 4:
        raise ValueError(f"xh must be (B, S, H, P), got {tuple(xh.shape)}")
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    if dt.shape != (B, S, H) or A.shape != (H,) or Bm.shape != (B, S, N) or Cm.shape != (B, S, N):
        raise ValueError("dt, A, Bm, Cm do not fit xh")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_call takes contiguous tensors")
    if not 0 < chunk <= S:
        raise ValueError(f"chunk {chunk} must lie in [1, S={S}]")
    if (P, N) not in WIDTHS:
        raise ValueError(f"the kernel is built for (P, N) in {WIDTHS}, got {(P, N)}")
    y = torch.empty_like(xh)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    lib = _lib()
    with torch.cuda.device(xh.device):
        rc = lib.mamba2_ssd(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), h.data_ptr(), B, S, H, P, N, chunk,
            _DTYPES[xh.dtype], torch.cuda.current_stream(xh.device).cuda_stream,
        )
        with _launches_lock:
            launches += 1
    if rc != 0:
        msg = lib.mamba2_ssd_error_string(rc).decode()
        raise RuntimeError(f"mamba2_ssd launch failed: {msg} (cuda error {rc})")
    return y, h
