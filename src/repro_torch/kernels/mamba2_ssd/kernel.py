"""Mamba2 SSD scan — the hand-written CUDA kernel's launcher.

The kernel (``csrc/mamba2_ssd.cu``) replaces the TPU kernel
``repro.kernels.mamba2_ssd.kernel.ssd_call``.  One call runs three device
kernels, chunk-parallel: each chunk's own state, the state passing over the
chunks, each chunk's outputs.  The dtype chooses the route (``ROUTES``):
bf16 runs the products on the tensor cores, f32 on the CUDA cores.  The
launcher allocates the f32 scratch the passes hand over (``scratch_shapes``).
It masks a ragged last chunk itself, so S need not be a multiple of the
chunk.  The library is built from the source at first launch
(``repro_torch.kernels._build``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["ROUTES", "WIDTHS", "check_inputs", "grid_blocks", "route", "scratch_shapes", "ssd_call", "launches"]

# calls in this process (one a call, whatever its passes), in all and by
# route; the smoke run reads them to show that the serve path went through
# the kernel
launches = 0
launches_by_route = {"tensor_core": 0, "cuda_core": 0}
_launches_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the device kernels each dtype launches
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
_TILE = 64  # query steps a pass-3 tensor-core block holds
_HEADS = 2  # heads a pass-3 tensor-core block shares C·Bᵀ among
# (head dim P, state N) pairs the kernel is built for: zamba2-1.2b,
# mamba2-780m, and their reduced configs
WIDTHS = ((64, 64), (64, 128), (32, 16))


def route(dtype: torch.dtype) -> str:
    """The device kernels that x's dtype launches: ``"tensor_core"`` (bf16)
    or ``"cuda_core"`` (f32)."""
    if dtype not in ROUTES:
        raise TypeError(f"the kernel takes {list(ROUTES)}, got {dtype}")
    return ROUTES[dtype]


def scratch_shapes(B: int, S: int, H: int, P: int, N: int, chunk: int) -> Dict[str, Tuple[int, ...]]:
    """The f32 scratch one call allocates: the prefix sums ``cs``, the
    chunk states (each chunk's own, then its carry-in) and ``exp(cs_last)``
    of each chunk."""
    nc = -(-S // chunk)
    return {"cs": (B, H, S), "states": (B, nc, H, P, N), "decay": (B, nc, H)}


def grid_blocks(B: int, S: int, H: int, P: int, N: int, chunk: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """Blocks each pass launches: chunk states (one per chunk and head),
    state passing (256 threads, one per state entry) and chunk outputs (one
    per 64-step query tile, chunk and head pair in bf16; one per chunk and
    head in f32).  Pass 3's count is its grid: query tiles past a ragged
    last chunk exit at once."""
    nc = -(-S // chunk)
    if route(dtype) == "tensor_core":
        third = -(-chunk // _TILE) * nc * -(-H // _HEADS) * B
    else:
        third = nc * H * B
    return nc * H * B, -(-(B * H * P * N) // 256), third


def check_inputs(xh, dt, A, Bm, Cm, *, chunk: int) -> Tuple[int, int, int, int, int]:
    """The launcher's host-side checks of everything but the device:
    dtypes, shapes, contiguity, chunk, widths and (bf16) alignment.
    Returns ``(B, S, H, P, N)``; raises on what the kernel does not take."""
    tensors = (xh, dt, A, Bm, Cm)
    if xh.dtype not in ROUTES or Bm.dtype != xh.dtype or Cm.dtype != xh.dtype:
        raise TypeError(f"xh, Bm and Cm must share one of {list(ROUTES)}")
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
    if ROUTES[xh.dtype] == "tensor_core" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("bf16 inputs must start on a 16-byte boundary (the kernel copies 16-byte pieces)")
    return B, S, H, P, N


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba2_ssd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mamba2_ssd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
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
    if not all(t.is_cuda and t.device == xh.device for t in (xh, dt, A, Bm, Cm)):
        raise ValueError("ssd_call takes CUDA tensors on one device")
    B, S, H, P, N = check_inputs(xh, dt, A, Bm, Cm, chunk=chunk)
    y = torch.empty_like(xh)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    # the scratch in one allocation, each part 16-byte aligned
    sizes = [-(-math.prod(shape) // 4) * 4 for shape in scratch_shapes(B, S, H, P, N, chunk).values()]
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=xh.device)
    cs_ptr = scratch.data_ptr()
    states_ptr = cs_ptr + 4 * sizes[0]
    decay_ptr = states_ptr + 4 * sizes[1]
    lib = _lib()
    with torch.cuda.device(xh.device):
        rc = lib.mamba2_ssd(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), h.data_ptr(), cs_ptr, states_ptr, decay_ptr, B, S, H, P, N, chunk,
            _DTYPES[xh.dtype], torch.cuda.current_stream(xh.device).cuda_stream,
        )
        with _launches_lock:
            launches += 1
            launches_by_route[ROUTES[xh.dtype]] += 1
    if rc != 0:
        msg = lib.mamba2_ssd_error_string(rc).decode()
        raise RuntimeError(f"mamba2_ssd launch failed: {msg} (cuda error {rc})")
    return y, h
