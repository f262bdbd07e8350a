"""Flash attention — the hand-written CUDA kernel's launcher.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_call``.  It reads
q, k and v in the model layout, ``(B, S, H, hd)`` and ``(B, S, KV, hd)``,
folds the ``G = H / KV`` query heads of one KV head into one query tile of
64 or 128 rows (``tile_rows``), masks the ragged tail itself (no padding)
and writes the output in q's layout and dtype.  The dtype chooses the
route (``ROUTES``): bf16 runs both products on the tensor cores (wgmma, K/V
by TMA), f32 on the CUDA cores (the reference's f32 bar takes no bf16 or
TF32 product).  The library of the call's head width is built from the
source at its first launch (``repro_torch.kernels._build``, one library a
width).

The backward (``flash_attention_bwd_call``, bf16 only) takes the forward's
inputs, output and row log-sum-exp (``flash_attention_call(...,
return_lse=True)``) and the output's gradient, and returns dq, dk and dv:
three launches (Δ, dK/dV over key tiles, dQ over query tiles), every
product on the tensor cores.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from repro_torch.kernels import _build

__all__ = [
    "HEAD_DIMS", "MAX_GROUP", "ROUTES", "check_inputs", "flash_attention_bwd_call", "flash_attention_call",
    "query_block", "route", "tile_rows", "launches", "launches_bwd",
]

# kernel launches in this process, in all and by route, and backward calls;
# the smoke run and the benchmark read them to show that the serve and train
# paths went through the kernel
launches = 0
launches_by_route = {"tensor_core": 0, "cuda_core": 0}
launches_bwd = 0
_launches_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the device kernel each dtype launches
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
_ROWS = 64  # query rows of a tile (G heads x query_block positions); 128 on two-warpgroup tiles
# the head widths the kernel is built for: 16 and 32 (the reduced configs),
# 64, 96 (phi3-mini), 128 and 192 (nemotron-4-340b)
HEAD_DIMS = _build.VARIANTS["flash_attention"][1]
MAX_GROUP = _ROWS  # query heads a KV head: a query tile holds at least one position


def query_block(G: int, rows: int = _ROWS) -> int:
    """Query positions per block: the block holds ``G * query_block(G, rows)``
    of its ``rows`` query rows."""
    return max(1, rows // G)


def tile_rows(dtype: torch.dtype, G: int) -> int:
    """Query rows of a block: 128 (two consumer warpgroups sharing each K/V
    tile) on the bf16 wgmma kernel when at least 4 query heads share a KV
    head, so a tile spans at most 32 positions; 64 elsewhere.  On an H100
    the 128-row tile measured faster at 4, 6 and 12 heads a KV head and
    slower at 1, where a 128-position tile does more masked work."""
    return 2 * _ROWS if route(dtype) == "tensor_core" and G >= 4 else _ROWS


def route(dtype: torch.dtype) -> str:
    """The device kernel that q's dtype launches: ``"tensor_core"`` (bf16)
    or ``"cuda_core"`` (f32)."""
    if dtype not in ROUTES:
        raise TypeError(f"the kernel takes {list(ROUTES)}, got {dtype}")
    return ROUTES[dtype]


@functools.lru_cache(maxsize=None)
def _lib(hd: int) -> ctypes.CDLL:
    """The library of head width ``hd`` (one is built a width)."""
    lib = _build.load("flash_attention", hd)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.flash_attention.restype = i
    lib.flash_attention_bwd.argtypes = [p] * 10 + [i] * 8 + [ctypes.c_float, p]
    lib.flash_attention_bwd.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0):
    """The launcher's host-side checks of everything but the device: dtype,
    shapes, contiguity, head width, head group and (bf16) alignment.
    Returns ``(B, S, H, KV, hd)``; raises on what the kernel does not take."""
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of {list(ROUTES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, hd) or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if hd not in HEAD_DIMS or H // KV > MAX_GROUP:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS} and at most {MAX_GROUP} query heads per KV head")
    if ROUTES[q.dtype] == "tensor_core" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bf16 q, k and v must start on a 16-byte boundary (the kernel copies 16-byte pieces)")
    return B, S, H, KV, hd


def flash_attention_call(
    q: torch.Tensor,  # (B, S, H, hd) contiguous CUDA
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    return_lse: bool = False,
):
    """Launch on q's current stream; returns the ``(B, S, H, hd)`` output,
    and with ``return_lse`` (bf16 only) also each row's log-sum-exp of the
    scaled scores, ``(B, H, S)`` in f32, which the backward takes."""
    global launches
    _check_device(q, k, v)
    B, S, H, KV, hd = check_inputs(q, k, v, window=window)
    if return_lse and ROUTES[q.dtype] != "tensor_core":
        raise TypeError("the row log-sum-exp is written on the bf16 route only")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    qb = query_block(H // KV, tile_rows(q.dtype, H // KV))
    lib = _lib(hd)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            B, S, H, KV, hd, qb, int(bool(causal)), int(window), float(scale),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
        with _launches_lock:
            launches += 1
            launches_by_route[ROUTES[q.dtype]] += 1
    _raise_on(lib, rc, "flash_attention")
    return (out, lse) if return_lse else out


def flash_attention_bwd_call(
    q: torch.Tensor,  # (B, S, H, hd) contiguous bf16 CUDA, the forward's inputs
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    out: torch.Tensor,  # (B, S, H, hd), the forward's output
    lse: torch.Tensor,  # (B, H, S) f32, the forward's
    dout: torch.Tensor,  # (B, S, H, hd), the output's gradient
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on q's current stream: returns ``(dq, dk, dv)`` in the
    inputs' shapes and dtype."""
    global launches_bwd
    _check_device(q, k, v, out, lse, dout)
    B, S, H, KV, hd = check_inputs(q, k, v, window=window)
    if ROUTES[q.dtype] != "tensor_core":
        raise TypeError(f"the backward kernel takes bf16, got {q.dtype}")
    check_inputs(dout, k, v, window=window)
    check_inputs(out, k, v, window=window)
    if dout.shape != q.shape or out.shape != q.shape or dout.dtype != q.dtype or out.dtype != q.dtype:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must match q {tuple(q.shape)}")
    if lse.dtype != torch.float32 or lse.shape != (B, H, S) or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 (B, H, S) = {(B, H, S)}, got {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty_like(lse)
    lib = _lib(hd)
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, KV, hd, query_block(H // KV), int(bool(causal)), int(window), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        with _launches_lock:
            launches_bwd += 1
    _raise_on(lib, rc, "flash_attention_bwd")
    return dq, dk, dv


def _check_device(*tensors: torch.Tensor) -> None:
    if not all(t.is_cuda and t.device == tensors[0].device for t in tensors):
        raise ValueError("the flash_attention kernels take CUDA tensors on one device")


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cuda error {rc})")
