"""Flash attention — the hand-written CUDA kernel's launcher.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_call``.  It reads
q, k and v in the model layout, ``(B, S, H, hd)`` and ``(B, S, KV, hd)``,
folds the ``G = H / KV`` query heads of one KV head into one block, masks
the ragged tail itself (no padding) and writes the output in q's layout and
dtype.  The library is built from the source at first launch
(``repro_torch.kernels._build``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention_call", "query_block", "launches"]

# kernel launches in this process; the smoke run reads it to show that the
# serve path went through the kernel
launches = 0
_launches_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = 64  # query rows a block holds (G heads x query_block positions)
HEAD_DIMS = (16, 32, 64, 128)  # the head widths the kernel is built for


def query_block(G: int) -> int:
    """Query positions per block: the block holds ``G * query_block(G)`` rows."""
    return max(1, _ROWS // G)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.flash_attention.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_call(
    q: torch.Tensor,  # (B, S, H, hd) contiguous CUDA
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Launch on q's current stream; returns the ``(B, S, H, hd)`` output."""
    global launches
    if not (q.is_cuda and k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError("flash_attention_call takes CUDA tensors on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of {list(_DTYPES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
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
    if hd not in HEAD_DIMS or H // KV > _ROWS:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS} and at most {_ROWS} query heads per KV head")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    qb = query_block(H // KV)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, KV, hd, qb, int(bool(causal)), int(window), float(scale),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
        with _launches_lock:
            launches += 1
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} (cuda error {rc})")
    return out
