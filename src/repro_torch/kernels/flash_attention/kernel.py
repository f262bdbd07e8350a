"""Flash attention — the hand-written CUDA kernel's launcher.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention_call``.  It reads
q, k and v in the model layout, ``(B, S, H, hd)`` and ``(B, S, KV, hd)``,
folds the ``G = H / KV`` query heads of one KV head into one query tile of
64 or 128 rows (``tile_rows``), masks the ragged tail itself (no padding)
and writes the output in q's layout and dtype.  The dtype chooses the
route (``ROUTES``): bf16 runs both products on the tensor cores (wgmma, K/V
by TMA), f32 on the CUDA cores (the reference's f32 bar takes no bf16 or
TF32 product).  The library is built from the source at first launch
(``repro_torch.kernels._build``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build

__all__ = [
    "HEAD_DIMS", "ROUTES", "check_inputs", "flash_attention_call", "query_block", "route", "tile_rows", "launches",
]

# kernel launches in this process, in all and by route; the smoke run reads
# them to show that the serve path went through the kernel
launches = 0
launches_by_route = {"tensor_core": 0, "cuda_core": 0}
_launches_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the device kernel each dtype launches
ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}
_ROWS = 64  # query rows of a tile (G heads x query_block positions); 128 on two-warpgroup tiles
# the head widths the kernel is built for: 16 and 32 (the reduced configs),
# 64, 96 (phi3-mini), 128 and 192 (nemotron-4-340b)
HEAD_DIMS = (16, 32, 64, 96, 128, 192)


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
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.flash_attention.restype = i
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
    if hd not in HEAD_DIMS or H // KV > _ROWS:
        raise ValueError(f"the kernel takes hd in {HEAD_DIMS} and at most {_ROWS} query heads per KV head")
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
) -> torch.Tensor:
    """Launch on q's current stream; returns the ``(B, S, H, hd)`` output."""
    global launches
    if not (q.is_cuda and k.is_cuda and v.is_cuda and q.device == k.device == v.device):
        raise ValueError("flash_attention_call takes CUDA tensors on one device")
    B, S, H, KV, hd = check_inputs(q, k, v, window=window)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    qb = query_block(H // KV, tile_rows(q.dtype, H // KV))
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, KV, hd, qb, int(bool(causal)), int(window), float(scale),
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
        with _launches_lock:
            launches += 1
            launches_by_route[ROUTES[q.dtype]] += 1
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} (cuda error {rc})")
    return out
