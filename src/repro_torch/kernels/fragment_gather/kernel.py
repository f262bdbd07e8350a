"""Fragment row-gather — the hand-written CUDA kernel's launcher.

The kernel (``csrc/fragment_gather.cu``) replaces the TPU kernel
``repro.kernels.fragment_gather.kernel.fragment_gather_call``: output row
tile ``i`` is source row tile ``block_idx[i]``, ``row_block`` rows per tile.
It copies rows as raw bytes, so it serves every dtype bitwise, and it is
bound by device-memory bytes (each gathered byte read once, written once).

This module only launches: index conversion, range checks and the plain
version live in ``ops.py`` and ``ref.py``.  The library is built from the
source at first launch (``repro_torch.kernels._build``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _build

__all__ = ["fragment_gather_call", "launches"]

# kernel launches in this process; the smoke run reads it to show that the
# main path went through the kernel
launches = 0
_launches_lock = threading.Lock()

_WORDS = (16, 8, 4, 2, 1)  # candidate copy widths in bytes, widest first

_DTYPES = (
    torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
    torch.uint8, torch.uint16, torch.uint32, torch.uint64,
    torch.float16, torch.bfloat16, torch.float32, torch.float64,
)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fragment_gather")
    lib.fragment_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.fragment_gather.restype = ctypes.c_int
    lib.fragment_gather_error_string.argtypes = [ctypes.c_int]
    lib.fragment_gather_error_string.restype = ctypes.c_char_p
    return lib


def fragment_gather_call(
    src: torch.Tensor,  # (Ns, C) contiguous CUDA tensor
    block_idx: torch.Tensor,  # (nR,) int32 CUDA: source row TILE per output row tile
    *,
    row_block: int,
    out_rows: int,
) -> torch.Tensor:
    """Launch the gather on ``src``'s current stream; returns the
    ``(out_rows, C)`` output.  Every tile ``block_idx[i]`` must lie wholly
    inside ``src`` — the kernel does not check it (``ops.fragment_gather``
    does, on the host, before it builds the tiles)."""
    global launches
    if not (src.is_cuda and block_idx.is_cuda and src.device == block_idx.device):
        raise ValueError("fragment_gather_call takes CUDA tensors on one device")
    if src.dim() != 2 or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous (Ns, C) tensor, got {tuple(src.shape)}")
    if block_idx.dtype != torch.int32 or block_idx.dim() != 1 or not block_idx.is_contiguous():
        raise ValueError("block_idx must be a contiguous 1-D int32 tensor")
    if src.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {src.dtype}")
    if out_rows % row_block or block_idx.shape[0] != out_rows // row_block:
        raise ValueError("out_rows must be row_block * len(block_idx)")
    C = src.shape[1]
    out = torch.empty((out_rows, C), dtype=src.dtype, device=src.device)
    tile_bytes = row_block * C * src.element_size()
    if out.numel() == 0:
        return out
    word = next(
        w for w in _WORDS
        if src.data_ptr() % w == 0 and out.data_ptr() % w == 0 and tile_bytes % w == 0
    )
    lib = _lib()
    with torch.cuda.device(src.device):
        rc = lib.fragment_gather(
            src.data_ptr(),
            out.data_ptr(),
            block_idx.data_ptr(),
            out_rows * C * src.element_size() // word,
            tile_bytes // word,
            word,
            torch.cuda.current_stream(src.device).cuda_stream,
        )
        with _launches_lock:
            launches += 1
    if rc != 0:
        msg = lib.fragment_gather_error_string(rc).decode()
        raise RuntimeError(f"fragment_gather launch failed: {msg} (cuda error {rc})")
    return out

