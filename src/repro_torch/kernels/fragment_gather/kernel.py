"""Fragment UNION — the hand-written CUDA kernel's launcher.

The kernel (``csrc/fragment_gather.cu``) replaces the TPU kernel
``repro.kernels.fragment_gather.kernel.fragment_gather_call``.  It copies a
table of byte ranges ``(src address, dst address, bytes)`` in one launch:
every run of every column of one UNION, from all providers, straight into
the preallocated outputs.  Rows move as raw bytes, so it serves every dtype
bitwise, and it is bound by device-memory bytes (each byte read once,
written once).

:func:`chunk_table` cuts the runs where their destination crosses a
multiple of :data:`CHUNK_BYTES` (so that the grid balances), in
O(runs) numpy: no per-row index is built.  :func:`fragment_union_call`
sends the table to the card by one non-blocking copy from pinned host
memory and launches.  :func:`fragment_gather_call`, the reference's
row-tile API, is the same launch with consecutive tiles merged into runs.

This module only launches: range checks and the plain version live in
``ops.py`` and ``ref.py``.  The library is built from the source at first
launch (``repro_torch.kernels._build``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = [
    "CHUNK_BYTES", "chunk_table", "fragment_gather_call", "fragment_union_call",
    "launch_table", "launches", "tile_runs",
]

# kernel launches in this process; the smoke run reads it to show that the
# main path went through the kernel
launches = 0
_launches_lock = threading.Lock()

CHUNK_BYTES = 32 << 10  # the most one table entry moves: kChunk in the source

_DTYPES = (
    torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
    torch.uint8, torch.uint16, torch.uint32, torch.uint64,
    torch.float16, torch.bfloat16, torch.float32, torch.float64,
)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fragment_gather")
    lib.fragment_union.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.fragment_union.restype = ctypes.c_int
    lib.fragment_gather_error_string.argtypes = [ctypes.c_int]
    lib.fragment_gather_error_string.restype = ctypes.c_char_p
    if lib.fragment_union_chunk_bytes() != CHUNK_BYTES:
        raise RuntimeError("fragment_gather.cu's kChunk differs from CHUNK_BYTES")
    return lib


def chunk_table(src, dst, nbytes, chunk: int = CHUNK_BYTES) -> np.ndarray:
    """The ``(n, 3)`` int64 table ``(src, dst, bytes)`` of byte runs
    ``src[i] -> dst[i]`` of ``nbytes[i]`` bytes, each run cut where its
    destination crosses a multiple of ``chunk``: every entry moves at most
    ``chunk`` bytes, and only a run's first entry can start off a 16-byte
    destination boundary.  Empty runs are dropped."""
    src, dst, n = (np.asarray(a, dtype=np.int64).reshape(-1) for a in (src, dst, nbytes))
    keep = n > 0
    src, dst, n = src[keep], dst[keep], n[keep]
    first = dst // chunk
    count = (dst + n - 1) // chunk - first + 1
    run = np.repeat(np.arange(n.shape[0]), count)
    k = np.arange(run.shape[0]) - np.repeat(np.cumsum(count) - count, count)
    lo = np.maximum(dst[run], (first[run] + k) * chunk)
    hi = np.minimum(dst[run] + n[run], (first[run] + k + 1) * chunk)
    return np.stack([src[run] + (lo - dst[run]), lo, hi - lo], axis=1)


def launch_table(table: torch.Tensor) -> None:
    """Launch the kernel on a chunked table already on the card (``(n, 3)``
    int64, from :func:`chunk_table`), on the current stream."""
    global launches
    if not table.is_cuda or table.dtype != torch.int64 or not table.is_contiguous():
        raise ValueError("the table must be a contiguous int64 CUDA tensor")
    if table.dim() != 2 or table.shape[1] != 3:
        raise ValueError(f"the table must be (n, 3), got {tuple(table.shape)}")
    if table.shape[0] == 0:
        return
    lib = _lib()
    with torch.cuda.device(table.device):
        rc = lib.fragment_union(
            table.data_ptr(), int(table.shape[0]),
            torch.cuda.current_stream(table.device).cuda_stream,
        )
        with _launches_lock:
            launches += 1
    if rc != 0:
        msg = lib.fragment_gather_error_string(rc).decode()
        raise RuntimeError(f"fragment_gather launch failed: {msg} (cuda error {rc})")


def fragment_union_call(src, dst, nbytes, device: torch.device) -> None:
    """Copy the byte runs ``src[i] -> dst[i]`` (device addresses on
    ``device``) in one launch.  The kernel checks nothing: the caller
    guarantees that every range lies inside its tensor."""
    table = chunk_table(src, dst, nbytes)
    if table.shape[0] == 0:
        return
    pinned = torch.from_numpy(table).pin_memory()
    launch_table(pinned.to(device, non_blocking=True))


def fragment_gather_call(
    src: torch.Tensor,  # (Ns, C) contiguous CUDA tensor
    block_idx,  # (nR,) host ints: source row TILE per output row tile
    *,
    row_block: int,
    out_rows: int,
) -> torch.Tensor:
    """Output row tile ``i`` is source row tile ``block_idx[i]``, ``row_block``
    rows a tile; returns the ``(out_rows, C)`` output.  Every tile must lie
    wholly inside ``src`` — the kernel does not check it
    (``ops.fragment_gather`` does, on the host, before it builds the tiles)."""
    if not src.is_cuda:
        raise ValueError("fragment_gather_call takes a CUDA tensor")
    if src.dim() != 2 or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous (Ns, C) tensor, got {tuple(src.shape)}")
    if src.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {src.dtype}")
    block_idx = np.asarray(block_idx, dtype=np.int64).reshape(-1)
    if out_rows % row_block or block_idx.shape[0] != out_rows // row_block:
        raise ValueError("out_rows must be row_block * len(block_idx)")
    out = torch.empty((out_rows, src.shape[1]), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    tile = row_block * src.shape[1] * src.element_size()
    src_tile, out_tile, tiles = tile_runs(block_idx)
    fragment_union_call(
        src.data_ptr() + src_tile * tile, out.data_ptr() + out_tile * tile, tiles * tile, src.device
    )
    return out


def tile_runs(block_idx: np.ndarray):
    """``block_idx`` as runs of tiles whose source tiles follow one another:
    ``(first source tile, first output tile, tiles)`` arrays."""
    out_tile = np.flatnonzero(np.diff(block_idx, prepend=block_idx[0] - 2) != 1)
    return block_idx[out_tile], out_tile, np.diff(out_tile, append=block_idx.shape[0])
