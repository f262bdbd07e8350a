"""Public wrapper for the dequantize kernel.

A CPU tensor takes the plain version (``ref.dequant_ref``); a CUDA tensor
launches the kernel or raises.  The kernel streams the flat array and masks
the ragged tail itself, so the reference wrapper's padding to
``(row_block, col_block)`` multiples has no counterpart; the block sizes are
accepted for signature parity with the reference and are only checked.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dequant.kernel import dequant_call
from repro_torch.kernels.dequant.ref import dequant_ref

__all__ = ["dequant"]

_OUT_DTYPES = (torch.bfloat16, torch.float32)


def dequant(
    x: torch.Tensor,  # (R, C) int8
    scale: torch.Tensor,  # (C,) f32
    *,
    out_dtype: torch.dtype = torch.bfloat16,
    row_block: int = 256,
    col_block: int = 512,
) -> torch.Tensor:
    if x.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"x must be int8 and scale float32, got {x.dtype}/{scale.dtype}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be one of {list(_OUT_DTYPES)}, got {out_dtype}")
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"x {tuple(x.shape)} and scale {tuple(scale.shape)} are not (R, C) and (C,)")
    if row_block <= 0 or col_block <= 0:
        raise ValueError(f"block sizes must be positive, got {row_block}, {col_block}")
    if x.device.type == "cpu":
        return dequant_ref(x, scale, out_dtype=out_dtype)
    return dequant_call(x.contiguous(), scale.contiguous(), out_dtype=out_dtype)
