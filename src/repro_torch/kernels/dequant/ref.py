"""Plain torch version of the dequantize kernel, as the reference's
``ref.py``: widen int8 to f32, multiply by the column's f32 scale, round once
to the output dtype.  The wrapper takes it for CPU tensors; the tests and the
smoke run hold the kernel against it."""

from __future__ import annotations

import torch

__all__ = ["dequant_ref"]


def dequant_ref(x: torch.Tensor, scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    return (x.float() * scale.float()[None, :]).to(out_dtype)
