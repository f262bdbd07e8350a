"""Plain version: a torch row gather (the role ``jnp.take`` plays in the
reference's ``ref.py``).  The wrapper takes it for CPU tensors only."""

from __future__ import annotations

import torch

__all__ = ["gather_ref", "signed_view"]

# torch's CPU and CUDA kernels skip the wide unsigned dtypes in index_select,
# cat and pad; a same-width signed view moves the same bits
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32, torch.uint64: torch.int64}


def signed_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as the signed dtype of its width when torch's indexing
    kernels refuse its own (uint16/32/64); other dtypes pass through."""
    signed = _SIGNED.get(t.dtype)
    return t if signed is None else t.view(signed)


def gather_ref(src: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[row_idx[i]] — (R,) indices over (Ns, C) rows."""
    out = signed_view(src).index_select(0, row_idx.to(device=src.device, dtype=torch.long))
    return out.view(src.dtype)
