"""Plain torch version of the flash-attention kernel: the materialised score
matrix (O(S²) memory), as the reference's ``ref.py``.  The wrapper takes it
for CPU tensors; the tests and the smoke run hold the kernel against it."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_ref"]


def attention_ref(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    B, S, H, hd = q.shape
    KV = k.shape[2]
    scale = hd**-0.5 if scale is None else scale
    if KV != H:
        rep = H // KV
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype)
