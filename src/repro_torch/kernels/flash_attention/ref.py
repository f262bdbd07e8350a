"""Plain torch versions of the flash-attention kernel.

- ``attention_ref`` — the materialised score matrix (O(S²) memory), as the
  reference's ``ref.py``.  The wrapper takes it for CPU tensors; the tests
  and the smoke run hold the kernel against it.
- ``attention_bf16_tiled_ref`` — the tensor-core route's numerics on the
  CPU: online softmax over 64-key tiles with the probabilities rounded to
  bf16 before P·V.  The tests hold it against the reference's oracle; no
  path of the system calls it.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_ref", "attention_bf16_tiled_ref"]


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


def attention_bf16_tiled_ref(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    window: int = 0,
    key_block: int = 64,
) -> torch.Tensor:
    """The bf16 kernel's arithmetic: f32 scores of the input values, an f32
    running (max, sum, numerator) over ``key_block``-key tiles, and each
    tile's probabilities rounded to bf16 before they multiply V (the
    kernel's register-A operand); the sum takes the unrounded ones.  Output
    in q's dtype."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale = hd**-0.5 if scale is None else scale
    qf = q.float()
    kf = torch.repeat_interleave(k.float(), G, dim=2)
    vf = torch.repeat_interleave(v.float(), G, dim=2)
    qpos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S), -1e30, device=q.device)
    l = torch.zeros((B, H, S), device=q.device)
    acc = torch.zeros((B, H, S, hd), device=q.device)
    for k0 in range(0, S, key_block):
        k1 = min(k0 + key_block, S)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, k0:k1]) * scale
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        mask = torch.ones((S, k1 - k0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vf[:, k0:k1])
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)
