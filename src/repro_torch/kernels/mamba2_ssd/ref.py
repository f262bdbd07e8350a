"""Plain torch versions of the SSD kernel, two independent ones:

- ``ssd_ref_sequential`` — the O(S) per-token recurrence, the definition of
  the SSM (slow, test sizes only).
- ``ssd_ref_chunked`` — the chunked formulation of
  ``repro_torch.models.ssm.ssd_chunked`` (the model's path with the kernels
  off).  The wrapper takes it for CPU tensors.

The kernel must match both, and they must match each other, which guards
against a shared bug in the chunked math.

- ``ssd_ref_three_pass`` — the kernel's three passes on the CPU (chunk
  states, state passing, chunk outputs) with the bf16 route's operand
  roundings: every f32 operand of a bf16 product split into bf16 hi + lo.
  The tests hold it against the reference's oracles; no path of the system
  calls it.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ssd_ref_sequential", "ssd_ref_chunked", "ssd_ref_three_pass"]


def ssd_ref_chunked(xh, dt, A, Bm, Cm, chunk: int = 256):
    # imported here: models.ssm reaches the kernels package through the
    # models package, which would make a cycle at import time
    from repro_torch.models.ssm import ssd_chunked

    return ssd_chunked(xh, dt, A, Bm, Cm, chunk)


def ssd_ref_sequential(
    xh: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t h_t."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    h = torch.zeros((B, H, P, N), dtype=f32, device=xh.device)
    ys = []
    for t in range(S):
        dt_t = dt[:, t].to(f32)
        decay = torch.exp(dt_t * A.to(f32))  # (B,H)
        dBx = torch.einsum("bn,bh,bhp->bhpn", Bm[:, t].to(f32), dt_t, xh[:, t].to(f32))
        h = h * decay[:, :, None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t].to(f32)))
    return torch.stack(ys, dim=1).to(xh.dtype), h


def _operands(t: torch.Tensor, bf16: bool):
    """The bf16 products' view of an f32 operand: hi + lo halves (their sum
    carries about 16 bits), or the operand itself on the f32 route."""
    if not bf16:
        return [t]
    hi = t.to(torch.bfloat16).float()
    return [hi, (t - hi).to(torch.bfloat16).float()]


def ssd_ref_three_pass(xh, dt, A, Bm, Cm, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's passes: (1) each chunk's prefix sum cs of dt·A, its own
    state sum_t exp(cs_last - cs_t) dt_t x_t ⊗ B_t and exp(cs_last);
    (2) the carry-in of each chunk, in chunk order; (3) each chunk's
    outputs, (C·Bᵀ ⊙ exp(cs_q - cs_t)·dt_t, t <= q)·x + exp(cs_q)·C·h_prevᵀ.
    bf16 inputs take the bf16 route's roundings (weighted x, the masked
    decay matrix and the carry-in split hi + lo; x, B and C exact); f32 none.
    Returns (y in xh's dtype, final state f32)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    bf16 = xh.dtype == torch.bfloat16
    x, Bf, Cf, dtf, a = xh.float(), Bm.float(), Cm.float(), dt.float(), A.float()
    spans = [(c0, min(c0 + Q, S)) for c0 in range(0, S, Q)]

    css, own, decay = [], [], []  # pass 1
    for c0, c1 in spans:
        cs = torch.cumsum(dtf[:, c0:c1] * a, dim=1)  # (B, L, H)
        w = torch.exp(cs[:, -1:] - cs) * dtf[:, c0:c1]
        wx = x[:, c0:c1] * w[..., None]  # (B, L, H, P)
        own.append(sum(torch.einsum("blhp,bln->bhpn", part, Bf[:, c0:c1]) for part in _operands(wx, bf16)))
        css.append(cs)
        decay.append(torch.exp(cs[:, -1]))

    carry, h = [], torch.zeros((B, H, P, N), device=xh.device)  # pass 2
    for s_c, d_c in zip(own, decay):
        carry.append(h)
        h = d_c[:, :, None, None] * h + s_c

    ys = []  # pass 3
    for (c0, c1), cs, h_prev in zip(spans, css, carry):
        L = c1 - c0
        cb = torch.einsum("bqn,btn->bqt", Cf[:, c0:c1], Bf[:, c0:c1])
        tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))
        diff = cs.permute(0, 2, 1)[:, :, :, None] - cs.permute(0, 2, 1)[:, :, None, :]  # (B, H, q, t)
        W = cb[:, None] * torch.exp(torch.where(tri, diff, -torch.inf)) * dtf[:, c0:c1].permute(0, 2, 1)[:, :, None, :]
        y = sum(torch.einsum("bhqt,bthp->bqhp", part, x[:, c0:c1]) for part in _operands(W, bf16))
        inter = sum(torch.einsum("bqn,bhpn->bqhp", Cf[:, c0:c1], part) for part in _operands(h_prev, bf16))
        ys.append(y + torch.exp(cs)[..., None] * inter)
    return torch.cat(ys, dim=1).to(xh.dtype), h
