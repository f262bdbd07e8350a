"""Plain torch versions of the SSD kernel, two independent ones:

- ``ssd_ref_sequential`` — the O(S) per-token recurrence, the definition of
  the SSM (slow, test sizes only).
- ``ssd_ref_chunked`` — the chunked formulation of
  ``repro_torch.models.ssm.ssd_chunked`` (the model's path with the kernels
  off).  The wrapper takes it for CPU tensors.

The kernel must match both, and they must match each other, which guards
against a shared bug in the chunked math.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ssd_ref_sequential", "ssd_ref_chunked"]


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
