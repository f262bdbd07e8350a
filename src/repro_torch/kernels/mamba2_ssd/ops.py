"""Public wrapper for the SSD kernel, model-layout compatible with
``repro_torch.models.ssm.ssd_chunked`` (drop-in fast path).

A CPU tensor takes the plain version (``ref.ssd_ref_chunked``); a CUDA
tensor launches the kernel or raises.  The kernel has no backward, so under
autograd (grad mode on and an input that requires grad) the wrapper raises
on every device, as the reference cannot differentiate its Pallas kernel.
A DTensor (a model run under sharding rules) raises too: the reference
shards only with its kernels off.
The kernel masks a ragged last chunk itself (the final state equals the
unpadded one), so the reference wrapper's ``dt = 0`` padding has no
counterpart.  The kernel fixes its own head grouping (one head a block for
the chunk states, two for the chunk outputs on the tensor cores);
``head_block`` is accepted for signature parity with the reference and is
only checked.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dist.sharding import is_dtensor
from repro_torch.kernels.mamba2_ssd.kernel import ssd_call
from repro_torch.kernels.mamba2_ssd.ref import ssd_ref_chunked

__all__ = ["ssd"]


def ssd(
    xh: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 256,
    head_block: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, P = xh.shape
    if chunk <= 0 or head_block <= 0:
        raise ValueError(f"chunk and head_block must be positive, got {chunk}, {head_block}")
    if any(is_dtensor(t) for t in (xh, dt, A, Bm, Cm)):
        raise TypeError(
            "mamba2_ssd takes no DTensor: the kernel runs on one card's whole tensors; under "
            "sharding rules run the model with use_pallas_kernels=False, as the reference does"
        )
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xh, dt, A, Bm, Cm)):
        raise RuntimeError(
            "mamba2_ssd has no backward kernel; the reference cannot differentiate its "
            "Pallas kernel either: train with use_pallas_kernels=False"
        )
    Q = min(chunk, S)
    if xh.device.type == "cpu":
        return ssd_ref_chunked(xh, dt, A, Bm, Cm, chunk=Q)
    return ssd_call(
        xh.contiguous(),
        dt.float().contiguous(),
        A.float().contiguous(),
        Bm.contiguous(),
        Cm.contiguous(),
        chunk=Q,
    )
