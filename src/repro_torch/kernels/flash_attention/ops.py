"""Public wrapper: model-layout ``(B, S, H, hd)`` GQA flash attention.

A CPU tensor takes the plain version (``ref.attention_ref``), which autograd
differentiates; a CUDA tensor launches the kernel or raises.  Under autograd
(grad mode on and an input that requires grad) a bf16 CUDA call goes through
``FlashAttentionFunction``, whose forward and backward are both the
hand-written kernels (the reference cannot differentiate its Pallas kernel:
this widens the port); an f32 CUDA call raises there, as the CUDA-core
route has no backward.  A DTensor (a model run under sharding rules)
raises: the reference shards only with its kernels off.
The kernel reads the model layout directly and masks the ragged tail
itself, so the reference wrapper's head moves and padding have no
counterpart.  The kernel's tiles are fixed by the head group and the dtype
(``kernel.tile_rows``, ``kernel.query_block``) and a 64-key tile;
``q_block`` and ``k_block`` are accepted for signature parity with the
reference and are only checked.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist.sharding import is_dtensor
from repro_torch.kernels.flash_attention.kernel import ROUTES, flash_attention_bwd_call, flash_attention_call
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["FlashAttentionFunction", "flash_attention"]


class FlashAttentionFunction(torch.autograd.Function):
    """Full-sequence attention whose forward and backward are the bf16
    Hopper kernels: the forward keeps each row's log-sum-exp beside its
    output, and the backward recomputes the scores tile by tile from them
    (no S x S tensor is stored).  Takes contiguous bf16 CUDA tensors in the
    model layout; returns the output in q's."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, window: int):
        out, lse = flash_attention_call(q, k, v, scale=scale, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(scale=scale, causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_call(q, k, v, out, lse, dout.contiguous(), **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,  # (B, S, KV, hd)
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    window: int = 0,
    q_block: int = 512,
    k_block: int = 512,
) -> torch.Tensor:
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads do not divide into {KV} KV heads")
    if q_block <= 0 or k_block <= 0:
        raise ValueError(f"block sizes must be positive, got {q_block}, {k_block}")
    if any(is_dtensor(t) for t in (q, k, v)):
        raise TypeError(
            "flash_attention takes no DTensor: the kernel runs on one card's whole tensors; under "
            "sharding rules run the model with use_pallas_kernels=False, as the reference does"
        )
    scale = hd**-0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale=scale, causal=causal, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if ROUTES.get(q.dtype) != "tensor_core":
            raise RuntimeError(
                f"flash_attention has no backward kernel for {q.dtype} (the CUDA-core route): "
                "train in bf16, or with use_pallas_kernels=False"
            )
        return FlashAttentionFunction.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), scale, bool(causal), int(window)
        )
    return flash_attention_call(
        q.contiguous(), k.contiguous(), v.contiguous(),
        scale=scale, causal=causal, window=window,
    )
