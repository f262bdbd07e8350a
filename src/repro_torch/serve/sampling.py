"""Token sampling: greedy / temperature / top-k, batched.

Greedy is ``argmax``, as the reference's.  Temperature and top-k draw from an
explicit ``torch.Generator``, whose bits differ from ``jax.random``'s: the
two packages agree token for token under greedy sampling only.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sample_token"]


def sample_token(
    logits: torch.Tensor,  # (B, 1, V) or (B, V)
    generator: Optional[torch.Generator],
    *,
    temperature: float = 0.0,
    top_k: int = 0,
) -> torch.Tensor:
    """Returns (B,) int32 next tokens.  temperature 0 = greedy."""
    if logits.dim() == 3:
        logits = logits[:, -1, :]
    lg = logits.float()
    if temperature <= 0.0:
        return torch.argmax(lg, dim=-1).to(torch.int32)
    lg = lg / temperature
    if top_k > 0:
        kth = torch.sort(lg, dim=-1).values[:, -top_k][:, None]
        lg = torch.where(lg < kth, -torch.inf, lg)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
