"""Transformer building blocks on torch tensors: norms, RoPE, GQA attention
(full sequence and one-token decode) and the dense MLPs.

The port of ``repro.models.layers``.  Every function keeps the reference's
dtype order: what the reference computes in f32 (norm statistics, RoPE
angles, attention scores and softmax) is computed in f32 here, and what it
computes in the activation dtype stays in it.  The reference's logical
sharding constraints (``shard``) are the identity on one device and are left
out.

Attention on the full sequence takes the flash-attention kernel when
``cfg.use_pallas_kernels`` is set (``kernels.flash_attention``: the CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor) and otherwise the
plain-score formulation of the reference's XLA path.  The long-context
(``S > 8192``) and sliding-window formulations, the MoE layer and the loss
belong to later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig

__all__ = [
    "rms_norm",
    "rope_freqs",
    "apply_rope",
    "attention_train",
    "attention_decode",
    "mlp_apply",
    "moe_apply",
    "cross_entropy",
]

_NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    rms = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return ((x32 * rms) * scale.float()).to(dt)


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, fp32, shape (head_dim//2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int.

    Angles, sin and cos in fp32; the rotation multiplies in x's dtype, as
    the reference's does."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    ang = positions[..., :, None].float() * inv  # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :].to(x.dtype)  # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# -------------------------------------------------------------- attention
def _causal_mask(S: int, T: int, q_offset: int = 0, window: int = 0, device=None) -> torch.Tensor:
    """(S, T) bool mask: True = attend. Queries at positions q_offset+i."""
    qpos = torch.arange(S, device=device)[:, None] + q_offset
    kpos = torch.arange(T, device=device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


# Above this sequence length the reference switches to its blocked
# online-softmax formulation; the port has not taken it over yet.
_FLASH_THRESHOLD = 8192


def attention_train(
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, D)
    wq: torch.Tensor,  # (D, H, hd)
    wk: torch.Tensor,  # (D, KV, hd)
    wv: torch.Tensor,
    wo: torch.Tensor,  # (H, hd, D)
    positions: torch.Tensor,  # (S,) int
    return_kv: bool = False,
):
    """Full-sequence causal attention (prefill scoring path).

    ``return_kv=True`` also returns the rotated KV-head tensors, so prefill
    can fill the decode cache without recomputing projections."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, S, D = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    q = apply_rope(q, positions[None, :], cfg.rope_theta)
    k = apply_rope(k, positions[None, :], cfg.rope_theta)
    scale = hd**-0.5
    k_kv, v_kv = k, v

    if cfg.use_pallas_kernels:
        from repro_torch.kernels.flash_attention import flash_attention

        out = flash_attention(q, k_kv, v_kv, scale=scale, causal=True, window=cfg.sliding_window)
    elif cfg.sliding_window and S > cfg.sliding_window:
        out = _blocked_local_attention(q, k, v, cfg.sliding_window, scale)
    elif S > _FLASH_THRESHOLD:
        out = _blocked_causal_attention(q, k, v, scale)
    else:
        if KV != H:  # repeat-KV
            rep = H // KV
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        # f32 products of the activation-dtype inputs, f32 sums (the
        # reference's preferred_element_type=f32)
        scores = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) * scale
        mask = _causal_mask(S, S, window=cfg.sliding_window, device=x.device)
        scores = torch.where(mask[None, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("bhst,bthk->bshk", probs, v)
    proj = torch.einsum("bshk,hkd->bsd", out, wo)
    if return_kv:
        return proj, k_kv, v_kv
    return proj


def _blocked_causal_attention(q, k, v, scale):
    raise NotImplementedError(
        "attention over more than 8192 positions (the reference's blocked "
        "causal formulation) is not ported yet: ROADMAP A10, transformer family"
    )


def _blocked_local_attention(q, k, v, window, scale):
    raise NotImplementedError(
        "sliding-window attention (the reference's blocked-local formulation) "
        "is not ported yet: ROADMAP A10, transformer family"
    )


def attention_decode(
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, D)
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    wo: torch.Tensor,
    k_cache: torch.Tensor,  # (B, T, KV, hd)
    v_cache: torch.Tensor,
    slot: torch.Tensor,  # (B,) int — cache slot to write per sequence
    valid: torch.Tensor,  # (B, T) bool — slots to attend to (incl. new one)
    pos: torch.Tensor,  # (B,) int — absolute position per sequence
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a KV cache, positions per sequence.

    Unlike the reference, which returns new cache arrays, the new key and
    value are written into ``k_cache`` and ``v_cache`` in place; the same
    tensors are returned.  Returns (output (B,1,D), k_cache, v_cache)."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B = x.shape[0]
    q = torch.einsum("bsd,dhk->bshk", x, wq)  # (B,1,H,hd)
    k = torch.einsum("bsd,dhk->bshk", x, wk)  # (B,1,KV,hd)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)

    bidx = torch.arange(B, device=x.device)
    k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)

    # grouped-query attention over the cache (no KV repeat: q -> (B,1,KV,G,hd))
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k_cache.float()) * (hd**-0.5)
    scores = torch.where(valid[:, None, None, None, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v_cache).reshape(B, 1, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, wo), k_cache, v_cache


# ------------------------------------------------------------------- MLPs
def mlp_apply(cfg: ArchConfig, x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dense MLP: swiglu (w1·silu ⊙ w3) | relu2 (squared ReLU) | gelu."""
    if cfg.mlp == "swiglu":
        h = torch.einsum("bsd,df->bsf", x, w["w1"])
        g = torch.einsum("bsd,df->bsf", x, w["w3"])
        h = F.silu(h) * g
    elif cfg.mlp == "relu2":
        r = F.relu(torch.einsum("bsd,df->bsf", x, w["w1"]))
        h = r * r
    else:  # gelu (jax.nn.gelu's default is the tanh approximation)
        h = F.gelu(torch.einsum("bsd,df->bsf", x, w["w1"]), approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, w["w2"])


def _expert_ffn(cfg: ArchConfig, xs, w):
    raise NotImplementedError("MoE experts are not ported yet: ROADMAP A10, MoE family")


def moe_apply(cfg: ArchConfig, x, w):
    raise NotImplementedError("the MoE layer is not ported yet: ROADMAP A10, MoE family")


# ------------------------------------------------------------------- loss
def cross_entropy(logits, labels, mask, softcap: float = 0.0):
    raise NotImplementedError("the training loss is not ported yet: ROADMAP A11, training slice")
