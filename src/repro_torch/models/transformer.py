"""Decoder-only transformer stack (dense / MoE / audio / VLM families), on
torch tensors.

The port of ``repro.models.transformer``: the layer-stacked parameters are
looped over in Python in place of ``lax.scan``, each layer under the
config's rematerialisation policy (``layers.remat``), so ``forward`` trains
under autograd as the reference's does under ``jax.grad``.  Modality frontends (musicgen frames,
InternViT patches) are stubs, as in the reference: precomputed prefix
embeddings overwrite the first ``prefix_len`` token embeddings (early
fusion).  Sliding-window archs keep a ring KV cache of ``window`` slots.
Every materialised activation carries the reference's logical sharding
annotation (``dist.sharding.shard``: the identity unless rules are active),
and ``param_logical_axes`` / ``cache_logical_axes`` name the axes of the
parameters and the decode cache.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.dist.sharding import einsum, per_shard, shard
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    attention_decode,
    attention_train,
    mlp_apply,
    moe_apply,
    remat,
    rms_norm,
    write_positions,
)
from repro_torch.models.mamba import Device, _dtype, _embed, lookup, normal, unstack

__all__ = [
    "init_params",
    "param_logical_axes",
    "forward",
    "cache_len",
    "init_decode_cache",
    "cache_logical_axes",
    "prefill",
    "decode_step",
]


# ------------------------------------------------------------------- params
def _mlp_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    D, F_ = cfg.d_model, cfg.d_ff
    if cfg.mlp == "swiglu":
        return {"w1": (D, F_), "w3": (D, F_), "w2": (F_, D)}
    return {"w1": (D, F_), "w2": (F_, D)}


def _mlp_axes(cfg: ArchConfig, layered: bool) -> Dict[str, tuple]:
    l = ("layers",) if layered else ()
    ax = {"w1": l + ("embed", "mlp"), "w2": l + ("mlp", "embed")}
    if cfg.mlp == "swiglu":
        ax["w3"] = l + ("embed", "mlp")
    return ax


def _layer_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shapes: Dict[str, Any] = {
        "ln1": (D,),
        "ln2": (D,),
        "wq": (D, H, hd),
        "wk": (D, KV, hd),
        "wv": (D, KV, hd),
        "wo": (H, hd, D),
    }
    if cfg.num_experts:
        E, F_ = cfg.num_experts, cfg.d_ff
        moe: Dict[str, Any] = {"router": (D, E), "w1": (E, D, F_), "w2": (E, F_, D)}
        if cfg.mlp == "swiglu":
            moe["w3"] = (E, D, F_)
        if cfg.moe_shared_expert:
            moe["shared"] = _mlp_shapes(cfg)
        shapes["moe"] = moe
    else:
        shapes["mlp"] = _mlp_shapes(cfg)
    return shapes


def _layer_axes(cfg: ArchConfig) -> Dict[str, Any]:
    axes: Dict[str, Any] = {
        "ln1": ("layers", None),
        "ln2": ("layers", None),
        "wq": ("layers", "embed", "heads", "head_dim"),
        # KV projections are small under GQA: replicate across "model"
        "wk": ("layers", "embed", None, None),
        "wv": ("layers", "embed", None, None),
        "wo": ("layers", "heads", "head_dim", "embed"),
    }
    if cfg.num_experts:
        moe = {
            "router": ("layers", "embed", None),
            "w1": ("layers", "experts", "embed", "expert_mlp"),
            "w2": ("layers", "experts", "expert_mlp", "embed"),
        }
        if cfg.mlp == "swiglu":
            moe["w3"] = ("layers", "experts", "embed", "expert_mlp")
        if cfg.moe_shared_expert:
            moe["shared"] = _mlp_axes(cfg, layered=True)
        axes["moe"] = moe
    else:
        axes["mlp"] = _mlp_axes(cfg, layered=True)
    return axes


def _fan_in(name: str, s: tuple) -> int:
    """The size of the dimension a weight contracts over."""
    if name == "wo":  # (H, hd, D): contraction over H·hd
        return s[0] * s[1]
    if name in ("wq", "wk", "wv"):  # (D, heads, hd): contraction over D
        return s[0]
    if len(s) >= 2:  # (…, in, out): contraction over the next-to-last dim
        return s[-2]
    return 1


def init_params(cfg: ArchConfig, gen: torch.Generator, device: Device = None) -> Dict[str, Any]:
    """Fan-in scaled normals keyed and shaped as the reference's, stacked
    over layers; norms are ones.  ``device`` ``None`` means the CUDA card
    (raises without one)."""
    device = resolve_device(device)
    dt = _dtype(cfg)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size

    def init_tree(shapes):
        out = {}
        for name, s in shapes.items():
            if isinstance(s, dict):
                out[name] = init_tree(s)
            elif name.startswith("ln") or name == "norm":
                out[name] = torch.ones((L,) + s, dtype=dt, device=device)
            else:
                out[name] = normal(gen, (L,) + s, _fan_in(name, s), dt, device)
        return out

    params = {
        "embed": normal(gen, (V, D), D, dt, device),
        "layers": init_tree(_layer_shapes(cfg)),
        "final_norm": torch.ones((D,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(gen, (D, V), D, dt, device)
    return params


def param_logical_axes(cfg: ArchConfig) -> Dict[str, Any]:
    axes = {
        "embed": ("vocab", "embed"),
        "layers": _layer_axes(cfg),
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


# ------------------------------------------------------------------ forward
def _logits(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return shard(einsum("bsd,dv->bsv", x, head), ("batch", "seq", "act_vocab"))


def _ffn(cfg: ArchConfig, lp, h: torch.Tensor) -> torch.Tensor:
    return moe_apply(cfg, h, lp["moe"]) if cfg.num_experts else mlp_apply(cfg, h, lp["mlp"])


def _block(cfg: ArchConfig, lp, x: torch.Tensor, positions: torch.Tensor):
    """One pre-norm layer on the full sequence; returns (x, k, v) with the
    rotated KV-head keys and values."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, k, v = attention_train(
        cfg, h, lp["wq"], lp["wk"], lp["wv"], lp["wo"], positions, return_kv=True
    )
    x = shard(x + a, ("batch", "seq", None))
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return shard(x + _ffn(cfg, lp, h), ("batch", "seq", None)), k, v


def forward(
    cfg: ArchConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,  # (B, S) int
    prefix_embeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scoring forward pass: (B, S) -> logits (B, S, V)."""
    B, S = tokens.shape
    x = shard(_embed(cfg, params, tokens, prefix_embeds), ("batch", "seq", None))
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    block = remat(cfg.remat, lambda x, lp: _block(cfg, lp, x, positions)[0])
    for lp in unstack(params["layers"]):
        x = block(x, lp)
    return _logits(cfg, params, x)


# -------------------------------------------------------------------- cache
def cache_len(cfg: ArchConfig, max_len: int) -> int:
    """Ring buffers bound the cache to the attention window."""
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_decode_cache(
    cfg: ArchConfig, batch: int, max_len: int, device: Device = None
) -> Dict[str, Any]:
    device = resolve_device(device)
    T = cache_len(cfg, max_len)
    L, KV, hd, dt = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, _dtype(cfg)
    return {
        "k": torch.zeros((L, batch, T, KV, hd), dtype=dt, device=device),
        "v": torch.zeros((L, batch, T, KV, hd), dtype=dt, device=device),
        # per-sequence bookkeeping: continuous batching holds sequences at
        # different depths in one batch
        "kv_pos": torch.full((batch, T), -1, dtype=torch.int32, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def cache_logical_axes(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "k": ("layers", "batch", "kv_seq", None, None),
        "v": ("layers", "batch", "kv_seq", None, None),
        "kv_pos": ("batch", None),
        "pos": ("batch",),
    }


def prefill(
    cfg: ArchConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,  # (B, S)
    prefix_embeds: Optional[torch.Tensor] = None,
    max_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process the prompt, build the KV cache, return last-token logits.

    The cache holds the final ``cache_len`` positions; for a sliding window
    shorter than the prompt they are rotated so that slot == pos % T, the
    ring layout decode writes."""
    B, S = tokens.shape
    T = cache_len(cfg, max_len or S)
    dt = _dtype(cfg)
    ring = bool(cfg.sliding_window) and S > T
    shift = (S - T) % T if ring else 0
    x = shard(_embed(cfg, params, tokens, prefix_embeds), ("batch", "seq", None))
    positions = torch.arange(S, dtype=torch.int32, device=x.device)

    ks, vs = [], []
    for lp in unstack(params["layers"]):
        x, k, v = _block(cfg, lp, x, positions)
        if ring:  # keep the last T positions, rotated so slot == pos % T
            # (per shard: torch 2.11's DTensor has no strategy for roll)
            k = per_shard(lambda t: torch.roll(t, shifts=shift, dims=1), k[:, S - T :], [1])
            v = per_shard(lambda t: torch.roll(t, shifts=shift, dims=1), v[:, S - T :], [1])
        elif T > S:  # right-padded to the slot's context
            k = F.pad(k, (0, 0, 0, 0, 0, T - S))
            v = F.pad(v, (0, 0, 0, 0, 0, T - S))
        else:
            k, v = k[:, :T], v[:, :T]
        ks.append(k.to(dt))
        vs.append(v.to(dt))
    logits = _logits(cfg, params, x[:, -1:, :])

    if ring:
        abs_pos = torch.arange(S - T, S, dtype=torch.int32, device=x.device)
        kv_pos = torch.roll(abs_pos, shifts=shift)
    else:
        ar = torch.arange(T, dtype=torch.int32, device=x.device)
        kv_pos = torch.where(ar < S, ar, -1)
    cache = {
        "k": shard(torch.stack(ks), ("layers", "batch", "kv_seq", None, None)),
        "v": shard(torch.stack(vs), ("layers", "batch", "kv_seq", None, None)),
        "kv_pos": kv_pos.expand(B, T).contiguous(),
        "pos": torch.full((B,), S, dtype=torch.int32, device=x.device),
    }
    return logits, cache


def decode_step(
    cfg: ArchConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,  # (B, 1)
    cache: Dict[str, Any],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token per sequence.  The cache's ``k`` and ``v`` tensors are
    updated in place (the reference donates them to jit) and returned in a
    new dict with the new ``kv_pos`` and positions."""
    B = tokens.shape[0]
    pos = cache["pos"]  # (B,)
    T = cache["k"].shape[2]
    x = shard(lookup(params["embed"], tokens), ("batch", None, None))  # (B,1,D)

    window = cfg.sliding_window
    slot = (pos % T if window > 0 else torch.clamp(pos, max=T - 1)).long()  # (B,)
    kv_pos = write_positions(cache["kv_pos"], slot, pos)
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    if window > 0:
        valid &= kv_pos > (pos - window)[:, None]

    for i, lp in enumerate(unstack(params["layers"])):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = attention_decode(
            cfg, h, lp["wq"], lp["wk"], lp["wv"], lp["wo"],
            cache["k"][i], cache["v"][i], slot, valid, pos,
        )
        x = x + a
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, lp, h)

    logits = _logits(cfg, params, x)
    new_cache = {"k": cache["k"], "v": cache["v"], "kv_pos": kv_pos, "pos": pos + 1}
    return logits, new_cache
