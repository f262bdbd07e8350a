"""Zamba2-style hybrid stack: Mamba2 backbone + a SHARED attention block,
on torch tensors.

The port of ``repro.models.hybrid`` (arXiv:2411.15242): one transformer
block's weights are shared and applied after every ``hybrid_period`` SSM
layers,

    [mamba ×p] -> shared-attn -> [mamba ×p] -> shared-attn -> …

The decode cache carries SSM states for every mamba layer plus one KV cache
per shared-block application.  Under autograd the Mamba2 layers are
recomputed in the backward pass whenever ``cfg.remat`` is not ``"none"``
and the shared block is not, as in the reference.  Activations carry the
reference's logical sharding annotations (``dist.sharding.shard``, the
identity unless rules are active).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.dist.sharding import shard
from repro_torch.models import mamba as _mamba
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import attention_decode, attention_train, mlp_apply, rms_norm, write_positions

__all__ = [
    "init_params",
    "param_logical_axes",
    "forward",
    "init_decode_cache",
    "cache_logical_axes",
    "prefill",
    "decode_step",
]


def n_shared_applications(cfg: ArchConfig) -> int:
    return (cfg.num_layers + cfg.hybrid_period - 1) // cfg.hybrid_period


def _segments(cfg: ArchConfig):
    """[(start, stop), ...] mamba layer ranges between shared-block calls."""
    p = cfg.hybrid_period
    return [(i, min(i + p, cfg.num_layers)) for i in range(0, cfg.num_layers, p)]


def init_params(cfg: ArchConfig, gen: torch.Generator, device: _mamba.Device = None) -> Dict[str, Any]:
    """Random parameters keyed and shaped as the reference's.  ``device``
    ``None`` means the CUDA card (raises without one)."""
    device = resolve_device(device)
    base = _mamba.init_params(cfg, gen, device)
    dt = _mamba._dtype(cfg)
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def dense(shape, fan_in):
        return _mamba.normal(gen, shape, fan_in, dt, device)

    base["shared_attn"] = {
        "ln1": torch.ones((D,), dtype=dt, device=device),
        "ln2": torch.ones((D,), dtype=dt, device=device),
        "wq": dense((D, H, hd), D),
        "wk": dense((D, KV, hd), D),
        "wv": dense((D, KV, hd), D),
        "wo": dense((H, hd, D), H * hd),
        "mlp": {
            "w1": dense((D, cfg.d_ff), D),
            "w3": dense((D, cfg.d_ff), D),
            "w2": dense((cfg.d_ff, D), cfg.d_ff),
        },
    }
    return base


def param_logical_axes(cfg: ArchConfig) -> Dict[str, Any]:
    axes = _mamba.param_logical_axes(cfg)
    axes["shared_attn"] = {
        "ln1": (None,),
        "ln2": (None,),
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", None, None),
        "wv": ("embed", None, None),
        "wo": ("heads", "head_dim", "embed"),
        "mlp": {
            "w1": ("embed", "mlp"),
            "w3": ("embed", "mlp"),
            "w2": ("mlp", "embed"),
        },
    }
    return axes


def _shared_block_train(cfg, sp, x, positions):
    """The shared block on the full sequence; returns (x, k, v)."""
    h = rms_norm(x, sp["ln1"], cfg.norm_eps)
    a, k, v = attention_train(
        cfg, h, sp["wq"], sp["wk"], sp["wv"], sp["wo"], positions, return_kv=True
    )
    x = shard(x + a, ("batch", "seq", None))
    h = rms_norm(x, sp["ln2"], cfg.norm_eps)
    return shard(x + mlp_apply(cfg, h, sp["mlp"]), ("batch", "seq", None)), k, v


def forward(
    cfg: ArchConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,
    prefix_embeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    B, S = tokens.shape
    x = shard(_mamba._embed(cfg, params, tokens, prefix_embeds), ("batch", "seq", None))
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    layers = _mamba.unstack(params["layers"])
    mode = "none" if cfg.remat == "none" else "full"
    for start, stop in _segments(cfg):
        x, _, _ = _mamba.run_layers(cfg, x, layers[start:stop], mode)
        x, _, _ = _shared_block_train(cfg, params["shared_attn"], x, positions)
    return _mamba._logits(cfg, params, x)


def init_decode_cache(
    cfg: ArchConfig, batch: int, max_len: int, device: _mamba.Device = None
) -> Dict[str, Any]:
    device = resolve_device(device)
    cache = _mamba.init_decode_cache(cfg, batch, max_len, device)
    A = n_shared_applications(cfg)
    KV, hd, dt = cfg.num_kv_heads, cfg.resolved_head_dim, _mamba._dtype(cfg)
    cache["k"] = torch.zeros((A, batch, max_len, KV, hd), dtype=dt, device=device)
    cache["v"] = torch.zeros((A, batch, max_len, KV, hd), dtype=dt, device=device)
    cache["kv_pos"] = torch.full((batch, max_len), -1, dtype=torch.int32, device=device)
    return cache


def cache_logical_axes(cfg: ArchConfig) -> Dict[str, Any]:
    axes = _mamba.cache_logical_axes(cfg)
    axes["k"] = (None, "batch", "kv_seq", None, None)
    axes["v"] = (None, "batch", "kv_seq", None, None)
    axes["kv_pos"] = ("batch", None)
    return axes


def prefill(
    cfg: ArchConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,
    prefix_embeds: Optional[torch.Tensor] = None,
    max_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    B, S = tokens.shape
    T = max_len or S
    dt = _mamba._dtype(cfg)
    x = shard(_mamba._embed(cfg, params, tokens, prefix_embeds), ("batch", "seq", None))
    positions = torch.arange(S, dtype=torch.int32, device=x.device)

    layers = _mamba.unstack(params["layers"])
    ssm_parts, conv_parts, k_parts, v_parts = [], [], [], []
    for start, stop in _segments(cfg):
        x, ssm, conv = _mamba.run_layers(cfg, x, layers[start:stop])
        ssm_parts += ssm
        conv_parts += conv
        x, k, v = _shared_block_train(cfg, params["shared_attn"], x, positions)
        pad = T - S
        if pad > 0:  # the KV cache is right-padded to the slot's context
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_parts.append(k.to(dt))
        v_parts.append(v.to(dt))

    logits = _mamba._logits(cfg, params, x[:, -1:, :])
    ar = torch.arange(T, dtype=torch.int32, device=x.device)
    cache = {
        "ssm": torch.stack(ssm_parts),
        "conv": torch.stack(conv_parts).to(dt),
        "k": torch.stack(k_parts),
        "v": torch.stack(v_parts),
        "kv_pos": torch.where(ar < S, ar, -1).expand(B, T).contiguous(),
        "pos": torch.full((B,), S, dtype=torch.int32, device=x.device),
    }
    return logits, cache


def decode_step(
    cfg: ArchConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cache: Dict[str, Any],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token per sequence.  The cache's ``ssm``, ``conv``, ``k`` and
    ``v`` tensors are updated in place (the reference donates them to jit)
    and returned in a new dict with the new ``kv_pos`` and positions."""
    # constrain after the table lookup, as the reference does: there the
    # partial product would otherwise reach the KV write and re-replicate
    # the whole cache a layer
    x = shard(_mamba.lookup(params["embed"], tokens), ("batch", None, None))  # (B,1,D)
    B = tokens.shape[0]
    pos = cache["pos"]  # (B,)
    T = cache["k"].shape[2]
    slot = torch.clamp(pos, max=T - 1).long()  # (B,)
    kv_pos = write_positions(cache["kv_pos"], slot, pos)
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    sp = params["shared_attn"]
    layers = _mamba.unstack(params["layers"])

    for app, (start, stop) in enumerate(_segments(cfg)):
        x = _mamba.decode_layers(cfg, x, layers[start:stop], cache, start)
        # shared attention block; writes this step's K/V into the cache
        h = rms_norm(x, sp["ln1"], cfg.norm_eps)
        a, _, _ = attention_decode(
            cfg, h, sp["wq"], sp["wk"], sp["wv"], sp["wo"],
            cache["k"][app], cache["v"][app], slot, valid, pos,
        )
        x = x + a
        h = rms_norm(x, sp["ln2"], cfg.norm_eps)
        x = x + mlp_apply(cfg, h, sp["mlp"])

    logits = _mamba._logits(cfg, params, x)
    new_cache = dict(cache)
    new_cache["kv_pos"] = kv_pos
    new_cache["pos"] = pos + 1
    return logits, new_cache
