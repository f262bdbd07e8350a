"""Mamba2 (SSD) decoder stack — attention-free family, on torch tensors.

The port of ``repro.models.mamba``: the layer-stacked parameters are looped
over in Python in place of ``lax.scan``, each layer under the config's
rematerialisation policy (``layers.remat``), so ``forward`` trains under
autograd as the reference's does under ``jax.grad``.  The decode "cache" is
the constant-size SSM state and conv tail per layer.  Activations carry the
reference's logical sharding annotations (``dist.sharding.shard``, the
identity unless rules are active).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.device import resolve_device
from repro_torch.dist.sharding import einsum, is_dtensor, shard
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import remat, rms_norm
from repro_torch.models.ssm import mamba2_decode, mamba2_forward, mamba2_layer_param_shapes

__all__ = [
    "init_params",
    "param_logical_axes",
    "forward",
    "init_decode_cache",
    "cache_logical_axes",
    "prefill",
    "decode_step",
]

Device = Union[None, str, torch.device]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator, shape, fan_in: int, dtype, device) -> torch.Tensor:
    """N(0, 1)·fan_in^-½ drawn in f32 on the generator's device, then cast
    and moved: the reference's recipe, not its bits."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (t * fan_in**-0.5).to(dtype=dtype, device=device)


def init_params(cfg: ArchConfig, gen: torch.Generator, device: Device = None) -> Dict[str, Any]:
    """Random parameters keyed and shaped as the reference's.  ``device``
    ``None`` means the CUDA card (raises without one)."""
    device = resolve_device(device)
    dt = _dtype(cfg)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    layers: Dict[str, torch.Tensor] = {}
    for name, s in mamba2_layer_param_shapes(cfg).items():
        shape = (L,) + s
        if name in ("ln", "norm", "D_skip"):
            layers[name] = torch.ones(shape, dtype=dt, device=device)
        elif name == "conv_b":
            layers[name] = torch.zeros(shape, dtype=dt, device=device)
        elif name == "A_log":
            # A in [-1, -8): log-spaced decay rates (mamba2 default init)
            a = torch.log(torch.linspace(1.0, 8.0, s[0], dtype=torch.float32, device=device))
            layers[name] = a.expand(shape).contiguous()
        elif name == "dt_bias":
            layers[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif name == "conv_w":
            layers[name] = normal(gen, shape, cfg.conv_width, dt, device)
        else:
            layers[name] = normal(gen, shape, s[0], dt, device)
    return {
        "embed": normal(gen, (V, D), D, dt, device),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=dt, device=device),
        "lm_head": normal(gen, (D, V), D, dt, device),
    }


def param_logical_axes(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "in_proj": ("layers", "embed", "mlp"),  # big: shard out dim over model
            "conv_w": ("layers", None, None),
            "conv_b": ("layers", None),
            "A_log": ("layers", None),
            "D_skip": ("layers", None),
            "dt_bias": ("layers", None),
            "norm": ("layers", None),
            "out_proj": ("layers", "mlp", "embed"),
            "ln": ("layers", None),
        },
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


def unstack(tree: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The per-layer trees of a layer-stacked ``(L, …)`` tree: one
    ``torch.unbind`` per leaf, so the views share the stack's storage and
    the backward pass stacks each leaf's gradient once (indexing the stack
    layer by layer would write a zero tensor of the whole stack per layer)."""
    per_leaf = {k: unstack(v) if isinstance(v, dict) else torch.unbind(v) for k, v in tree.items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _logits(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return shard(einsum("bsd,dv->bsv", x, params["lm_head"]), ("batch", "seq", "act_vocab"))


def lookup(table, tokens):
    """``table[tokens]`` through ``F.embedding``: the same rows as
    indexing, but its backward sums each row's gradients in a fixed order
    (indexing's accumulates them in parallel, so two runs of one step could
    differ in the last bit).

    A DTensor table sharded over the vocab meets ``aten.embedding``'s
    strategy, a masked partial of the rows, which fails twice: with the
    batch sharded too its mask takes the tokens' local shape, and without
    sequence parallelism its backward cannot turn the gradient's partial
    sum into the masked one.  So a table that is trained, or whose rows
    looked up outweigh it (prefill), is made whole first (a gather of the
    table, as FSDP gathers every weight; a table still sharded over its
    width would make DTensor gather the tokens and look up the whole
    batch on every device), and one that is not (decode) reads replicated
    tokens, which cost far less than the table."""
    if is_dtensor(table):
        from torch.distributed.tensor import Replicate

        rows_bytes = tokens.numel() * table.shape[1] * table.element_size()
        if (torch.is_grad_enabled() and table.requires_grad) or rows_bytes > table.numel() * table.element_size():
            table = table.redistribute(table.device_mesh, [Replicate()] * table.device_mesh.ndim)
        elif is_dtensor(tokens):
            tokens = tokens.redistribute(tokens.device_mesh, [Replicate()] * tokens.device_mesh.ndim)
    return F.embedding(tokens, table)


def _embed(cfg: ArchConfig, params, tokens, prefix_embeds) -> torch.Tensor:
    x = lookup(params["embed"], tokens)  # a fresh tensor
    if prefix_embeds is not None and cfg.prefix_len:
        x[:, : prefix_embeds.shape[1]] = prefix_embeds.to(x.dtype)
    return x


def _block(cfg: ArchConfig, x: torch.Tensor, lp):
    """One pre-norm residual Mamba2 layer: (x, final ssm state, conv tail)."""
    out, ssm_state, conv_tail = mamba2_forward(cfg, rms_norm(x, lp["ln"], cfg.norm_eps), lp)
    return x + out, ssm_state, conv_tail


def run_layers(cfg: ArchConfig, x: torch.Tensor, layers: Sequence[Dict[str, Any]], mode: str = "none"):
    """Mamba2 layers (per-layer trees, from ``unstack``) on the full
    sequence, each under the remat policy ``mode``; returns (x, [final ssm
    state], [conv tail]) per layer."""
    block = remat(mode, lambda x, lp: _block(cfg, x, lp))
    ssm, conv = [], []
    for lp in layers:
        x, ssm_state, conv_tail = block(x, lp)
        x = shard(x, ("batch", "seq", None))
        ssm.append(ssm_state)
        conv.append(conv_tail)
    return x, ssm, conv


def _write(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a DTensor ``src`` is first placed as ``dst`` is
    (DTensor refuses an in-place copy that would change ``dst``'s
    placements)."""
    if is_dtensor(dst) and tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


def decode_layers(cfg: ArchConfig, x: torch.Tensor, layers: Sequence[Dict[str, Any]], cache, start: int):
    """Mamba2 layers ``start, start + 1, …`` (per-layer trees) for one token
    per sequence; their states in ``cache["ssm"]`` and ``cache["conv"]`` are
    updated in place."""
    for i, lp in enumerate(layers, start):
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        out, ssm_state, conv_state = mamba2_decode(cfg, h, lp, cache["ssm"][i], cache["conv"][i])
        _write(cache["ssm"][i], ssm_state)
        _write(cache["conv"][i], conv_state)
        x = x + out
    return x


def forward(
    cfg: ArchConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,
    prefix_embeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    x = shard(_embed(cfg, params, tokens, prefix_embeds), ("batch", "seq", None))
    x, _, _ = run_layers(cfg, x, unstack(params["layers"]), cfg.remat)
    return _logits(cfg, params, x)


def init_decode_cache(
    cfg: ArchConfig, batch: int, max_len: int, device: Device = None
) -> Dict[str, Any]:
    device = resolve_device(device)
    L, H, P, N = cfg.num_layers, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "ssm": torch.zeros((L, batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((L, batch, cfg.conv_width - 1, conv_ch), dtype=_dtype(cfg), device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def cache_logical_axes(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ssm": ("layers", "batch", "ssm_heads", None, None),
        "conv": ("layers", "batch", None, None),
        "pos": ("batch",),
    }


def prefill(
    cfg: ArchConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,
    prefix_embeds: Optional[torch.Tensor] = None,
    max_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    B, S = tokens.shape
    x = shard(_embed(cfg, params, tokens, prefix_embeds), ("batch", "seq", None))
    x, ssm_states, conv_tails = run_layers(cfg, x, unstack(params["layers"]))
    logits = _logits(cfg, params, x[:, -1:, :])
    cache = {
        "ssm": torch.stack(ssm_states),
        "conv": torch.stack(conv_tails).to(_dtype(cfg)),
        "pos": torch.full((B,), S, dtype=torch.int32, device=x.device),
    }
    return logits, cache


def decode_step(
    cfg: ArchConfig,
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cache: Dict[str, Any],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token per sequence.  The cache's ``ssm`` and ``conv`` tensors are
    updated in place (the reference donates them to jit) and returned in a
    new dict with the advanced positions."""
    x = shard(lookup(params["embed"], tokens), ("batch", None, None))  # (B,1,D); see hybrid.decode_step
    x = decode_layers(cfg, x, unstack(params["layers"]), cache, 0)
    logits = _logits(cfg, params, x)
    return logits, {"ssm": cache["ssm"], "conv": cache["conv"], "pos": cache["pos"] + 1}
