"""Transformer building blocks on torch tensors: norms, RoPE, GQA attention
(full sequence, sliding window, blocked long context and one-token decode),
the dense MLPs and the capacity-based MoE layer.

The port of ``repro.models.layers``.  Every function keeps the reference's
dtype order: what the reference computes in f32 (norm statistics, RoPE
angles, attention scores and softmax, router logits and gates) is computed
in f32 here, and what it computes in the activation dtype stays in it.  Every
materialised tensor carries the reference's logical sharding constraint
(``dist.sharding.shard``), the identity unless sharding rules are active.

Attention on the full sequence takes the flash-attention kernel when
``cfg.use_pallas_kernels`` is set (``kernels.flash_attention``: the CUDA
kernel on a CUDA tensor, its plain version on a CPU tensor), and, whatever
the flag, when autograd records a call whose inputs the kernel's backward
takes (``trains_on_the_kernel``: whole bf16 CUDA tensors); otherwise the
reference's XLA formulations: blocked-local for a sliding window shorter
than the sequence, blocked online-softmax above 8192 positions, and
materialised scores below.  Every function is differentiable by autograd;
the kernel's gradient is its own backward kernel, as the reference defines
none for its Pallas kernel.  ``remat`` maps ``cfg.remat`` onto
``torch.utils.checkpoint``, and ``cross_entropy`` is the reference's masked
token-mean loss.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import current_rules, einsum, is_dtensor, reshape, shard, use_rules
from repro_torch.models.config import ArchConfig

__all__ = [
    "rms_norm",
    "rope_freqs",
    "apply_rope",
    "attention_train",
    "trains_on_the_kernel",
    "attention_decode",
    "write_positions",
    "mlp_apply",
    "moe_apply",
    "cross_entropy",
    "remat",
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


# Above this sequence length the quadratic score matrix stops fitting device
# memory and attention switches to the online-softmax blocked form.
_FLASH_THRESHOLD = 8192
_FLASH_QB = 1024  # query block
_FLASH_KB = 2048  # key/value block


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
    q = shard(einsum("bsd,dhk->bshk", x, wq), ("batch", None, "act_heads", None))
    k = shard(einsum("bsd,dhk->bshk", x, wk), ("batch", None, None, None))
    v = shard(einsum("bsd,dhk->bshk", x, wv), ("batch", None, None, None))
    q = apply_rope(q, positions[None, :], cfg.rope_theta)
    k = apply_rope(k, positions[None, :], cfg.rope_theta)
    scale = hd**-0.5
    k_kv, v_kv = k, v

    if cfg.use_pallas_kernels or trains_on_the_kernel(q, k, v):
        # the kernel folds the query heads of a KV head itself: no repeat
        from repro_torch.kernels.flash_attention import flash_attention

        out = flash_attention(q, k_kv, v_kv, scale=scale, causal=True, window=cfg.sliding_window)
    else:
        if KV != H:  # repeat-KV to the full heads, as every XLA branch takes them
            rep = H // KV
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        if cfg.sliding_window and S > cfg.sliding_window:
            out = _blocked_local_attention(q, k, v, cfg.sliding_window, scale)
        elif S > _FLASH_THRESHOLD:
            out = _blocked_causal_attention(q, k, v, scale)
        else:
            # f32 products of the activation-dtype inputs, f32 sums (the
            # reference's preferred_element_type=f32)
            scores = einsum("bshk,bthk->bhst", q.float(), k.float()) * scale
            scores = shard(scores, ("batch", "act_heads", None, None))
            mask = _causal_mask(S, S, window=cfg.sliding_window, device=x.device)
            scores = torch.where(mask[None, None], scores, _NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = einsum("bhst,bthk->bshk", probs, v)
    out = shard(out, ("batch", None, "act_heads", None))
    proj = einsum("bshk,hkd->bsd", out, wo)
    if return_kv:
        return proj, k_kv, v_kv
    return proj


def trains_on_the_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether an attention call goes through the flash-attention kernel's
    autograd Function: autograd is recording it (grad mode on, an input
    that requires grad) and the inputs are what the backward kernel takes:
    whole CUDA tensors (not DTensors or fake tensors) in bf16, a head width
    in ``HEAD_DIMS`` and at most ``MAX_GROUP`` query heads a KV head.  It
    reads the inputs alone, so a remat recomputation takes the path its
    forward took; the CPU, sharded, f32 and no-grad calls keep the plain
    path, which stays the oracle."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return False
    if not all(type(t) is torch.Tensor and t.is_cuda and t.dtype == torch.bfloat16 for t in (q, k, v)):
        return False
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS, MAX_GROUP

    return q.shape[-1] in HEAD_DIMS and q.shape[2] // k.shape[2] <= MAX_GROUP


def _blocked_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Causal attention with flash-attention memory behaviour in plain torch:
    a loop over query blocks, an inner loop over KV blocks with the running
    f32 (max, denominator, numerator).  q, k, v are ``(B, S, H, hd)`` with
    the KV heads already repeated.  S must be a multiple of both block sizes
    (where the reference's reshape would fail, this raises).

    The reference scans every KV block for every query block, masked; the
    blocks wholly after a query block's last position are skipped here.
    That changes no bit: KV block 0 always holds a visible key, so the
    running max is finite before any skipped block, whose probabilities
    would all be exp(-1e30 - m) = 0 with a correction of exp(0) = 1."""
    B, S, H, hd = q.shape
    QB, KB = min(_FLASH_QB, S), min(_FLASH_KB, S)
    if S % QB or S % KB:
        raise ValueError(f"S {S} is not a multiple of the blocks ({QB}, {KB})")
    out = torch.empty_like(q)
    for qi in range(S // QB):
        qblk = q[:, qi * QB : (qi + 1) * QB].float()
        qpos = qi * QB + torch.arange(QB, device=q.device)[:, None]
        m = torch.full((B, H, QB), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, QB), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, QB, hd), dtype=torch.float32, device=q.device)
        for ki in range(S // KB):
            if ki * KB > (qi + 1) * QB - 1:
                break
            kblk = k[:, ki * KB : (ki + 1) * KB]
            vblk = v[:, ki * KB : (ki + 1) * KB]
            s = einsum("bqhk,bthk->bhqt", qblk, kblk.float()) * scale
            kpos = ki * KB + torch.arange(KB, device=q.device)[None, :]
            s = torch.where((kpos <= qpos)[None, None], s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + einsum(
                "bhqt,bthk->bhqk", p.to(vblk.dtype).float(), vblk.float()
            )
            m = m_new
        out[:, qi * QB : (qi + 1) * QB] = (acc / l[..., None]).to(q.dtype).transpose(1, 2)
    return out


def _blocked_local_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, scale: float
) -> torch.Tensor:
    """Sliding-window attention in O(S·2W): block-diagonal plus one
    off-diagonal block.  q, k, v are ``(B, S, H, hd)`` with the KV heads
    already repeated; S must be a multiple of the window (where the
    reference's reshape would fail, this raises).  Block i's queries see
    keys in blocks i-1 and i, masked to the exact window.  The f32 scores
    are scaled and masked in place, so the peak holds the scores and the
    probabilities, not four copies."""
    B, S, H, hd = q.shape
    W = window
    if S % W:
        raise ValueError(f"S {S} is not a multiple of the window {W}")
    nb = S // W
    qb = reshape(q, B, nb, W, H, hd)
    kb = reshape(k, B, nb, W, H, hd)
    vb = reshape(v, B, nb, W, H, hd)
    # previous block (block -1 is zeros, fully masked)
    k_prev = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    v_prev = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    kk = torch.cat([k_prev, kb], dim=2)  # (B, nb, 2W, H, hd)
    vv = torch.cat([v_prev, vb], dim=2)
    scores = einsum("bnqhk,bnthk->bnhqt", qb.float(), kk.float())
    scores.mul_(scale)
    qpos = torch.arange(W, device=q.device)[:, None] + W  # query index within the 2W keys
    kpos = torch.arange(2 * W, device=q.device)[None, :]
    base = (kpos <= qpos) & (kpos > qpos - W)  # (W, 2W)
    has_prev = torch.arange(nb, device=q.device) > 0  # block 0's "previous" keys are padding
    allow = base[None] & (has_prev[:, None, None] | (kpos >= W)[None])  # (nb, W, 2W)
    scores.masked_fill_(~allow[None, :, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    del scores
    out = einsum("bnhqt,bnthk->bnqhk", probs, vv)
    return reshape(out, B, S, H, hd)


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
    q = einsum("bsd,dhk->bshk", x, wq)  # (B,1,H,hd)
    k = einsum("bsd,dhk->bshk", x, wk)  # (B,1,KV,hd)
    v = einsum("bsd,dhk->bshk", x, wv)
    # constrain the (B,1,·,hd) rows before they reach the cache write, as
    # the reference does (there XLA would otherwise all-reduce cache-sized
    # buffers a layer)
    q = shard(q, ("batch", None, "act_heads", None))
    k = shard(k, ("batch", None, None, None))
    v = shard(v, ("batch", None, None, None))
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)

    if is_dtensor(k_cache):
        # DTensor has no strategy for an index_put_ into a dim it shards (the
        # cache's kv_seq): write through a one-hot of the slots, a pointwise
        # select that leaves every shard where it is
        T = k_cache.shape[1]
        hit = (torch.arange(T, device=x.device)[None, :] == slot[:, None])[:, :, None, None]
        k_cache.copy_(torch.where(hit, k.to(k_cache.dtype), k_cache))
        v_cache.copy_(torch.where(hit, v.to(v_cache.dtype), v_cache))
    else:
        bidx = torch.arange(B, device=x.device)
        k_cache[bidx, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[bidx, slot] = v[:, 0].to(v_cache.dtype)
    k_cache = shard(k_cache, ("batch", "kv_seq", None, None))
    v_cache = shard(v_cache, ("batch", "kv_seq", None, None))

    # grouped-query attention over the cache (no KV repeat: q -> (B,1,KV,G,hd))
    G = H // KV
    qg = reshape(q, B, 1, KV, G, hd)
    scores = einsum("bskgh,btkh->bkgst", qg.float(), k_cache.float()) * (hd**-0.5)
    scores = torch.where(valid[:, None, None, None, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = reshape(einsum("bkgst,btkh->bskgh", probs, v_cache), B, 1, H, hd)
    return einsum("bshk,hkd->bsd", out, wo), k_cache, v_cache


def write_positions(kv_pos: torch.Tensor, slot: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """A copy of ``kv_pos`` (B, T) with ``pos[b]`` in slot ``slot[b]`` of
    each row.  On a DTensor, whose batch the rules shard, DTensor has no
    strategy for the ``index_put_`` ("in-place operations that require
    placement changes are not supported"): the write goes through a one-hot
    of the slots, as the cache's does."""
    if is_dtensor(kv_pos):
        T = kv_pos.shape[1]
        hit = torch.arange(T, device=slot.device)[None, :] == slot[:, None]
        return torch.where(hit, pos[:, None].to(kv_pos.dtype), kv_pos)
    out = kv_pos.clone()
    out[torch.arange(kv_pos.shape[0], device=kv_pos.device), slot] = pos
    return out


# ------------------------------------------------------------------- MLPs
def mlp_apply(cfg: ArchConfig, x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dense MLP: swiglu (w1·silu ⊙ w3) | relu2 (squared ReLU) | gelu."""
    h = einsum("bsd,df->bsf", x, w["w1"])
    if cfg.mlp == "swiglu":
        h = F.silu(h) * einsum("bsd,df->bsf", x, w["w3"])
    else:
        h = _act(cfg, h)
    h = shard(h, ("batch", None, "act_mlp"))
    return einsum("bsf,fd->bsd", h, w["w2"])


def _act(cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """The non-gated activations: squared ReLU, or GELU in the tanh form
    (``jax.nn.gelu``'s default)."""
    if cfg.mlp == "relu2":
        r = F.relu(h)
        return r * r
    return F.gelu(h, approximate="tanh")


def _expert_ffn(cfg: ArchConfig, xs: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """xs: (E, C, D) -> (E, C, D) through per-expert weights (E, D, F)."""
    h = einsum("ecd,edf->ecf", xs, w["w1"])
    if cfg.mlp == "swiglu":
        h = F.silu(h) * einsum("ecd,edf->ecf", xs, w["w3"])
    else:
        h = _act(cfg, h)
    # the hidden (E, C, F) covers both expert layouts: expert-parallel (E
    # over "model") and TP-within-expert (F over "model")
    h = shard(h, ("act_experts", "batch", "act_mlp"))
    return einsum("ecf,efd->ecd", h, w["w2"])


_MOE_GROUP = 512  # tokens per dispatch group


def moe_apply(cfg: ArchConfig, x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Capacity-based top-k MoE with grouped one-hot dispatch (GShard), as
    the reference's: tokens split into groups of at most 512, each group
    routing its tokens to a per-group expert capacity
    ``C = ceil(Tg·k/E · cf)``; overflow is dropped and the kept gates
    renormalised.  Dispatch and combine are einsums against a one-hot
    (G, Tg, E, C) tensor.

    A dropped (token, k) slot maps to capacity index C; ``jax.nn.one_hot``
    gives an all-zero row for it, so the one-hot here takes C + 1 classes
    and drops the last."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    g_size = min(_MOE_GROUP, S)
    while S % g_size:
        g_size -= 1
    G = T // g_size
    C = max(int(math.ceil(g_size * K / E * cfg.capacity_factor)), 1)
    xg = reshape(x, G, g_size, D)

    logits = einsum("gtd,de->gte", xg.float(), w["router"].float())  # f32
    gate_vals, expert_ids = torch.topk(logits, K, dim=-1)  # (G, Tg, K), descending
    gates = torch.softmax(gate_vals, dim=-1)

    # one-hot expert choice per k-slot: (G, Tg, K, E)
    onehot = F.one_hot(expert_ids, E).float()
    # position of each (token, k) inside its expert's per-group queue:
    # cumulative count over the flattened (Tg·K) routing slots
    flat = reshape(onehot, G, g_size * K, E)
    pos = reshape(torch.cumsum(flat, dim=1) - flat, G, g_size, K, E)  # before self
    pos_in_expert = (pos * onehot).sum(dim=-1)  # (G, Tg, K)
    keep = pos_in_expert < C
    gates = gates * keep  # drop overflow; renormalise below
    denom = torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    gates = gates / denom

    # dispatch one-hot over capacity slots: (G, Tg, K, C); a dropped slot
    # lands on the extra class C, which is cut off
    slot = torch.where(keep, pos_in_expert, float(C)).long()
    cap_oh = F.one_hot(slot, C + 1)[..., :C].float()
    dispatch = einsum("gtke,gtkc->gtec", onehot, cap_oh)
    combine = einsum("gtk,gtke,gtkc->gtec", gates, onehot, cap_oh)

    expert_in = einsum("gtec,gtd->egcd", dispatch.to(x.dtype), xg)
    expert_in = shard(reshape(expert_in, E, G * C, D), ("act_experts", "batch", None))
    expert_out = reshape(_expert_ffn(cfg, expert_in, w), E, G, C, D)
    out = einsum("gtec,egcd->gtd", combine.to(x.dtype), expert_out)

    if cfg.moe_shared_expert:
        out = out + mlp_apply(cfg, xg, w["shared"])
    return reshape(out, B, S, D)


# ------------------------------------------------------------------- loss
def gold_logits(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``lg[..., labels]``: each position's logit of its label.  On a
    DTensor it is a masked sum over the vocab instead of ``aten.gather``,
    whose strategy over a sharded vocab yields a masked partial that fails
    to reduce once the batch is redistributed; the sum shards over the
    vocab and adds one exact term to zeros."""
    if is_dtensor(lg):
        hit = labels[..., None] == torch.arange(lg.shape[-1], device=lg.device)
        return torch.where(hit, lg, 0.0).sum(dim=-1)
    return torch.gather(lg, -1, labels[..., None].long())[..., 0]


def cross_entropy(
    logits: torch.Tensor,  # (B, S, V) any float dtype
    labels: torch.Tensor,  # (B, S) int
    mask: torch.Tensor,  # (B, S) float or bool
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked token-mean CE in fp32.  Returns (loss, token_count)."""
    lg = logits.float()
    if softcap > 0:
        lg = torch.tanh(lg / softcap) * softcap
    lse = torch.logsumexp(lg, dim=-1)
    gold = gold_logits(lg, labels)
    mask = mask.float()
    nll = (lse - gold) * mask
    count = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll) / count, count


# ------------------------------------------------------------------ remat
def _save_dots(ctx, op, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    outputs of products without batch dimensions (the projections, which
    ``einsum`` lowers to ``mm`` or a ``bmm`` of batch 1) and recompute the
    rest, attention scores and expert products included."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op is aten.mm.default or (op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(mode: str, fn: Callable) -> Callable:
    """``fn`` under the reference's rematerialisation policy ``mode``:
    ``"none"`` keeps every activation, ``"full"`` keeps only ``fn``'s inputs
    and recomputes the rest in the backward pass, ``"dots"`` keeps the
    outputs of the products without batch dimensions as well.  With grad
    mode off (serving) ``fn`` runs as it is.  The recomputation runs under
    the sharding rules the forward ran under: on the card autograd runs the
    backward in a worker thread of its own, where the (thread-local) active
    rules are not, and a recomputation without them would place its
    tensors otherwise than the forward did."""
    if mode == "none":
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {mode!r}")
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    def contexts(rules):
        if mode == "dots":
            forward, recompute = create_selective_checkpoint_contexts(_save_dots)
        else:
            forward, recompute = contextlib.nullcontext(), contextlib.nullcontext()
        return forward, _under(recompute, use_rules(rules))

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(contexts, current_rules()))

    return run


@contextlib.contextmanager
def _under(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield
