"""Mamba2 — state-space duality (SSD), chunked, on torch tensors.

The port of ``repro.models.ssm``: the blocked SSD algorithm of
arXiv:2405.21060 §6.  The sequence is split into chunks of ``Q``;
intra-chunk terms are batched products against the decay matrix ``L``, and
inter-chunk terms flow through a loop over per-chunk states.  This turns the
recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;    y_t = C_t h_t + D x_t

into dense products.  ``ssd_chunked`` is the plain path with the kernels off
and the basis of the SSD kernel's plain version; ``mamba2_forward`` takes
the kernel (``kernels.mamba2_ssd``) when ``cfg.use_pallas_kernels`` is set
and no initial state is given, as the reference does.

Single B/C group (G=1), as in the mamba2-780m and zamba2 configs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import einsum, per_shard, reshape, shard, whole_dims
from repro_torch.models.config import ArchConfig

__all__ = [
    "ssd_chunked",
    "ssd_decode_step",
    "mamba2_forward",
    "mamba2_decode",
    "causal_conv",
    "conv_decode_step",
    "mamba2_layer_param_shapes",
]


def ssd_chunked(
    xh: torch.Tensor,  # (B, S, H, P)  inputs split into SSM heads
    dt: torch.Tensor,  # (B, S, H)     softplus-ed step sizes
    A: torch.Tensor,  # (H,)          negative decay rates
    Bm: torch.Tensor,  # (B, S, N)     input projections (G=1)
    Cm: torch.Tensor,  # (B, S, N)     output projections
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) in xh's dtype, final_state (B,H,P,N) f32).

    On DTensors the sequence is made whole once, before it is split into
    chunks: the loop over chunks reads one chunk at a time, and DTensor
    cannot split a sharded sequence into a chunk count the mesh dim does
    not divide ("Cannot unflatten unevenly sharded tensor")."""
    xh, dt, Bm, Cm = (whole_dims(t, [1]) for t in (xh, dt, Bm, Cm))
    B_, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S_real = S
    if S % Q:  # pad tail with dt=0 rows: exp(0)=1 decay, zero input — no-op
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    f32 = torch.float32

    xc = reshape(xh, B_, nc, Q, H, P).to(f32)
    dtc = reshape(dt, B_, nc, Q, H).to(f32)
    Bc = reshape(Bm, B_, nc, Q, N).to(f32)
    Cc = reshape(Cm, B_, nc, Q, N).to(f32)

    dA = dtc * A.to(f32)  # (B,nc,Q,H), negative
    dA_cs = per_shard(lambda t: torch.cumsum(t, dim=2), dA, [2])  # inclusive within-chunk cumsum

    # ---- intra-chunk: (C·Bᵀ ⊙ L) @ (dt·x)
    scores = einsum("bcqn,bctn->bcqt", Cc, Bc)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    # mask INSIDE the exponent: no exp of a positive number is formed
    diff = dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :]  # (B,nc,Q,Q,H)
    diff = torch.where(tri[None, None, :, :, None], diff, -torch.inf)
    M = scores[..., None] * torch.exp(diff)
    y_intra = einsum("bcqth,bcth,bcthp->bcqhp", M, dtc, xc)

    # ---- per-chunk contributed state: Σ_t exp(dA_sum − dA_cs[t]) dt_t B_t ⊗ x_t
    dA_sum = dA_cs[:, :, -1, :]  # (B,nc,H)
    w = dtc * torch.exp(dA_sum[:, :, None, :] - dA_cs)  # (B,nc,Q,H)
    S_chunk = einsum("bctn,bcth,bcthp->bchpn", Bc, w, xc)

    # ---- inter-chunk recurrence (loop over chunks)
    h = torch.zeros((B_, H, P, N), dtype=f32, device=xh.device) if h0 is None else h0.to(f32)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * torch.exp(dA_sum[:, c])[:, :, None, None] + S_chunk[:, c]
    h_prev = torch.stack(h_prevs, dim=1)  # (B,nc,H,P,N) state entering chunk

    # ---- inter-chunk output: exp(dA_cs[q]) · C_q · h_prev
    y_inter = einsum("bcqn,bchpn,bcqh->bcqhp", Cc, h_prev, torch.exp(dA_cs))
    y = reshape(y_intra + y_inter, B_, S, H, P)[:, :S_real]
    return y.to(xh.dtype), h


def ssd_decode_step(
    x: torch.Tensor,  # (B, H, P)
    dt: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, N)
    Cm: torch.Tensor,  # (B, N)
    h: torch.Tensor,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence: O(H·P·N) per step, state size constant."""
    f32 = torch.float32
    dA = (dt.to(f32) * A.to(f32))[:, :, None, None]  # (B,H,1,1)
    dBx = einsum("bn,bh,bhp->bhpn", Bm.to(f32), dt.to(f32), x.to(f32))
    h = h * torch.exp(dA) + dBx
    y = einsum("bhpn,bn->bhp", h, Cm.to(f32))
    return y.to(x.dtype), h


# ----------------------------------------------------------- conv + block
def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq.  x: (B,S,C), w: (K,C), b: (C,).
    On a DTensor the sequence is made whole and each shift runs on the
    local shard: torch 2.11's DTensor fails on the shift's pad
    (``constant_pad_nd``: an ``IndexError`` in its strategy)."""
    x = whole_dims(x, [1])
    K = w.shape[0]
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):  # K is tiny (4): unrolled shifts
        shift = K - 1 - i
        xi = per_shard(lambda t: F.pad(t, (0, 0, shift, 0))[:, :S, :], x, [1])
        out = out + xi.float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def conv_decode_step(
    x_new: torch.Tensor,  # (B, C) newest input
    conv_state: torch.Tensor,  # (B, K-1, C) previous inputs
    w: torch.Tensor,
    b: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)  # (B,K,C)
    y = einsum("bkc,kc->bc", window.float(), w.float())
    y = (y + b.float()).to(x_new.dtype)
    return y, window[:, 1:, :]


def mamba2_layer_param_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    D, d_in, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_ch = d_in + 2 * N
    return {
        "in_proj": (D, 2 * d_in + 2 * N + H),
        "conv_w": (cfg.conv_width, conv_ch),
        "conv_b": (conv_ch,),
        "A_log": (H,),
        "D_skip": (H,),
        "dt_bias": (H,),
        "norm": (d_in,),
        "out_proj": (d_in, D),
        "ln": (D,),
    }


def _split_zxbcdt(cfg: ArchConfig, zxbcdt: torch.Tensor):
    d_in, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in : d_in + d_in + 2 * N]
    dt = zxbcdt[..., d_in + d_in + 2 * N :]
    return z, xbc, dt


def mamba2_forward(
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, S, D) post-norm residual input
    p: Dict[str, torch.Tensor],
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence Mamba2 mixer.  Returns (out (B,S,D), final ssm state
    (B,H,P,N), conv tail (B,K-1,conv_ch)) so prefill can hand off to decode."""
    from repro_torch.models.layers import rms_norm

    B, S, D = x.shape
    d_in, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_head_dim
    zxbcdt = einsum("bsd,de->bse", x, p["in_proj"])
    z, xbc_raw, dt_raw = _split_zxbcdt(cfg, zxbcdt)
    xbc = F.silu(causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = xbc[..., :d_in], xbc[..., d_in : d_in + N], xbc[..., d_in + N :]
    xh = shard(reshape(xs, B, S, H, P), ("batch", None, "ssm_heads", None))
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    if cfg.use_pallas_kernels and h0 is None:
        from repro_torch.kernels.mamba2_ssd import ssd as ssd_kernel

        y, h_final = ssd_kernel(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    else:
        y, h_final = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk, h0=h0)
    y = y + p["D_skip"].float()[None, None, :, None] * xh.float()
    y = reshape(y, B, S, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = einsum("bse,ed->bsd", y, p["out_proj"])
    K1 = cfg.conv_width - 1
    conv_tail = xbc_raw[:, S - K1 :, :] if S >= K1 else F.pad(xbc_raw, (0, 0, K1 - S, 0))
    return out, h_final, conv_tail


def mamba2_decode(
    cfg: ArchConfig,
    x: torch.Tensor,  # (B, 1, D)
    p: Dict[str, torch.Tensor],
    ssm_state: torch.Tensor,  # (B, H, P, N)
    conv_state: torch.Tensor,  # (B, K-1, conv_ch)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    from repro_torch.models.layers import rms_norm

    B = x.shape[0]
    d_in, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_head_dim
    zxbcdt = einsum("bsd,de->bse", x, p["in_proj"])[:, 0]  # (B, E)
    z, xbc_raw, dt_raw = _split_zxbcdt(cfg, zxbcdt)
    xbc, conv_state = conv_decode_step(xbc_raw, conv_state, p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc)
    xs, Bm, Cm = xbc[..., :d_in], xbc[..., d_in : d_in + N], xbc[..., d_in + N :]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = reshape(xs, B, H, P)
    y, ssm_state = ssd_decode_step(xh, dt, A, Bm, Cm, ssm_state)
    y = y + p["D_skip"].float()[None, :, None] * xh.float()
    y = reshape(y, B, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = einsum("be,ed->bd", y, p["out_proj"])[:, None, :]
    return out, ssm_state, conv_state
