"""Architecture configuration — one frozen dataclass describes every arch.

``reduced()`` derives the CPU-smoke-test variant of the same family: few
layers, narrow width, tiny vocab — structure preserved (MoE stays MoE,
hybrid stays hybrid) so smoke tests exercise the real code paths.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    mlp: str = "swiglu"  # swiglu | relu2 | gelu
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_shared_expert: bool = False
    # --- attention ---
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 = full attention
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- hybrid (zamba2): shared attention block every k SSM layers ---
    hybrid_period: int = 0
    # --- modality frontend stub ---
    frontend: str = "none"  # none | audio_frames | vision_patches
    prefix_len: int = 0
    # --- numerics / training knobs (hillclimbable) ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # activation/param dtype
    remat: str = "full"  # none | full | dots
    microbatches: int = 1
    logit_softcap: float = 0.0
    # Pallas fast path (real-TPU runs; CPU tests use interpret mode).  The
    # dry-run/roofline path keeps this False so cost_analysis sees every
    # FLOP (custom-calls are opaque to it) — see DESIGN.md §5.
    use_pallas_kernels: bool = False
    # per-arch sharding-rule patches, e.g. mixtral's 8 experts on a 16-way
    # "model" axis: (("experts", None), ("expert_mlp", "model"))
    rule_overrides: Tuple[Tuple[str, Optional[str]], ...] = ()

    # ------------------------------------------------------------------ sugar
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM state, hybrid, or
        sliding-window attention.)"""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (N for the 6·N·D model-FLOPs check)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.resolved_head_dim
        n = V * D  # embeddings
        if not self.tie_embeddings:
            n += D * V  # lm head

        def attn_params() -> int:
            return D * self.num_heads * hd + 2 * D * self.num_kv_heads * hd + self.num_heads * hd * D

        def mlp_params(ff: int) -> int:
            mats = 3 if self.mlp == "swiglu" else 2
            return mats * D * ff

        if self.family == "ssm":
            d_in, N, H = self.d_inner, self.ssm_state, self.ssm_nheads
            G = 1
            per = (
                D * (2 * d_in + 2 * G * N + H)  # in_proj (z,x,B,C,dt)
                + self.conv_width * (d_in + 2 * G * N)  # conv
                + 2 * H  # A_log, D
                + d_in * D  # out_proj
                + 2 * D  # norms
            )
            return n + L * per
        if self.family == "hybrid":
            d_in, N, H = self.d_inner, self.ssm_state, self.ssm_nheads
            G = 1
            per = (
                D * (2 * d_in + 2 * G * N + H)
                + self.conv_width * (d_in + 2 * G * N)
                + 2 * H
                + d_in * D
                + 2 * D
            )
            shared = attn_params() + mlp_params(F) + 2 * D
            return n + L * per + shared
        per = attn_params() + 2 * D
        if self.num_experts:
            per += D * self.num_experts  # router
            per += self.num_experts * mlp_params(F) // 1
            if self.moe_shared_expert:
                per += mlp_params(F)
        else:
            per += mlp_params(F)
        return n + L * per

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.num_layers
        mats = 3 if self.mlp == "swiglu" else 2
        dense_like = self.param_count() - L * self.num_experts * mats * D * F
        active = L * self.experts_per_token * mats * D * F
        return dense_like + active

    def reduced(self) -> "ArchConfig":
        """Same family, toy size — for CPU smoke tests."""
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 4 if self.hybrid_period else 3),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads // max(1, self.num_heads // 4))),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            # no-drop capacity: capacity dropping depends on the *whole batch*
            # (not causal), which would break prefill/decode-vs-forward
            # equivalence tests; production configs keep cf≈1.25
            capacity_factor=float(max(self.num_experts, 1)) * 2.0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32,
            ssm_chunk=16,
            hybrid_period=2 if self.hybrid_period else 0,
            prefix_len=min(self.prefix_len, 4) if self.prefix_len else 0,
            dtype="float32",
            remat="none",
            microbatches=1,
        )


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
