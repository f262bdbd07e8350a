"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088].  56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768.  8 experts do not divide the 16-way "model" axis, so the
rule override shards d_ff (TP-within-expert) instead of experts (EP)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    mlp="swiglu",
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    microbatches=8,
    rule_overrides=(("experts", None), ("expert_mlp", "model"), ("act_experts", None)),
)
