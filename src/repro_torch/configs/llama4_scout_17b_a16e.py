"""llama4-scout-17b-a16e [moe] — MoE 16 experts top-1 + shared expert,
early fusion [hf:meta-llama/Llama-4-Scout-17B-16E].
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp="swiglu",
    num_experts=16,
    experts_per_token=1,
    moe_shared_expert=True,
    microbatches=8,
)
