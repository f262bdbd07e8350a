"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242].  38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  Shared transformer block applied every 6 SSM layers."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    mlp="swiglu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_period=6,
    microbatches=2,
)
