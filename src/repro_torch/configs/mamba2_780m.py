"""mamba2-780m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060].  48L d_model=1536 vocab=50280, ssm_state=128,
expand=2 (d_inner=3072, 48 SSM heads of dim 64)."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=1,
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    microbatches=2,
)
