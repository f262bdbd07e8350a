"""internvl2-76b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  The InternViT
frontend is a stub: input_specs provides precomputed patch embeddings
early-fused into the first prefix_len positions."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    mlp="swiglu",
    frontend="vision_patches",
    prefix_len=256,
    microbatches=16,
)
