"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048.  Frontend (EnCodec frame embeddings) is a stub: input_specs
provides precomputed frame embeddings fused into the sequence prefix."""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    mlp="gelu",
    frontend="audio_frames",
    prefix_len=128,
    microbatches=2,
)
