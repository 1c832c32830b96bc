"""Mamba2-780m: attention-free SSD (state-space duality); d_inner =
2 * d_model = 3072, head_dim 64 -> 48 SSD heads, ssm_state 128.
[arXiv:2405.21060]"""
from repro_torch.config import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="mamba2",
    num_layers=48,
    d_model=1536,
    num_heads=48,            # = d_inner / mamba.head_dim
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=64,
    rope_type="none",
    mamba=MambaConfig(ssm_state=128, head_dim=64, expand=2, conv_width=4,
                      chunk_size=256),
    tie_embeddings=True,
    subquadratic=True,
)
