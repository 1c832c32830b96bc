"""Qwen2-VL-2B backbone: M-RoPE over (t, h, w) position ids; the vision
frontend is a stub (callers pass 256 patch embeddings [B, 256, d]).
[arXiv:2409.12191]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    modality="vision",
    tie_embeddings=True,
)
