"""Qwen2.5-0.5B-like sLM: the paper's on-device generator. [arXiv:2412.15115]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen25-0.5b",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
)
