"""Qwen2-72B: dense GQA with QKV bias. [arXiv:2407.10671]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
)
