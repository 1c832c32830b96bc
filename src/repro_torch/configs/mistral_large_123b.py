"""Mistral-Large-Instruct-2407 (123B): dense GQA, 96 heads over 8.
[hf:mistralai/Mistral-Large-Instruct-2407]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1e6,
)
