"""Nemotron-4 15B: GQA with a squared-ReLU FFN (not gated).
[arXiv:2402.16819]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    head_dim=128,
    act="sq_relu",
)
