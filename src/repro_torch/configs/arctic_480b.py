"""Snowflake Arctic-base: dense-MoE hybrid, 128 experts top-2 beside a
dense residual FFN. [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=2, expert_d_ff=4864,
                  dense_residual=True),
)
