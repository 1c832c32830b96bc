"""IBM Granite 3.0 1B-A400M base: 32 experts, top-8, the MoE model of the
repo. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    moe=MoEConfig(num_experts=32, top_k=8, expert_d_ff=512,
                  dense_residual=False),
    tie_embeddings=True,
)
