"""RecurrentGemma-9B: RG-LRU recurrent blocks and local attention
(window 2048; 16 query heads over one kv head at dh 256) in a 2:1
pattern ("rra" repeating). [arXiv:2402.19427]"""
from repro_torch.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="rglru",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    rglru=RGLRUConfig(lru_width=4096, local_window=2048, pattern="rra"),
    tie_embeddings=True,
    subquadratic=True,
)
