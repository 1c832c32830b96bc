"""GTE-Small-like encoder (~33M params): the paper's embedding model for
queries, documents and SCR windows (384-d sentence embeddings), a
bidirectional (non-causal) mean-pooled encoder. [arXiv:2308.03281]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gte-small",
    num_layers=12,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=30522,
    head_dim=64,
    act="gelu",
    causal=False,
    tie_embeddings=True,
)
