"""H2O-Danube 1.8B: llama+mistral mix with sliding-window attention
(window 4096), the dense sliding-window model of the repo.
[arXiv:2401.16818]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    head_dim=80,
    sliding_window=4096,
    subquadratic=True,
)
