"""Whisper-small backbone: encoder-decoder transformer with sinusoidal
positions; the conv frontend is a stub (callers pass frame embeddings
[B, frames, d]). [arXiv:2212.04356]"""
from repro_torch.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    act="gelu",
    rope_type="none",
    modality="audio",
    encdec=EncDecConfig(encoder_layers=12, decoder_layers=12,
                        cross_kv_len=1500),
)
