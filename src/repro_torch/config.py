"""Model configuration: the part of `repro.config.ModelConfig` that the
port's dense and MoE models need (RoPE; SwiGLU or GELU; causal, or
bidirectional for the gte-small encoder; optional sliding window,
optional int8 KV cache; same field names and defaults as the reference,
and the same `reduced` sizes)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    """Token-choice top-k experts (`repro.config.MoEConfig`'s serving
    fields). `dense_residual`: a dense FFN runs beside the experts."""
    num_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    dense_residual: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    qkv_bias: bool = False
    act: str = "swiglu"           # swiglu | gelu
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    causal: bool = True           # False -> bidirectional encoder (gte)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    family: str = "dense"         # dense | moe
    moe: MoEConfig = field(default_factory=MoEConfig)
    # int8 KV cache: int8 values with f32 scales per position and kv head
    kv_quant: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to 256, as the reference pads its embedding."""
        return -(-self.vocab_size // 256) * 256

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def reduced(self, **over: Any) -> "ModelConfig":
        """Small same-family config for CPU tests (`repro`'s `reduced`)."""
        kw: dict[str, Any] = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
        )
        if self.family == "moe":
            kw["moe"] = MoEConfig(
                num_experts=4, top_k=min(self.moe.top_k, 2), expert_d_ff=64,
                dense_residual=self.moe.dense_residual)
        if self.sliding_window:
            kw["sliding_window"] = 64
        kw.update(over)
        return dataclasses.replace(self, **kw)
