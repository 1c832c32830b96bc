"""Model configuration: the part of `repro.config.ModelConfig` that the
port's five families need (dense and MoE decoders with RoPE, M-RoPE or
no rotary embedding; SwiGLU, squared-ReLU or GELU FFNs; causal, or
bidirectional for the gte-small encoder; optional sliding window,
optional int8 KV cache; the Mamba2, RG-LRU and encoder-decoder
sub-configs; remat and the MoE capacity factor of training; whether a
sub-quadratic path takes the long_500k cell), with the reference's field
names and defaults and the same `reduced` sizes; and the run's
`ShapeConfig` (the reference's four `SHAPES`), `MeshConfig` (the
production mesh that `launch.mesh` builds), `TrainConfig` and
`RunConfig`."""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    """Token-choice top-k experts (`repro.config.MoEConfig` but its
    `router_jitter`). `dense_residual`: a dense FFN runs beside the
    experts. `capacity_factor` sizes each expert's buffer in training
    (the slots past it are dropped); serving never drops. `int8_gather`:
    on a mesh, the experts' FSDP all-gathers move int8 values and per-row
    scales (ZeRO++; `models.moe.Q8AllGather`) instead of the weights."""
    num_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    int8_gather: bool = False


class _FieldsEqual:
    """A sub-config equal to any dataclass of the same class name and the
    same field values, so that the port's sub-configs compare equal to
    the reference's (they have exactly its fields)."""

    def _values(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def __eq__(self, other):
        if (not dataclasses.is_dataclass(other)
                or type(other).__name__ != type(self).__name__):
            return NotImplemented
        return self._values() == _FieldsEqual._values(other)

    def __hash__(self):
        return hash(tuple(sorted(self._values().items())))


@dataclass(frozen=True, eq=False)
class MambaConfig(_FieldsEqual):
    """Mamba2 (SSD) mixer: state size N, head width P, d_inner =
    expand * d_model, the depthwise conv's width and the chunk of the
    chunked SSD scan."""
    ssm_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256


@dataclass(frozen=True, eq=False)
class RGLRUConfig(_FieldsEqual):
    """RecurrentGemma: the RG-LRU width (0: d_model), the local
    attention's window, the repeating block pattern ("r" recurrent, "a"
    local attention) and the recurrent block's conv width."""
    lru_width: int = 0
    local_window: int = 2048
    pattern: str = "rra"
    conv_width: int = 4


@dataclass(frozen=True, eq=False)
class EncDecConfig(_FieldsEqual):
    """Whisper-style encoder-decoder: layer counts and the encoder's
    frame count (the cross-attention's keys)."""
    encoder_layers: int = 12
    decoder_layers: int = 12
    cross_kv_len: int = 1500


def enc_len_for_tests() -> int:
    """The reduced encoder-decoder's frame count."""
    return 24


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
    act: str = "swiglu"           # swiglu | sq_relu | gelu
    sliding_window: Optional[int] = None
    rope_type: str = "rope"       # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    norm_eps: float = 1e-5
    causal: bool = True           # False -> bidirectional encoder (gte)
    tie_embeddings: bool = False
    modality: str = "text"        # text | audio | vision
    dtype: str = "bfloat16"
    family: str = "dense"         # dense | moe | encdec | rglru | mamba2
    moe: MoEConfig = field(default_factory=MoEConfig)
    mamba: MambaConfig = field(default_factory=MambaConfig)
    rglru: RGLRUConfig = field(default_factory=RGLRUConfig)
    encdec: EncDecConfig = field(default_factory=EncDecConfig)
    # int8 KV cache: int8 values with f32 scales per position and kv head
    kv_quant: bool = False
    # recompute each layer's activations in the backward pass (training)
    remat: bool = True
    # a sub-quadratic attention path exists (sliding window, recurrence or
    # SSD): the config takes the long_500k cell
    subquadratic: bool = False

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

    def param_count(self) -> int:
        """The reference's analytic parameter count (embedding and layer
        weights, vocab unpadded, norms as 2d a layer): it picks the
        optimizer's moment type and the microbatch count."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        att = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        if self.family == "mamba2":
            m = self.mamba
            d_in = m.expand * d
            nheads = d_in // m.head_dim
            per = d * (2 * d_in + 2 * m.ssm_state + nheads) + d_in * d + nheads
            return emb + self.num_layers * (per + 2 * d)
        ffn_mult = 3 if self.act == "swiglu" else 2
        ffn = ffn_mult * d * self.d_ff if self.d_ff else 0
        per = att + ffn + 2 * d
        if self.family == "moe":
            e_ffn = ffn_mult * d * self.moe.expert_d_ff
            per = (att + 2 * d + self.moe.num_experts * e_ffn
                   + d * self.moe.num_experts)
            if self.moe.dense_residual:
                per += ffn
        if self.family == "encdec":
            return (emb + self.encdec.encoder_layers * per
                    + self.encdec.decoder_layers * (per + att))
        if self.family == "rglru":
            w = self.rglru.lru_width or d
            rec = (d * w * 2 + w * d + 2 * w * w + 3 * w
                   + w * self.rglru.conv_width)
            n_att = sum(1 for c in (self.rglru.pattern * self.num_layers)[
                :self.num_layers] if c == "a")
            return emb + n_att * per + (self.num_layers - n_att) * (
                rec + ffn + 2 * d)
        return emb + self.num_layers * per

    def active_param_count(self) -> int:
        """Parameters a token activates (MoE: only its top_k experts), the
        N of the dry run's 6 N T and 2 N T."""
        if self.family != "moe":
            return self.param_count()
        ffn_mult = 3 if self.act == "swiglu" else 2
        e_ffn = ffn_mult * self.d_model * self.moe.expert_d_ff
        inactive = (self.moe.num_experts - self.moe.top_k) * e_ffn
        return self.param_count() - self.num_layers * inactive

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
        if self.family == "mamba2":
            kw["mamba"] = MambaConfig(ssm_state=16, head_dim=32, expand=2,
                                      chunk_size=32)
            kw["num_heads"] = 8  # d_inner / head_dim = 256 / 32
        if self.family == "rglru":
            kw["rglru"] = RGLRUConfig(lru_width=128, local_window=64,
                                      pattern=self.rglru.pattern)
        if self.family == "encdec":
            kw["encdec"] = EncDecConfig(encoder_layers=2, decoder_layers=2,
                                        cross_kv_len=enc_len_for_tests())
        if self.sliding_window:
            kw["sliding_window"] = 64
        kw.update(over)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """A run's sequence length, global batch and kind (train | prefill |
    decode)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


# the reference's cells: (sequence length, global batch, kind)
SHAPES: dict = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    """The reference's device mesh: 16 x 16 over ("data", "model"), or
    2 x 16 x 16 over ("pod", "data", "model") with `multi_pod`
    (`launch.mesh.make_production_mesh(multi_pod=...)` builds it)."""
    multi_pod: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)


@dataclass(frozen=True)
class TrainConfig:
    """AdamW and the step: learning rate, warmup (then a cosine to 0.1 of
    it), decoupled weight decay, betas, eps, the global-norm clip (0: no
    clip), the z-loss weight and the gradients' int8 round trip
    ("int8_ef"). `microbatches` and `zero3` are the reference's fields,
    unread as there."""
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1
    zero3: bool = True
    grad_compression: str = "none"   # none | int8_ef
    z_loss: float = 0.0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    seed: int = 0
