"""Model building blocks in plain PyTorch (the port of the parts of
`repro.models.layers` that the dense and MoE models run): rmsnorm in the
`(1 + scale)` form, RoPE, the SwiGLU or GELU MLP and the int8 KV
quantization.
Shapes follow the reference:
activations [B, S, H, dh]. Attention is a kernel (`kernels/ops.py`:
`flash_prefill`, `decode_attention`, `decode_attention_paged` and the
int8 `decode_attention_q8`, `decode_attention_paged_q8`); its plain
version, the port of `layers.attention` with a window, is
`kernels/ref.py` `flash_prefill`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x, scale, eps=1e-5):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope_freqs(dh: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x, positions, theta=10000.0):
    """x: [B, S, H, dh]; positions: [B, S] (int)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # [dh/2]
    ang = positions.float()[..., None] * freqs                # [B, S, dh/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp(x, w1, w2, w3, act: str = "swiglu"):
    """w1, w3: [d, ff]; w2: [ff, d]. swiglu: silu(x @ w1) * (x @ w3) @ w2;
    gelu: gelu(x @ w1) @ w2 with jax.nn.gelu's default, the tanh
    approximation (w3 unused, may be None)."""
    h = x @ w1
    if act == "swiglu":
        h = F.silu(h) * (x @ w3)
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(act)
    return h @ w2


def quantize_kv(x):
    """[.., S, G, dh] -> (int8 values, f32 scales [.., S, G]): a scale
    per position and kv head, max|x| / 127 in f32 clamped to 1e-10, and
    values round(x / s) half to even, bit for bit the reference's."""
    xf = x.float()
    s = (xf.abs().amax(-1) / 127.0).clamp(min=1e-10)
    return torch.round(xf / s[..., None]).to(torch.int8), s


def dequantize_kv(q, s, dtype=torch.bfloat16):
    """Inverse of `quantize_kv`: int8 values [.., S, G, dh] x scales
    [.., S, G] -> dtype, (q.f32 * s).to(dtype). This is the value every
    int8-KV path attends: the wave prefill, the chunked paged prefill and
    the scales of the int8 decode kernels."""
    return (q.float() * s[..., None].float()).to(dtype)
