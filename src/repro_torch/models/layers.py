"""Model building blocks in plain PyTorch (the port of the parts of
`repro.models.layers` that the dense model runs): rmsnorm in the
`(1 + scale)` form, RoPE and the SwiGLU MLP. Shapes follow the reference:
activations [B, S, H, dh]. Attention is a kernel (`kernels/ops.py`:
`flash_prefill`, `decode_attention`, `decode_attention_paged`); its plain
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


def mlp(x, w1, w2, w3):
    """SwiGLU: silu(x @ w1) * (x @ w3) @ w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2
