"""Model building blocks in plain PyTorch (the port of the parts of
`repro.models.layers` that the dense paged path runs): rmsnorm in the
`(1 + scale)` form, RoPE, causal attention with a query offset and a kv
length, and the SwiGLU MLP. Shapes follow the reference: activations
[B, S, H, dh], K/V [B, S, G, dh] with H % G == 0.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MASK = -1e30


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


def attention(q, k, v, *, q_offset: int, kv_len: int):
    """Causal masked softmax attention. q [B, Sq, H, dh]; k, v
    [B, Sk, G, dh]. Query i sits at position q_offset + i; keys past the
    query or at positions >= kv_len are masked with -1e30. Scores and
    softmax in f32, the probabilities rounded to v's type before the PV
    product, as in the reference's chunked flash loop."""
    b, sq, h, dh = q.shape
    sk, g = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, g, h // g, dh).float()
    s = torch.einsum("bqgnd,bkgd->bgnqk", qg, k.float()) * (1.0 /
                                                           math.sqrt(dh))
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < kv_len)
    s = torch.where(mask, s, torch.full_like(s, MASK))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    ctx = torch.einsum("bgnqk,bkgd->bqgnd", p, v.float())
    return ctx.reshape(b, sq, h, dh).to(q.dtype)


def mlp(x, w1, w2, w3):
    """SwiGLU: silu(x @ w1) * (x @ w3) @ w2."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2
