"""Model building blocks in plain PyTorch (the port of
`repro.models.layers` without its mesh helpers): rmsnorm in the
`(1 + scale)` form, RoPE and Qwen2-VL's M-RoPE, sinusoidal positions,
the SwiGLU, squared-ReLU or GELU MLP, the depthwise causal conv with
its streaming state, the int8 KV quantization, and `attention`, the
reference's chunked online-softmax attention that training runs.
Shapes follow the reference:
activations [B, S, H, dh]. Serving's attention is a kernel
(`kernels/ops.py`: `flash_prefill`, `decode_attention`,
`decode_attention_paged` and the int8 `decode_attention_q8`,
`decode_attention_paged_q8`), which has no backward; its plain version
is `kernels/ref.py` `flash_prefill`.
"""
from __future__ import annotations

import math

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


def apply_mrope(x, positions3, sections, theta=1e6):
    """M-RoPE (Qwen2-VL): x [B, S, H, dh]; positions3 [B, S, 3] the (t, h,
    w) ids; `sections` share the dh/2 frequency slots among the three
    streams in order. When they do not sum to dh/2 (a reduced head dim)
    each is rescaled to max(1, int(s * f)) with f = (dh/2) / sum, and the
    last takes the rest, as the reference does."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # [dh/2]
    sections = list(sections)
    if sum(sections) != dh // 2:
        f = (dh // 2) / sum(sections)
        sections = [max(1, int(s * f)) for s in sections]
        sections[-1] = dh // 2 - sum(sections[:-1])
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])
    pos = positions3.float()[..., sec]                        # [B, S, dh/2]
    ang = pos * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d: int, offset: int = 0,
                         device=None):
    """[seq_len, d] f32: sin at even columns, cos at odd, of (position +
    offset) * exp(-2i * log(10000) / d)."""
    pos = (torch.arange(seq_len, dtype=torch.float32, device=device)
           + offset)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros(seq_len, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def mlp(x, w1, w2, w3, act: str = "swiglu"):
    """w1, w3: [d, ff]; w2: [ff, d]. swiglu: silu(x @ w1) * (x @ w3) @ w2;
    sq_relu: relu(x @ w1)^2 @ w2; gelu: gelu(x @ w1) @ w2 with
    jax.nn.gelu's default, the tanh approximation (w3 unused by the two
    last, may be None)."""
    h = x @ w1
    if act == "swiglu":
        h = F.silu(h) * (x @ w3)
    elif act == "sq_relu":
        h = torch.square(F.relu(h))
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(act)
    return h @ w2


def causal_conv1d(x, w, state=None):
    """Depthwise causal conv: x [B, S, C], w [K, C]. Returns (y [B, S, C],
    the last K-1 inputs [B, K-1, C], the streaming state of the next
    call). `state` (the previous call's) stands before x; zeros when
    None. y sums the K taps in order, as the reference does."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    ys = sum(xp[:, i:i + s, :] * w[i] for i in range(k))
    return ys, (xp[:, -(k - 1):, :] if k > 1 else None)


def attention(q, k, v, *, causal: bool, window=None, q_offset: int = 0,
              kv_len=None, chunk: int = 1024):
    """The reference's `layers.attention`, the attention of the training
    forward (differentiable: autograd takes its backward). q [B, Sq, H,
    dh]; k, v [B, Sk, G, dh] with H % G == 0, the G kv heads not
    expanded. Query i at position q_offset + i attends the keys that the
    causal mask, the window (q - k < window) and kv_len (k < kv_len)
    leave, masked scores filled with -1e30. The keys run in chunks of
    `chunk` (zero-padded to whole chunks) through an online softmax: the
    running max, sum and accumulator in f32, each chunk's scores and
    probabilities in q's dtype before the f32 cast, as the reference
    computes them. Returns [B, Sq, H, dh] in q's dtype."""
    b, sq, h, dh = q.shape
    sk, g = k.shape[1], k.shape[2]
    n = h // g
    scale = 1.0 / math.sqrt(dh)
    nchunks = -(-sk // chunk)
    pad = nchunks * chunk - sk
    if pad:
        k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    dev = q.device
    qpos = q_offset + torch.arange(sq, device=dev)
    qg = q.reshape(b, sq, g, n, dh)
    m = torch.full((b, g, n, sq), -1e30, device=dev)
    l = torch.zeros((b, g, n, sq), device=dev)
    acc = torch.zeros((b, g, n, sq, dh), device=dev)
    for ci in range(nchunks):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        kpos = ci * chunk + torch.arange(chunk, device=dev)
        s = (torch.einsum("bqgnd,bkgd->bgnqk", qg, kb) * scale).float()
        mask = kpos[None, :] < sk
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        if kv_len is not None:
            mask = mask & (kpos[None, :] < kv_len)
        s = torch.where(mask, s, torch.full((), -1e30, device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        ctx = torch.einsum("bgnqk,bkgd->bgnqd", p.to(kb.dtype), vb)
        acc = acc * corr[..., None] + ctx.float()
        m = m_new
    out = acc / l[..., None].clamp(min=1e-30)
    return out.reshape(b, h, sq, dh).transpose(1, 2).to(q.dtype)


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
