"""Mamba2 (SSD, state-space duality) family (the port of
`repro.models.mamba2`; mamba2-780m). [arXiv:2405.21060]

A full sequence runs the chunked SSD algorithm (`ssd_chunked`): masked
quadratic products within each chunk of `chunk_size` positions and a
short recurrence over the chunks' states, in f32. A decode step is the
O(1) update of each layer's state h [B, H, N, P] and of its depthwise
conv's last K-1 inputs. Training (`forward_logits`) runs the whole
sequence through the same `ssd_chunked`, which autograd differentiates.
The reference has no Pallas kernel on this family and neither has the
port: the SSD's einsums are torch products
(`ssd_chunked` contracts each five-index einsum of the reference in two
steps, so no [B, NC, Q, Q, H, P] intermediate is built). The cache
{"h": [L, B, H, N, P] f32, "conv": [L, B, K-1, C]} has a fixed size, so
the wave engine never grows it; a decode step updates it in place.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.dense import LM, embed_shapes


def dims(cfg: ModelConfig):
    """(d_inner, heads H, head width P, state N)."""
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    return d_in, d_in // m.head_dim, m.head_dim, m.ssm_state


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> (shape, init), the reference's `mamba2.defs` flattened:
    the layers' norm, the projections to (z, x), (B, C) and dt, dt_bias
    ("dt_bias" init) and A_log ("a_log" init), the skip D (zeros), the
    conv's taps [L, K, d_inner + 2N], the gated norm and the output
    projection; then the embedding."""
    Ln, d = cfg.num_layers, cfg.d_model
    d_in, H, _, N = dims(cfg)
    K = cfg.mamba.conv_width
    defs = {
        "norm": ((Ln, d), "zeros"),
        "w_xz": ((Ln, d, 2 * d_in), "normal"),
        "w_bc": ((Ln, d, 2 * N), "normal"),
        "w_dt": ((Ln, d, H), "normal"),
        "dt_bias": ((Ln, H), "dt_bias"),
        "A_log": ((Ln, H), "a_log"),
        "D": ((Ln, H), "zeros"),
        "conv_w": ((Ln, K, d_in + 2 * N), "normal"),
        "ssm_norm": ((Ln, d_in), "zeros"),
        "w_out": ((Ln, d_in, d), "normal"),
    }
    defs.update(embed_shapes(cfg))
    return defs


def ssd_chunked(cfg: ModelConfig, A_log, D, xs, Bm, Cm, dt):
    """The chunked SSD scan: xs [B, S, d_inner]; Bm, Cm [B, S, N]; dt
    [B, S, H] f32 -> (y [B, S, d_inner] in xs's dtype, the final state
    [B, H, N, P] f32). A tail that is not a whole chunk is padded with
    zero dt (an identity step of the recurrence)."""
    d_in, H, P, N = dims(cfg)
    b, S, _ = xs.shape
    Q = min(cfg.mamba.chunk_size, S)
    pad = (-S) % Q
    if pad:
        xs, Bm, Cm, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xs, Bm, Cm, dt))
    S_orig, S = S, S + pad
    NC = S // Q
    A = -torch.exp(A_log.float())                      # [H], negative
    x4 = xs.reshape(b, NC, Q, H, P)
    dtc = dt.reshape(b, NC, Q, H)
    Bc = Bm.reshape(b, NC, Q, N).float()
    Cc = Cm.reshape(b, NC, Q, N).float()
    seg = torch.cumsum(dtc * A, dim=2)                 # [B, NC, Q, H]
    xdt = x4.float() * dtc[..., None]                  # [B, NC, Q, H, P]

    # within each chunk: scores C_q . B_k times the decay from k to q,
    # masked to k <= q ("bcqk,bcqkh,bckhp->bcqhp" in two steps)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    ldiff = seg[:, :, :, None, :] - seg[:, :, None, :, :]   # [B,NC,Q,K,H]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xs.device))
    lmat = torch.where(mask[None, None, :, :, None], torch.exp(ldiff),
                       torch.zeros((), device=xs.device))
    y = torch.einsum("bcqkh,bckhp->bcqhp", scores[..., None] * lmat, xdt)

    # each chunk's terminal state ("bckn,bckh,bckhp->bchnp")
    dte = torch.exp(seg[:, :, -1:, :] - seg)           # decay to chunk end
    states = torch.einsum("bckn,bckhp->bchnp", Bc, xdt * dte[..., None])

    # the recurrence over the NC chunk states
    chunk_decay = torch.exp(seg[:, :, -1])             # [B, NC, H]
    h = torch.zeros(b, H, N, P, device=xs.device)
    h_in = []
    for c in range(NC):
        h_in.append(h)                                 # state entering c
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)                    # [B, NC, H, N, P]

    # ("bcqn,bchnp,bcqh->bcqhp")
    y = y + torch.einsum("bcqn,bchnp->bcqhp", Cc, h_in) * \
        torch.exp(seg)[..., None]
    y = y.reshape(b, S, H, P) + x4.reshape(b, S, H, P).float() * \
        D.float()[None, None, :, None]
    return y.reshape(b, S, d_in)[:, :S_orig].to(xs.dtype), h


class Mamba2LM(LM):
    """Mamba2 decoder: the wave engine's `prefill` / `decode_step` over
    the fixed-size state cache (tied embeddings scaled by sqrt(d))."""

    FAMILY = "mamba2"
    shapes = staticmethod(param_shapes)

    def __init__(self, cfg: ModelConfig, **kw):
        d_in, H, _, _ = dims(cfg)
        if (cfg.num_kv_heads or cfg.d_ff or cfg.moe.num_experts
                or cfg.num_heads != H or d_in % cfg.mamba.head_dim):
            raise ValueError(
                f"{cfg.name}: a mamba2 config has no attention, FFN or "
                f"experts (num_kv_heads = d_ff = 0) and num_heads = d_inner "
                f"/ mamba.head_dim = {H}")
        super().__init__(cfg, **kw)

    def _proj(self, i: int, y):
        """z, xs [B, S, d_inner], bc [B, S, 2N] and dt = softplus(y @ w_dt
        + dt_bias) [B, S, H] in f32."""
        zx = y @ self.w_xz[i]
        z, xs = zx.chunk(2, dim=-1)
        bc = y @ self.w_bc[i]
        dt = F.softplus((y @ self.w_dt[i]).float() + self.dt_bias[i])
        return z, xs, bc, dt

    def mixer(self, i: int, x, state=None):
        """Layer i over x [B, S, d]: the whole sequence when `state` is
        None, else one step (S = 1) from state (h [B, H, N, P] f32, conv
        [B, K-1, C]). Returns (x + the block's output, the new state: the
        final h and the conv's last K-1 inputs)."""
        cfg = self.cfg
        d_in, H, P, N = dims(cfg)
        y = L.rmsnorm(x, self.norm[i], cfg.norm_eps)
        z, xs, bc, dt = self._proj(i, y)
        conv_in = torch.cat([xs, bc.to(xs.dtype)], dim=-1)
        conv_out, conv_state = L.causal_conv1d(
            conv_in, self.conv_w[i], None if state is None else state[1])
        conv_out = F.silu(conv_out)
        xs2, bc2 = conv_out[..., :d_in], conv_out[..., d_in:]
        Bm, Cm = bc2.chunk(2, dim=-1)
        if state is None:
            y_ssm, h = ssd_chunked(cfg, self.A_log[i], self.D[i], xs2, Bm,
                                   Cm, dt)
        else:
            A = -torch.exp(self.A_log[i].float())
            dA = torch.exp(dt[:, 0] * A)                       # [B, H]
            x1 = xs2[:, 0].reshape(-1, H, P).float()
            xdt = x1 * dt[:, 0][..., None]
            h = dA[..., None, None] * state[0] + torch.einsum(
                "bn,bhp->bhnp", Bm[:, 0].float(), xdt)
            yv = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), h)
            yv = yv + x1 * self.D[i].float()[None, :, None]
            y_ssm = yv.reshape(-1, 1, d_in).to(xs.dtype)
        y_ssm = L.rmsnorm(y_ssm * F.silu(z), self.ssm_norm[i], cfg.norm_eps)
        return x + y_ssm @ self.w_out[i], (h, conv_state)

    def forward_logits(self, tokens):
        """The training entry (the reference's `forward_logits`): logits
        [B, S, V] of tokens [B, S] int, each layer's mixer over the whole
        sequence (`ssd_chunked`) under `_remat`."""
        x = self._embed(tokens)
        for i in range(self.cfg.num_layers):
            x = self._remat(lambda j, y: self.mixer(j, y)[0], i, x)
        return self.logits_from_hidden(
            L.rmsnorm(x, self.final_norm, self.cfg.norm_eps))

    @torch.no_grad()
    def prefill(self, tokens):
        """tokens [B, S] int -> (last-position logits [B, V], the cache
        {"h": [L, B, H, N, P] f32, "conv": [L, B, K-1, C]})."""
        x = self._embed(tokens)
        hs, convs = [], []
        for i in range(self.cfg.num_layers):
            x, (h, conv) = self.mixer(i, x)
            hs.append(h)
            convs.append(conv.to(x.dtype))
        return self.final_logits(x), {"h": torch.stack(hs),
                                      "conv": torch.stack(convs)}

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        """One step of every row: token [B, 1] int (`pos` is unused: the
        state carries the position). Updates `cache` in place; returns
        logits [B, V]."""
        x = self._embed(token)
        for i in range(self.cfg.num_layers):
            x, (h, conv) = self.mixer(i, x, (cache["h"][i],
                                             cache["conv"][i]))
            cache["h"][i] = h
            cache["conv"][i] = conv.to(cache["conv"].dtype)
        return self.final_logits(x)
