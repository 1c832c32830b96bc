"""RecurrentGemma-style hybrid (the port of `repro.models.rglru`;
recurrentgemma-9b): RG-LRU recurrent blocks and local (sliding-window)
attention in a repeating pattern ("rra": two recurrent, one attention).
[arXiv:2402.19427]

Layers: the pattern repeats NB = num_layers // len(pattern) times as
stacked sub-layers "s{i}_..." ([NB, ...] weights), then the remainder
runs as "tail{j}_..." layers ([1, ...] weights) that follow the pattern
from its start.

RG-LRU: a_t = exp(-8 softplus(lam) sigmoid(r_t)),
        h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (sigmoid(i_t) x_t), in f32.
A whole sequence runs the reference's associative `combine` as a
log-depth doubling scan in torch (`rglru_scan`); a decode step is the
one-step update. Local attention runs `flash_prefill` with the window
over the whole sequence, and `decode_attention` over each layer's ring
(`ring=True`); training (`forward_logits`) runs `layers.attention` with
the window instead (the kernels have no backward).

The caches keep the reference's names and layouts: "s{i}_h" [NB, B, w]
f32 and "s{i}_conv" [NB, B, K-1, w] for a recurrent sub-layer, "s{i}_k",
"s{i}_v" [NB, B, win, G, dh] rings for an attention one, and "tail{j}_*"
without the NB axis. The ring holds win = min(local_window, S) slots for
an S-token prompt, position p in slot p % win, and the wave engine never
grows it, as in the reference: when the prompt is shorter than the
window, decode overwrites slots whose keys are still inside the window
(ROADMAP F10). A decode step updates the cache in place.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.dense import LM, attn_shapes, embed_shapes, mlp_shapes

RG_C = 8.0


def rec_shapes(cfg: ModelConfig, n: int, prefix: str) -> Dict[str, tuple]:
    """n stacked recurrent blocks (`rglru._rec_defs`)."""
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    K = cfg.rglru.conv_width
    return {
        f"{prefix}norm": ((n, d), "zeros"),
        f"{prefix}w_in": ((n, d, w), "normal"),
        f"{prefix}w_gate": ((n, d, w), "normal"),
        f"{prefix}conv_w": ((n, K, w), "normal"),
        f"{prefix}w_rx": ((n, w, 2 * w), "normal"),
        f"{prefix}b_rx": ((n, 2 * w), "zeros"),
        f"{prefix}lam": ((n, w), "lam"),
        f"{prefix}w_out": ((n, w, d), "normal"),
        **mlp_shapes(cfg, n, cfg.d_ff, prefix),
    }


def layer_plan(cfg: ModelConfig):
    """[(prefix, kind, index)] in execution order: for each of the NB
    repeats the pattern's sub-layers ("s{i}_", its letter, the repeat),
    then the tail layers ("tail{j}_", the pattern's j-th letter, 0)."""
    pat = cfg.rglru.pattern
    NB, rem = divmod(cfg.num_layers, len(pat))
    plan = [(f"s{i}_", c, blk) for blk in range(NB)
            for i, c in enumerate(pat)]
    return plan + [(f"tail{j}_", pat[j], 0) for j in range(rem)]


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> (shape, init), the reference's `rglru.defs` flattened: the
    stacked sub-layers "s{i}_*" [NB, ...], the tail layers "tail{j}_*"
    [1, ...] (convert.py flattens the reference's "tail{j}" sub-trees
    to these names) and the embedding."""
    pat = cfg.rglru.pattern
    NB, rem = divmod(cfg.num_layers, len(pat))
    defs: Dict[str, tuple] = {}
    sizes = [(f"s{i}_", c, NB) for i, c in enumerate(pat)]
    sizes += [(f"tail{j}_", pat[j], 1) for j in range(rem)]
    for prefix, c, n in sizes:
        if c == "r":
            defs.update(rec_shapes(cfg, n, prefix))
        else:
            defs.update(attn_shapes(cfg, n, prefix))
            defs.update(mlp_shapes(cfg, n, cfg.d_ff, prefix))
    defs.update(embed_shapes(cfg))
    return defs


def gates(w_rx, b_rx, lam, xc):
    """(log a [B, S, w], sqrt(1 - a^2) * sigmoid(i) * xc [B, S, w]), both
    f32, of the conv output xc."""
    r, i = (xc @ w_rx + b_rx).chunk(2, dim=-1)
    log_a = -RG_C * F.softplus(lam.float()) * torch.sigmoid(r.float())
    gated = xc.float() * torch.sigmoid(i.float())
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return log_a, beta * gated


def rglru_scan(log_a, bx):
    """h_t = exp(log_a_t) h_{t-1} + bx_t from h_{-1} = 0 along axis 1, by
    doubling: after the pass of stride d, position t holds the
    reference's `combine` of positions (t - 2d, t], the pair (sum of
    log a, h over them). log2(S) passes in f32."""
    a, h = log_a, bx
    d, S = 1, log_a.shape[1]
    while d < S:
        h = torch.cat([h[:, :d], torch.exp(a[:, d:]) * h[:, :-d] + h[:, d:]],
                      dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] + a[:, d:]], dim=1)
        d *= 2
    return h


class RGLRULM(LM):
    """RecurrentGemma decoder: the wave engine's `prefill` / `decode_step`
    over the recurrent states and local-attention rings."""

    FAMILY = "rglru"
    shapes = staticmethod(param_shapes)

    def _p(self, prefix: str, name: str, i: int):
        return getattr(self, prefix + name)[i]

    def rec_block(self, prefix: str, i: int, x, state=None):
        """Recurrent block over x [B, S, d] (the whole sequence, or one
        step from state (h [B, w] f32, conv [B, K-1, w])). Returns (the
        block's output, (h, conv)): the last h and the conv's last K-1
        inputs."""
        cfg = self.cfg

        def p(n):
            return self._p(prefix, n, i)
        y = L.rmsnorm(x, p("norm"), cfg.norm_eps)
        gate = F.gelu(y @ p("w_gate"), approximate="tanh")
        xin = y @ p("w_in")
        xc, conv = L.causal_conv1d(xin, p("conv_w"),
                                   None if state is None else state[1])
        log_a, bx = gates(p("w_rx"), p("b_rx"), p("lam"), xc)
        if state is None:
            hseq = rglru_scan(log_a, bx)
            h, yr = hseq[:, -1], hseq.to(xc.dtype)
        else:
            h = torch.exp(log_a[:, 0]) * state[0] + bx[:, 0]
            yr = h.to(xc.dtype)[:, None]
        x = x + (gate * yr) @ p("w_out")
        return self._ffn(i, x, prefix), (h, conv)

    def attn_block(self, prefix: str, i: int, x, positions, ring=None,
                   pos: int = 0, attn=None):
        """Local-attention block over x [B, S, d] at positions [B, S] (by
        `attn`, `flash_prefill` when None; causal, the window), or one
        decode step at `pos` into ring = (k, v) [B, win, G, dh] (slot
        pos % win, in place; `decode_attention` over min(pos + 1, win)
        slots). Returns (the block's output, (k, v) of the whole
        sequence, or None)."""
        cfg = self.cfg
        b, S, _ = x.shape
        y = L.rmsnorm(x, self._p(prefix, "attn_norm", i), cfg.norm_eps)
        q, k, v = self._qkv(i, y, positions, prefix)
        if ring is None:
            ctx = (attn or ops.flash_prefill)(q, k, v, causal=True,
                                              window=cfg.rglru.local_window)
            kv = (k, v)
        else:
            ck, cv = ring
            slot = pos % ck.shape[1]
            ck[:, slot], cv[:, slot] = k[:, 0], v[:, 0]
            lens = torch.full((b,), pos + 1, dtype=torch.int32,
                              device=x.device)
            ctx = ops.decode_attention(q[:, 0], ck, cv, lens, ring=True)
            kv = None
        x = x + ctx.reshape(b, S, -1) @ self._p(prefix, "wo", i)
        return self._ffn(i, x, prefix), kv

    @torch.no_grad()
    def prefill(self, tokens):
        """tokens [B, S] int -> (last-position logits [B, V], the cache:
        each recurrent layer's last h and last K-1 conv inputs, each
        attention layer's last win = min(local_window, S) keys and values
        rolled by S % win, so that position p lives in slot p % win)."""
        cfg = self.cfg
        b, S = tokens.shape
        win = min(cfg.rglru.local_window, S)
        positions = torch.arange(S, device=tokens.device)[None].expand(b, S)
        x = self._embed(tokens)
        parts: Dict[str, list] = {}
        for prefix, c, i in layer_plan(cfg):
            if c == "r":
                x, (h, conv) = self.rec_block(prefix, i, x)
                parts.setdefault(prefix + "h", []).append(h)
                parts.setdefault(prefix + "conv", []).append(conv)
            else:
                x, (k, v) = self.attn_block(prefix, i, x, positions)
                for n, t in (("k", k), ("v", v)):
                    parts.setdefault(prefix + n, []).append(
                        torch.roll(t[:, S - win:], S % win, dims=1))
        cache = {n: (ts[0] if n.startswith("tail") else torch.stack(ts))
                 for n, ts in parts.items()}
        return self.final_logits(x), cache

    def _train_layer(self, prefix: str, c: str, i: int, x, positions):
        if c == "r":
            return self.rec_block(prefix, i, x)[0]
        return self.attn_block(prefix, i, x, positions, attn=L.attention)[0]

    def forward_logits(self, tokens):
        """The training entry (the reference's `forward_logits`): logits
        [B, S, V] of tokens [B, S] int through the pattern's blocks and the
        tail layers, the RG-LRU by the doubling `rglru_scan`, local
        attention by `L.attention` with the window (no ring: F10 is a
        serving rule), each layer under `_remat`."""
        b, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(b, S)
        x = self._embed(tokens)
        for prefix, c, i in layer_plan(self.cfg):
            x = self._remat(self._train_layer, prefix, c, i, x, positions)
        return self.logits_from_hidden(
            L.rmsnorm(x, self.final_norm, self.cfg.norm_eps))

    @torch.no_grad()
    def hidden_states(self, tokens):
        """The final-normed hidden states [B, S, d] of tokens [B, S]."""
        b, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(b, S)
        x = self._embed(tokens)
        for prefix, c, i in layer_plan(self.cfg):
            if c == "r":
                x, _ = self.rec_block(prefix, i, x)
            else:
                x, _ = self.attn_block(prefix, i, x, positions)
        return L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        """One decode position `pos` for every row, token [B, 1] int.
        Updates `cache` in place; returns logits [B, V]."""
        b = token.shape[0]
        positions = torch.full((b, 1), pos, device=token.device)
        x = self._embed(token)
        for prefix, c, i in layer_plan(self.cfg):
            tail = prefix.startswith("tail")

            def at(n):
                t = cache[prefix + n]
                return t if tail else t[i]
            if c == "r":
                x, (h, conv) = self.rec_block(prefix, i, x,
                                              (at("h"), at("conv")))
                at("h").copy_(h)
                at("conv").copy_(conv)
            else:
                x, _ = self.attn_block(prefix, i, x, positions,
                                       (at("k"), at("v")), pos)
        return self.final_logits(x)
