"""Dense decoder LM (the port of `repro.models.dense` for causal RoPE
SwiGLU configs, optionally with a sliding window; no int8 KV,
tensor-parallel degree 1).

`DenseLM` keeps the reference's parameter layout: per-layer weights are
stacked on a leading layer axis ([L, d, out]) and applied as `x @ w`.
Two serving paths, each attention on a kernel:

- the wave path: `prefill` runs the full prompt through `flash_prefill`
  and returns a contiguous cache [L, B, Sc, G, dh]; `decode_step` writes
  one position into it and runs `decode_attention`. A sliding-window
  cache is a ring of Sc = window slots: position p lives in slot p % Sc.
- the paged path (no sliding window yet): `decode_step_paged` runs one
  `decode_attention_paged` kernel per layer directly on that layer's page
  pool (the reference gathers pages with jnp and calls
  `layers.decode_attention`, the same function); `prefill_chunk_paged`
  gathers the slot's logical buffer and runs `flash_prefill` with the
  chunk's query offset and kv length.

Caches and page pools are updated in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> (shape, init) with init "normal" (N(0, 0.02)) or "zeros",
    the reference's `dense.defs` flattened (layer weights stacked)."""
    Ln, d, hd = cfg.num_layers, cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    defs = {
        "attn_norm": ((Ln, d), "zeros"),
        "wq": ((Ln, d, h * hd), "normal"),
        "wk": ((Ln, d, kv * hd), "normal"),
        "wv": ((Ln, d, kv * hd), "normal"),
        "wo": ((Ln, h * hd, d), "normal"),
        "mlp_norm": ((Ln, d), "zeros"),
        "w1": ((Ln, d, cfg.d_ff), "normal"),
        "w2": ((Ln, cfg.d_ff, d), "normal"),
        "w3": ((Ln, d, cfg.d_ff), "normal"),
        "tok_embed": ((cfg.vocab_padded, d), "normal"),
        "final_norm": ((d,), "zeros"),
    }
    if cfg.qkv_bias:
        defs["bq"] = ((Ln, h * hd), "zeros")
        defs["bk"] = ((Ln, kv * hd), "zeros")
        defs["bv"] = ((Ln, kv * hd), "zeros")
    if not cfg.tie_embeddings:
        defs["lm_head"] = ((d, cfg.vocab_padded), "normal")
    return defs


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Slots of a wave cache for `seq_len` positions: capped at the
    sliding window, whose cache is a ring."""
    if cfg.sliding_window:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ModelConfig, b: int, seq_len: int, device="cuda"
               ) -> Dict[str, torch.Tensor]:
    """Contiguous wave KV cache in the model's dtype: {"k", "v"} of
    [L, b, cache_len(cfg, seq_len), G, dh]."""
    shape = (cfg.num_layers, b, cache_len(cfg, seq_len), cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}


def init_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Block-table KV pool in the model's dtype: {"k", "v"} of
    [L, num_pages, page_size, G, dh]."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}


class DenseLM(nn.Module):
    """Dense decoder over a paged KV pool. `params` (name -> tensor, the
    `param_shapes` layout) loads given weights; without it the weights
    are random from `seed`, drawn on the device."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = cfg.torch_dtype
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, (shape, init) in param_shapes(cfg).items():
            if params is not None:
                t = params[name]
                if tuple(t.shape) != shape:
                    raise ValueError(f"{name}: {tuple(t.shape)} != {shape}")
                t = t.to(device=dev, dtype=dtype).clone()
            elif init == "zeros":
                t = torch.zeros(shape, dtype=dtype, device=dev)
            else:
                t = (torch.randn(shape, generator=gen, device=dev) * 0.02
                     ).to(dtype)
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.tok_embed.device

    # ------------------------------------------------------------ blocks

    def _embed(self, tokens):
        scale = self.cfg.d_model ** 0.5 if self.cfg.tie_embeddings else 1.0
        return (self.tok_embed[tokens] * scale).to(self.cfg.torch_dtype)

    def _qkv(self, i: int, x, positions):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        b, s, _ = x.shape
        q, k, v = x @ self.wq[i], x @ self.wk[i], x @ self.wv[i]
        if cfg.qkv_bias:
            q, k, v = q + self.bq[i], k + self.bk[i], v + self.bv[i]
        q = L.apply_rope(q.reshape(b, s, cfg.num_heads, hd), positions,
                         cfg.rope_theta)
        k = L.apply_rope(k.reshape(b, s, cfg.num_kv_heads, hd), positions,
                         cfg.rope_theta)
        return q, k, v.reshape(b, s, cfg.num_kv_heads, hd)

    def _mlp_residual(self, i: int, x):
        y = L.rmsnorm(x, self.mlp_norm[i], self.cfg.norm_eps)
        return x + L.mlp(y, self.w1[i], self.w2[i], self.w3[i])

    def logits_from_hidden(self, x):
        head = self.tok_embed.T if self.cfg.tie_embeddings else self.lm_head
        return x @ head.to(x.dtype)

    # ------------------------------------------------------------- wave

    @torch.no_grad()
    def prefill(self, tokens):
        """Full-sequence forward of equal-length prompts, tokens [B, S]
        int. Returns (last-position logits [B, V], the K/V cache
        `init_cache(cfg, B, S)` filled): position p in slot p, or, when
        S exceeds the sliding window, the last Sc positions rolled by
        S % Sc so that position p lives in ring slot p % Sc."""
        cfg = self.cfg
        b, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(b, S)
        cache = init_cache(cfg, b, S, device=tokens.device)
        sc = cache["k"].shape[2]
        x = self._embed(tokens)
        for i in range(cfg.num_layers):
            y = L.rmsnorm(x, self.attn_norm[i], cfg.norm_eps)
            q, k, v = self._qkv(i, y, positions)
            for name, t in (("k", k), ("v", v)):
                cache[name][i] = (t if sc == S else
                                  torch.roll(t[:, S - sc:], S % sc, dims=1))
            ctx = ops.flash_prefill(q, k, v, causal=True,
                                    window=cfg.sliding_window)
            x = x + ctx.reshape(b, S, -1) @ self.wo[i]
            x = self._mlp_residual(i, x)
        x = L.rmsnorm(x[:, -1:], self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        """One decode position for every row of a wave. token [B, 1] int;
        pos: the position written (shared by the rows). K/V go into slot
        pos, or pos % Sc of a sliding-window ring, of the [L, B, Sc, G,
        dh] `cache` (in place); attention covers pos + 1 positions
        (min(pos + 1, Sc) on a ring). Returns logits [B, V]."""
        cfg = self.cfg
        b = token.shape[0]
        ring = cfg.sliding_window is not None
        slot = pos % cache["k"].shape[2] if ring else pos
        positions = torch.full((b, 1), pos, device=token.device)
        kv_len = torch.full((b,), pos + 1, dtype=torch.int32,
                            device=token.device)
        x = self._embed(token)
        for i in range(cfg.num_layers):
            y = L.rmsnorm(x, self.attn_norm[i], cfg.norm_eps)
            q, k, v = self._qkv(i, y, positions)
            ck, cv = cache["k"][i], cache["v"][i]
            ck[:, slot] = k[:, 0]
            cv[:, slot] = v[:, 0]
            ctx = ops.decode_attention(q[:, 0], ck, cv, kv_len, ring=ring)
            x = x + ctx.reshape(b, 1, -1) @ self.wo[i]
            x = self._mlp_residual(i, x)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x)[:, 0]

    # ------------------------------------------------------------ paged

    def _check_paged(self) -> None:
        if self.cfg.sliding_window:
            raise NotImplementedError(
                "the paged path of a sliding-window config (ring pages) is "
                "not ported (ROADMAP.md Queue A 2); use the wave Engine "
                "with continuous=False")

    @torch.no_grad()
    def decode_step_paged(self, cache, token, pos, active, table, *,
                          page_size: int):
        """One decode step for every slot. token [B, 1] int; pos [B] int
        (each slot's write position == its kv length); active [B] bool
        (only active slots write K/V); table [B, W] int32 page ids (tail
        entries past kv_len are masked). Returns logits [B, V]; `cache`
        is updated in place."""
        self._check_paged()
        cfg = self.cfg
        ps = page_size
        b = token.shape[0]
        pos = pos.long()
        rows = torch.nonzero(active)[:, 0]
        wpos = pos[rows]
        pg = table[rows, wpos // ps].long()
        off = wpos % ps
        lens = (pos + 1).to(torch.int32)
        table = table.to(torch.int32).contiguous()
        x = self._embed(token)
        for i in range(cfg.num_layers):
            y = L.rmsnorm(x, self.attn_norm[i], cfg.norm_eps)
            q, k, v = self._qkv(i, y, pos[:, None])
            ck, cv = cache["k"][i], cache["v"][i]
            ck[pg, off] = k[rows, 0].to(ck.dtype)
            cv[pg, off] = v[rows, 0].to(cv.dtype)
            ctx = ops.decode_attention_paged(q[:, 0].contiguous(), ck, cv,
                                             lens, table)
            x = x + ctx.to(x.dtype).reshape(b, 1, -1) @ self.wo[i]
            x = self._mlp_residual(i, x)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x)[:, 0]

    @torch.no_grad()
    def prefill_chunk_paged(self, cache, tokens, row, offset: int, *,
                            page_size: int):
        """One [1, C] prompt chunk at logical positions [offset, offset+C)
        of the slot whose page-table row is `row` ([W] int32). Its K/V
        scatter through the row (positions past the mapped width are
        dropped); its queries attend the gathered logical buffer causally
        up to offset + C through `flash_prefill`. Returns chunk logits
        [1, C, V]; `cache` is updated in place."""
        self._check_paged()
        cfg = self.cfg
        ps = page_size
        c = tokens.shape[1]
        dev = tokens.device
        W = row.shape[0]
        positions = offset + torch.arange(c, device=dev)[None, :]
        n_keep = max(0, min(c, W * ps - offset))
        p_keep = offset + torch.arange(n_keep, device=dev)
        dst_pg = row[p_keep // ps].long()
        dst_off = p_keep % ps
        j = torch.arange(W * ps, device=dev)
        gather = row.long()[j // ps] * ps + (j % ps)           # [W*ps]
        x = self._embed(tokens)
        for i in range(cfg.num_layers):
            y = L.rmsnorm(x, self.attn_norm[i], cfg.norm_eps)
            q, k, v = self._qkv(i, y, positions)
            ck, cv = cache["k"][i], cache["v"][i]
            ck[dst_pg, dst_off] = k[0, :n_keep].to(ck.dtype)
            cv[dst_pg, dst_off] = v[0, :n_keep].to(cv.dtype)
            P = ck.shape[0]
            kslot = ck.reshape((P * ps,) + ck.shape[2:])[gather][None]
            vslot = cv.reshape((P * ps,) + cv.shape[2:])[gather][None]
            ctx = ops.flash_prefill(q, kslot, vslot, causal=True,
                                    q_offset=offset, kv_len=offset + c)
            x = x + ctx.reshape(1, c, -1) @ self.wo[i]
            x = self._mlp_residual(i, x)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x)
