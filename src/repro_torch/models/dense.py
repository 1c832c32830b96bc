"""Dense LM (the port of `repro.models.dense` for RoPE configs with a
SwiGLU or GELU FFN, optionally with a sliding window and an int8 KV
cache; tensor-parallel degree 1), and the bidirectional encoder of
gte-small (`encode`: mean-pooled, unit-norm sentence embeddings).

`DenseLM` keeps the reference's parameter layout: per-layer weights are
stacked on a leading layer axis ([L, d, out]) and applied as `x @ w`.
Two serving paths, each attention on a kernel:

- the wave path: `prefill` runs the full prompt through `flash_prefill`
  and returns a contiguous cache [L, B, Sc, G, dh]; `decode_step` writes
  one position into it and runs `decode_attention`. A sliding-window
  cache is a ring of Sc = window slots: position p lives in slot p % Sc.
- the paged path: `decode_step_paged` runs one `decode_attention_paged`
  kernel per layer directly on that layer's page pool (the reference
  gathers pages with jnp and calls `layers.decode_attention`, the same
  function); `prefill_chunk_paged` gathers the slot's history in
  position order, appends the chunk and runs `flash_prefill` with the
  chunk's query offset and kv length. A sliding-window slot is a ring
  of `ring_len` positions over its pages: position p at ring cursor
  p % ring_len (a slot without a window is a ring that never wraps).

With `kv_quant` the caches and pools hold int8 values and f32 scales per
position and kv head ({"k", "k_s", "v", "v_s"}): prefill and chunks
attend `dequantize_kv(quantize_kv(k))`, the values decode reads back, and
decode runs the int8 kernels `decode_attention_q8` and
`decode_attention_paged_q8` on the int8 bytes and the scales.

`MoELM` (models/moe.py) shares all of this and replaces the FFN.
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
        "tok_embed": ((cfg.vocab_padded, d), "normal"),
        "final_norm": ((d,), "zeros"),
    }
    if cfg.act == "swiglu":
        defs["w3"] = ((Ln, d, cfg.d_ff), "normal")
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


def _kv_planes(cfg: ModelConfig, shape, device) -> Dict[str, torch.Tensor]:
    """Zeroed K/V planes of `shape` [..., G, dh]: in the model's dtype,
    or with `kv_quant` int8 values plus f32 scales [..., G] ("k_s",
    "v_s")."""
    dev = resolve_device(device)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_s": torch.zeros(shape[:-1], device=dev),
                "v_s": torch.zeros(shape[:-1], device=dev)}
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)}


def init_cache(cfg: ModelConfig, b: int, seq_len: int, device="cuda"
               ) -> Dict[str, torch.Tensor]:
    """Contiguous wave KV cache: {"k", "v"} of [L, b, cache_len(cfg,
    seq_len), G, dh] (+ "k_s", "v_s" [L, b, Sc, G] with `kv_quant`)."""
    return _kv_planes(cfg, (cfg.num_layers, b, cache_len(cfg, seq_len),
                            cfg.num_kv_heads, cfg.resolved_head_dim), device)


def init_page_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """Block-table KV pool: {"k", "v"} of [L, num_pages, page_size, G, dh]
    (+ "k_s", "v_s" [L, num_pages, page_size, G] with `kv_quant`)."""
    return _kv_planes(cfg, (cfg.num_layers, num_pages, page_size,
                            cfg.num_kv_heads, cfg.resolved_head_dim), device)


def chunk_rows(row, offset: int, c: int, limit: int, page_size: int,
               ring_len: int = 0):
    """Where a [C]-token prompt chunk at positions [offset, offset + C)
    reads and writes the slot whose page-table row is `row` ([W] int32).
    Position p lives at cursor p % ring_len of a sliding-window ring, at
    cursor p without one (a ring of W * page_size that never wraps).
    Returns (lo, gather, (page, offset)): the history is positions
    [lo, offset), their flat pool rows `gather` (page * page_size +
    offset) in position order; the chunk's real tokens (p < limit, and
    p < W * page_size without a ring) are written at (page, offset).
    lo is max(0, offset - ring) rounded down to flash_prefill's key tile
    (`ops.FLASH_KEY_TILE`): the history holds every query's window (the
    positions the rounding adds lie outside it, masked), attention
    depends on positions only through their differences, and the keys
    fall into the tiles they fill at absolute positions, as in the wave
    path's full prefill. The chunk attends [lo, offset + C) at query
    offset offset - lo."""
    ps = page_size
    ring = ring_len or row.shape[0] * ps
    end = limit if ring_len else min(limit, ring)
    dev = row.device
    rowl = row.long()
    lo = max(0, offset - ring) // ops.FLASH_KEY_TILE * ops.FLASH_KEY_TILE
    hist = torch.arange(lo, offset, device=dev) % ring
    lw = torch.arange(offset, max(offset, min(offset + c, end)),
                      device=dev) % ring
    return lo, rowl[hist // ps] * ps + hist % ps, (rowl[lw // ps], lw % ps)


def _fake_quant(t):
    """The values an int8 cache hands back for t."""
    return L.dequantize_kv(*L.quantize_kv(t), t.dtype)


class DenseLM(nn.Module):
    """Dense decoder over a paged KV pool. `params` (name -> tensor, the
    `param_shapes` layout) loads given weights; without it the weights
    are random from `seed`, drawn on the device."""

    FAMILY = "dense"
    shapes = staticmethod(param_shapes)

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        if cfg.family != self.FAMILY:
            raise ValueError(f"{cfg.name}: family {cfg.family!r}, not "
                             f"{self.FAMILY!r} (models.model.build_model)")
        self.cfg = cfg
        dev = resolve_device(device)
        dtype = cfg.torch_dtype
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, (shape, init) in self.shapes(cfg).items():
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
        """x + the layer's FFN (SwiGLU, or GELU without w3) of
        rmsnorm(x)."""
        cfg = self.cfg
        y = L.rmsnorm(x, self.mlp_norm[i], cfg.norm_eps)
        w3 = self.w3[i] if cfg.act == "swiglu" else None
        return x + L.mlp(y, self.w1[i], self.w2[i], w3, cfg.act)

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
        S % Sc so that position p lives in ring slot p % Sc. With
        `kv_quant` attention reads the fake-quantized k/v and the cache
        holds their int8 values and scales."""
        cfg = self.cfg
        b, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(b, S)
        cache = init_cache(cfg, b, S, device=tokens.device)
        sc = cache["k"].shape[2]

        def write(i, k, v):
            self._write_kv(cache, i, (), *(
                t if sc == S else torch.roll(t[:, S - sc:], S % sc, dims=1)
                for t in (k, v)))
            if cfg.kv_quant:
                return _fake_quant(k), _fake_quant(v)
            return k, v
        x = self._embed(tokens)
        for i in range(cfg.num_layers):
            x = self._full_block(i, x, positions, write)
        x = L.rmsnorm(x[:, -1:], self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x)[:, 0], cache

    def _full_block(self, i: int, x, positions, kv=None):
        """Layer i over whole sequences x [B, S, d]: attention through
        `flash_prefill` (`causal=cfg.causal`, the window), then the FFN.
        `kv(i, k, v)`, when given, sees k and v first and returns the
        pair attended (the wave prefill writes its cache there)."""
        cfg = self.cfg
        b, S, _ = x.shape
        y = L.rmsnorm(x, self.attn_norm[i], cfg.norm_eps)
        q, k, v = self._qkv(i, y, positions)
        if kv is not None:
            k, v = kv(i, k, v)
        ctx = ops.flash_prefill(q, k, v, causal=cfg.causal,
                                window=cfg.sliding_window)
        return self._mlp_residual(i, x + ctx.reshape(b, S, -1) @ self.wo[i])

    @torch.no_grad()
    def hidden_states(self, tokens):
        """Full-sequence forward without a cache, tokens [B, S] int: the
        final-normed hidden states [B, S, d] (the reference's
        `hidden_states`). Attention is `flash_prefill` with
        `causal=cfg.causal` over every position, padding included."""
        b, S = tokens.shape
        positions = torch.arange(S, device=tokens.device)[None].expand(b, S)
        x = self._embed(tokens)
        for i in range(self.cfg.num_layers):
            x = self._full_block(i, x, positions)
        return L.rmsnorm(x, self.final_norm, self.cfg.norm_eps)

    @torch.no_grad()
    def encode(self, tokens, mask=None):
        """Sentence embeddings [B, d] f32 (the reference's `encode`, the
        gte-small path): hidden states mean-pooled over `mask` ([B, S], 1
        for a real token; all ones when None) in the model's dtype, cast
        to f32 and L2-normalised with a 1e-9 floor. The mask weights only
        the pooling: padding keys are attended, as in the reference."""
        x = self.hidden_states(tokens)
        if mask is None:
            mask = torch.ones(tokens.shape, device=x.device)
        m = mask.to(x.dtype)[..., None]
        pooled = ((x * m).sum(1) / m.sum(1).clamp(min=1)).float()
        return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-9)

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        """One decode position for every row of a wave. token [B, 1] int;
        pos: the position written (shared by the rows). K/V go into slot
        pos, or pos % Sc of a sliding-window ring, of the [L, B, Sc, G,
        dh] `cache` (in place; int8 values and scales with `kv_quant`,
        attended by `decode_attention_q8`); attention covers pos + 1
        positions (min(pos + 1, Sc) on a ring). Returns logits [B, V]."""
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
            self._write_kv(cache, i, (slice(None), slot), k[:, 0], v[:, 0])
            ck, cv = cache["k"][i], cache["v"][i]
            if cfg.kv_quant:
                ctx = ops.decode_attention_q8(
                    q[:, 0], ck, cache["k_s"][i], cv, cache["v_s"][i],
                    kv_len, ring=ring)
            else:
                ctx = ops.decode_attention(q[:, 0], ck, cv, kv_len,
                                           ring=ring)
            x = x + ctx.reshape(b, 1, -1) @ self.wo[i]
            x = self._mlp_residual(i, x)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x)[:, 0]

    # ------------------------------------------------------------ paged

    @torch.no_grad()
    def decode_step_paged(self, cache, token, pos, active, table, *,
                          page_size: int, ring_len: int = 0):
        """One decode step for every slot. token [B, 1] int; pos [B] int
        (each slot's write position == its kv length); active [B] bool
        (only active slots write K/V); table [B, W] int32 page ids (tail
        entries past kv_len are masked). `ring_len` > 0 marks
        sliding-window rings: position p is written at ring cursor
        p % ring_len and a row attends min(pos + 1, ring_len) positions,
        every filled cursor (RoPE is in the stored keys, so the order in
        the ring does not matter). Returns logits [B, V]; `cache` is
        updated in place."""
        cfg = self.cfg
        ps = page_size
        b = token.shape[0]
        pos = pos.long()
        rows = torch.nonzero(active)[:, 0]
        wpos = pos[rows]
        if ring_len:
            wpos = wpos % ring_len
        pg = table[rows, wpos // ps].long()
        off = wpos % ps
        lens = (pos + 1).clamp(max=ring_len) if ring_len else pos + 1
        lens = lens.to(torch.int32)
        table = table.to(torch.int32).contiguous()
        x = self._embed(token)
        for i in range(cfg.num_layers):
            y = L.rmsnorm(x, self.attn_norm[i], cfg.norm_eps)
            q, k, v = self._qkv(i, y, pos[:, None])
            self._write_kv(cache, i, (pg, off), k[rows, 0], v[rows, 0])
            ck, cv = cache["k"][i], cache["v"][i]
            qd = q[:, 0].contiguous()
            if cfg.kv_quant:
                ctx = ops.decode_attention_paged_q8(
                    qd, ck, cache["k_s"][i], cv, cache["v_s"][i], lens, table)
            else:
                ctx = ops.decode_attention_paged(qd, ck, cv, lens, table)
            x = x + ctx.to(x.dtype).reshape(b, 1, -1) @ self.wo[i]
            x = self._mlp_residual(i, x)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x)[:, 0]

    def _gather_slot(self, cache, i: int, gather, dtype):
        """Layer i's K and V at the pool rows `gather` ([n] flat page *
        ps + offset), in `dtype` (dequantized from an int8 pool)."""
        out = []
        for name in ("k", "v"):
            c = cache[name][i]
            flat = c.reshape((-1,) + c.shape[2:])[gather]
            if self.cfg.kv_quant:
                s = cache[name + "_s"][i]
                flat = L.dequantize_kv(flat, s.reshape((-1,) + s.shape[2:])[
                    gather], dtype)
            out.append(flat.to(dtype))
        return out

    def _write_kv(self, cache, i: int, idx, k, v) -> None:
        """Write k, v [..., G, dh] into layer i of a cache or pool at index
        `idx` (a tuple over its leading axes; () for all of it): their
        int8 values and scales with `kv_quant`."""
        for name, t in (("k", k), ("v", v)):
            c = cache[name][i]
            if self.cfg.kv_quant:
                c[idx], cache[name + "_s"][i][idx] = L.quantize_kv(t)
            else:
                c[idx] = t.to(c.dtype)

    @torch.no_grad()
    def prefill_chunk_paged(self, cache, tokens, row, offset: int,
                            limit: Optional[int] = None, *, page_size: int,
                            ring_len: int = 0):
        """One [1, C] prompt chunk at logical positions [offset, offset+C)
        of the slot whose page-table row is `row` ([W] int32); `limit`:
        offset + the chunk's real token count (offset + C when None).
        The slot's history (`chunk_rows`), read before this chunk's
        writes, with the chunk appended, goes to `flash_prefill` with the
        window; its queries attend causally up to offset + C. Only the
        real tokens (p < limit) are written, at ring cursors
        p % ring_len, so a ragged last chunk's padding evicts nothing
        another query's window still needs. With `kv_quant` the history
        is dequantized and the chunk's own K/V fake-quantized. Returns
        chunk logits [1, C, V]; `cache` is updated in place."""
        cfg = self.cfg
        c = tokens.shape[1]
        limit = offset + c if limit is None else limit
        lo, gather, dst = chunk_rows(row, offset, c, limit, page_size,
                                     ring_len)
        n_keep = dst[0].numel()
        positions = offset + torch.arange(c, device=tokens.device)[None, :]
        x = self._embed(tokens)
        for i in range(cfg.num_layers):
            y = L.rmsnorm(x, self.attn_norm[i], cfg.norm_eps)
            q, k, v = self._qkv(i, y, positions)
            kh, vh = self._gather_slot(cache, i, gather, k.dtype)
            kc, vc = ((_fake_quant(k[0]), _fake_quant(v[0])) if cfg.kv_quant
                      else (k[0], v[0]))
            self._write_kv(cache, i, dst, k[0, :n_keep], v[0, :n_keep])
            ctx = ops.flash_prefill(
                q, torch.cat([kh, kc])[None], torch.cat([vh, vc])[None],
                causal=True, window=cfg.sliding_window, q_offset=offset - lo,
                kv_len=offset + c - lo)
            x = x + ctx.reshape(1, c, -1) @ self.wo[i]
            x = self._mlp_residual(i, x)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x)
