"""Dense decoder LM over a block-table paged KV cache (the port of the
paged serving path of `repro.models.dense` for causal RoPE SwiGLU
configs without sliding window or int8 KV, tensor-parallel degree 1).

`DenseLM` keeps the reference's parameter layout: per-layer weights are
stacked on a leading layer axis ([L, d, out]) and applied as `x @ w`.
Decode runs one `decode_attention_paged` kernel per layer directly on
that layer's page pool (the reference gathers pages with jnp and calls
`layers.decode_attention`, the same function); chunked prefill gathers
the slot's logical buffer and runs `layers.attention` with the chunk's
query offset and kv length. The page pool is updated in place.
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

    # ------------------------------------------------------------ paged

    @torch.no_grad()
    def decode_step_paged(self, cache, token, pos, active, table, *,
                          page_size: int):
        """One decode step for every slot. token [B, 1] int; pos [B] int
        (each slot's write position == its kv length); active [B] bool
        (only active slots write K/V); table [B, W] int32 page ids (tail
        entries past kv_len are masked). Returns logits [B, V]; `cache`
        is updated in place."""
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
        up to offset + C. Returns chunk logits [1, C, V]; `cache` is
        updated in place."""
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
            ctx = L.attention(q, kslot.to(k.dtype), vslot.to(v.dtype),
                              q_offset=offset, kv_len=offset + c)
            x = x + ctx.reshape(1, c, -1) @ self.wo[i]
            x = self._mlp_residual(i, x)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return self.logits_from_hidden(x)
