"""MoE decoder (the port of `repro.models.moe` for serving; the
granite-moe-1b-a400m family): `MoELM` is a `DenseLM` whose FFN is a
token-choice top-k mixture of SwiGLU experts, optionally beside a dense
FFN (`dense_residual`). Attention, the wave caches, the page pool and
both paged steps are `DenseLM`'s, as the reference's `moe` module reuses
`dense.paged_attn_decode` and `paged_attn_chunk`.

Serving never drops a token: the reference's expert capacity at
inference is T, the call's token count, so every token reaches its k
experts and its output depends on its own row only. The port computes
that capacity-T buffer with every slot filled (each expert's [T, d] x
[d, f] products over all T tokens, plain matmuls as in the reference,
which leaves them outside any Pallas kernel) and combines each token's k
picks: no shape depends on the routing, so nothing waits on the host.

As in the reference's wave path, the MoE family has no sliding window and
no int8 KV (`models.model.supports_paged` excludes both combinations):
`MoELM` raises ValueError for such a config.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.dense import DenseLM, param_shapes as dense_shapes


def param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> (shape, init), the reference's `moe.defs` flattened: the
    attention and embedding weights of `dense.param_shapes`, the router
    [L, d, E] and the experts' we1, we3 [L, E, d, f] and we2 [L, E, f, d];
    the FFN's norm is "moe_norm" beside a dense FFN ("mlp_norm", w1, w2,
    w3) when `dense_residual`, else "mlp_norm" alone."""
    Ln, d, m = cfg.num_layers, cfg.d_model, cfg.moe
    E, f = m.num_experts, m.expert_d_ff
    defs = dense_shapes(cfg)
    if m.dense_residual:
        defs["moe_norm"] = ((Ln, d), "zeros")
    else:
        for k in ("w1", "w2", "w3"):
            del defs[k]
    defs["router"] = ((Ln, d, E), "normal")
    defs["we1"] = ((Ln, E, d, f), "normal")
    defs["we2"] = ((Ln, E, f, d), "normal")
    defs["we3"] = ((Ln, E, d, f), "normal")
    return defs


def route(x, router, top_k: int):
    """Token-choice routing of x [T, d]: logits x.f32 @ router.f32, their
    softmax, the top_k experts by probability (ties to the lower id, as
    `lax.top_k`), the k weights renormalised by max(sum, 1e-9). Returns
    (expert ids [T, k] ascending, their weights [T, k] in x's dtype)."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
    eid, order = torch.sort(topi, dim=-1)
    return eid, torch.gather(topv, 1, order).to(x.dtype)


def moe_ffn(x, router, we1, we2, we3, top_k: int):
    """The drop-free expert FFN of x [..., d] (`_local_moe` at capacity
    T): every expert's SwiGLU over all T tokens, then each token's output
    is the sum of its k experts' outputs times their weights, added in
    ascending expert id, each add rounded to x's dtype (the reference's
    scatter-add order). A fixed order, no atomics: the same bits on
    every run."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    eid, w = route(xt, router, top_k)
    h = F.silu(torch.matmul(xt, we1)) * torch.matmul(xt, we3)   # [E, T, f]
    out = torch.matmul(h, we2)                                  # [E, T, d]
    tok = torch.arange(xt.shape[0], device=x.device)
    y = torch.zeros_like(xt)
    for j in range(top_k):
        y = y + out[eid[:, j], tok] * w[:, j, None]
    return y.reshape(shape)


class MoELM(DenseLM):
    """MoE decoder over the dense model's attention and paged KV pool;
    only `_mlp_residual` (the FFN) differs. Raises ValueError for a
    sliding window or `kv_quant`, which the reference's MoE wave path
    does not define."""

    FAMILY = "moe"
    shapes = staticmethod(param_shapes)

    def __init__(self, cfg: ModelConfig, **kw):
        if cfg.sliding_window is not None or cfg.kv_quant:
            raise ValueError(f"{cfg.name}: the MoE family runs neither a "
                             "sliding window nor an int8 KV cache")
        super().__init__(cfg, **kw)

    def _mlp_residual(self, i: int, x):
        """x + the experts' FFN of the normed x (+ the dense FFN of its
        own norm with `dense_residual`)."""
        cfg = self.cfg
        norm = self.moe_norm if cfg.moe.dense_residual else self.mlp_norm
        y = L.rmsnorm(x, norm[i], cfg.norm_eps)
        out = moe_ffn(y, self.router[i], self.we1[i], self.we2[i],
                      self.we3[i], cfg.moe.top_k)
        if cfg.moe.dense_residual:
            yd = L.rmsnorm(x, self.mlp_norm[i], cfg.norm_eps)
            w3 = self.w3[i] if cfg.act == "swiglu" else None
            out = out + L.mlp(yd, self.w1[i], self.w2[i], w3, cfg.act)
        return x + out
