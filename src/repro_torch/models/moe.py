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

Training drops (`train_ffn`, the reference's `_local_moe` at its
capacity-factor capacity C): the T*k (token, expert) slots, sorted
stably by expert, fill each expert's [C, d] buffer in token order, and
slots past C are dropped; the experts run batched over the [E, C, d]
buffer, and the aux load-balance loss E * sum(f * pbar) is summed over
the layers beside the logits (`MoELM.forward_logits`).

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


def topk_route(x, router, top_k: int):
    """Token-choice routing of x [T, d]: logits x.f32 @ router.f32, their
    softmax, the top_k experts by probability (ties to the lower id, as
    `lax.top_k`), the k weights renormalised by max(sum, 1e-9). Returns
    (probabilities [T, E], weights [T, k] f32, expert ids [T, k]), in
    top-k order."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    return probs, topv / topv.sum(-1, keepdim=True).clamp(min=1e-9), topi


def route(x, router, top_k: int):
    """`topk_route` for serving: (expert ids [T, k] ascending, their
    weights [T, k] in x's dtype)."""
    _, topv, topi = topk_route(x, router, top_k)
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


def capacity(T: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots an expert holds in training: max(4, int(T k cf) // E)."""
    return max(4, int(T * top_k * capacity_factor) // num_experts)


def capacity_slots(topi, num_experts: int, C: int):
    """Where the slots of topi [T, k] (each token's experts) go, as the
    reference's `_local_moe` places them: the flat [T*k] expert ids
    sorted stably (`order`), so an expert's slots come in token order; a
    slot is kept while its place among its expert's is below C. Returns
    (order, dest, keep) [T*k]: the sorted slots' flat indices, their row
    of the [E*C + 1] buffer (E*C, a row never read, for a dropped slot)
    and whether each is kept."""
    T, k = topi.shape
    eids = topi.reshape(-1)
    order = torch.argsort(eids, stable=True)
    sorted_ids = eids[order]
    counts = torch.bincount(eids, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=topi.device) - starts[sorted_ids]
    keep = pos < C
    dest = torch.where(keep, sorted_ids * C + pos,
                       torch.full_like(pos, num_experts * C))
    return order, dest, keep


def train_ffn(cfg: ModelConfig, x, router, we1, we2, we3):
    """The training FFN of x [T, d] (the reference's `_local_moe` on one
    device, capacity from `cfg.moe.capacity_factor`). Routing is
    `topk_route`; the aux loss is E * sum(f * pbar), f each expert's
    share of the T*k slots (no gradient) and pbar its mean probability.
    The kept slots (`capacity_slots`) fill the [E, C, d] buffer, the
    experts' FFNs (SwiGLU, squared-ReLU or GELU) run as batched products
    over it, and each token's output adds its kept slots' outputs times
    their weights in ascending expert id, each add in x's dtype (the
    reference's scatter-add order): the same bits on every run. Returns
    (y [T, d], aux f32)."""
    m = cfg.moe
    T, d = x.shape
    E, k = m.num_experts, m.top_k
    probs, topv, topi = topk_route(x, router, k)
    f = torch.bincount(topi.reshape(-1), minlength=E).float() / (T * k)
    aux = E * torch.sum(f * probs.mean(0))
    C = capacity(T, k, E, m.capacity_factor)
    order, dest, keep = capacity_slots(topi, E, C)
    buf = x.new_zeros((E * C + 1, d)).index_put((dest,), x[order // k])
    h = buf[:E * C].reshape(E, C, d)
    a = torch.matmul(h, we1)
    if cfg.act == "swiglu":
        a = F.silu(a) * torch.matmul(h, we3)
    elif cfg.act == "sq_relu":
        a = torch.square(F.relu(a))
    else:
        a = F.gelu(a, approximate="tanh")
    out = torch.matmul(a, we2).reshape(E * C, d)
    out = torch.cat([out, out.new_zeros((1, d))])
    w = topv.reshape(-1)[order].to(x.dtype)
    vals = torch.where(keep[:, None], out[dest] * w[:, None],
                       torch.zeros((), dtype=x.dtype, device=x.device))
    # back to (token, top-k rank) order, then each token's k adds in
    # ascending expert id
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=x.device)
    vals = vals[inv].reshape(T, k, d)
    by_id = torch.argsort(topi, dim=1)
    tok = torch.arange(T, device=x.device)
    y = torch.zeros_like(x)
    for j in range(k):
        y = y + vals[tok, by_id[:, j]]
    return y, aux


class MoELM(DenseLM):
    """MoE decoder over the dense model's attention and paged KV pool;
    only the FFN differs: drop-free in serving (`_mlp_residual`), with
    the capacity drops and the aux loss in training (`_train_layer`).
    Raises ValueError for a sliding window or `kv_quant`, which the
    reference's MoE wave path does not define."""

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
        out = moe_ffn(self._experts_in(i, x), self.router[i], self.we1[i],
                      self.we2[i], self.we3[i], self.cfg.moe.top_k)
        return x + self._dense_beside(i, x, out)

    def _experts_in(self, i: int, x):
        """The experts' input: x normed by "moe_norm" beside a dense FFN,
        else by "mlp_norm"."""
        cfg = self.cfg
        norm = self.moe_norm if cfg.moe.dense_residual else self.mlp_norm
        return L.rmsnorm(x, norm[i], cfg.norm_eps)

    def _dense_beside(self, i: int, x, out):
        """out + the dense FFN of x normed by "mlp_norm" with
        `dense_residual`, else out."""
        cfg = self.cfg
        if not cfg.moe.dense_residual:
            return out
        yd = L.rmsnorm(x, self.mlp_norm[i], cfg.norm_eps)
        w3 = self.w3[i] if cfg.act == "swiglu" else None
        return out + L.mlp(yd, self.w1[i], self.w2[i], w3, cfg.act)

    def _train_layer(self, i: int, x, positions):
        """Layer i of the training forward: attention by `L.attention`,
        then the experts with capacity drops (`train_ffn`) (+ the dense
        FFN with `dense_residual`). Returns (its output, its aux loss)."""
        x = self._attn_residual(i, x, positions, L.attention)
        y = self._experts_in(i, x)
        out, aux = train_ffn(self.cfg, y.reshape(-1, y.shape[-1]),
                             self.router[i], self.we1[i], self.we2[i],
                             self.we3[i])
        return x + self._dense_beside(i, x, out.reshape(y.shape)), aux

    def forward_logits(self, tokens, patches=None):
        """The training entry: (logits [B, S, V], the aux loss summed over
        the layers), as the reference's `moe.forward_logits`."""
        x, aux = self.train_hidden(tokens, patches)
        return self.logits_from_hidden(x), aux

    def forward(self, batch):
        return self.forward_logits(batch["tokens"], batch.get("patches"))
