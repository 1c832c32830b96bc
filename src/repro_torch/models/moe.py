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

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.dist import collectives as C
from repro_torch.dist.sharding import (get_mesh, local_index, local_slice,
                                       logical_to_spec, mesh_shape,
                                       spec_axes)
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


def counts(ids, n: int):
    """How often each value of [0, n) occurs in ids (all of them below
    n): `torch.bincount(ids, minlength=n)` with its size known before
    the values, so the card needs no host sync to size it and a dry-run
    trace sees a static shape."""
    return torch.zeros(n, dtype=torch.long, device=ids.device).scatter_add_(
        0, ids.long(), torch.ones_like(ids, dtype=torch.long))


def capacity_slots(topi, num_experts: int, C: int, e_offset: int = 0,
                   n_local: Optional[int] = None):
    """Where the slots of topi [T, k] (each token's experts) go, as the
    reference's `_local_moe` places them, for the n_local experts from
    e_offset held here (all of them by default): the flat [T*k] local
    expert ids (n_local for another rank's expert) sorted stably
    (`order`), so an expert's slots come in token order; a slot is kept
    while it is local and its place among its expert's is below C.
    Returns (order, dest, keep) [T*k]: the sorted slots' flat indices,
    their row of the [El*C + 1] buffer (El*C, a row never read, for a
    dropped slot) and whether each is kept."""
    T, k = topi.shape
    El = num_experts if n_local is None else n_local
    eids = topi.reshape(-1)
    local = (eids >= e_offset) & (eids < e_offset + El)
    leids = torch.where(local, eids - e_offset, torch.full_like(eids, El))
    order = torch.argsort(leids, stable=True)
    sorted_ids = leids[order]
    n = counts(leids, El + 1)
    starts = torch.cumsum(n, 0) - n
    pos = torch.arange(T * k, device=topi.device) - starts[sorted_ids]
    keep = (sorted_ids < El) & (pos < C)
    dest = torch.where(keep, sorted_ids * C + pos,
                       torch.full_like(pos, El * C))
    return order, dest, keep


def train_ffn(cfg: ModelConfig, x, router, we1, we2, we3,
              e_offset: int = 0):
    """The training FFN of x [T, d] (the reference's `_local_moe`,
    capacity from `cfg.moe.capacity_factor`) over the experts we1, we2,
    we3 hold: all of them on one device, or El of them from `e_offset`
    (expert parallelism, `ep_ffn`; the output then sums only their
    slots). Routing is
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
    f = counts(topi.reshape(-1), E).float() / (T * k)
    aux = E * torch.sum(f * probs.mean(0))
    El = we1.shape[0]
    C = capacity(T, k, E, m.capacity_factor)
    order, dest, keep = capacity_slots(topi, E, C, e_offset, El)
    buf = x.new_zeros((El * C + 1, d)).index_put((dest,), x[order // k])
    h = buf[:El * C].reshape(El, C, d)
    a = torch.matmul(h, we1)
    if cfg.act == "swiglu":
        a = F.silu(a) * torch.matmul(h, we3)
    elif cfg.act == "sq_relu":
        a = torch.square(F.relu(a))
    else:
        a = F.gelu(a, approximate="tanh")
    out = torch.matmul(a, we2).reshape(El * C, d)
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


# ------------------------------------------------- expert parallelism


class Q8AllGather(torch.autograd.Function):
    """ZeRO++-style int8 weight all-gather (the reference's
    `q8_all_gather`): quantise the local shard with per-row scales along
    `quant_axis` (max|w| / 127, at least 1e-20), all-gather the int8
    values and the f32 scales along `gather_axis` over the mesh `axes`,
    dequantise in bf16. Backward: the reduce-scatter of the f32 gradient
    that the plain gather's would be (straight through), in w's dtype."""

    @staticmethod
    def forward(ctx, w, mesh, axes, gather_axis, quant_axis):
        ctx.mesh, ctx.axes, ctx.gather_axis = mesh, axes, gather_axis
        ctx.dtype = w.dtype
        wf = w.float()
        s = (wf.abs().amax(quant_axis, keepdim=True) / 127.0).clamp(
            min=1e-20)
        q = torch.round(wf / s).to(torch.int8)
        qf = C.all_gather(q, mesh, axes, gather_axis)
        sf = C.all_gather(s, mesh, axes, gather_axis)
        return qf.to(torch.bfloat16) * sf.to(torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        gw = C.reduce_scatter(g.float(), ctx.mesh, ctx.axes, ctx.gather_axis)
        return gw.to(ctx.dtype), None, None, None, None


def expert_parallel(mesh) -> bool:
    """Whether the MoE layers run `ep_ffn`: a mesh with a "model" axis is
    installed (as the reference's `moe_ffn` takes its shard_map path)."""
    return mesh is not None and "model" in mesh_shape(mesh)


# the per-layer axes of the weights `ep_ffn` gathers: (logical axes,
# gather dimension, quantisation dimension)
EP_WEIGHTS = {"router": (("fsdp", None), 0, 1),
              "we1": (("expert", "fsdp", None), 1, 2),
              "we3": (("expert", "fsdp", None), 1, 2),
              "we2": (("expert", None, "fsdp"), 2, 1)}


def ep_ffn(cfg: ModelConfig, x, router, we1, we2, we3, mesh=None):
    """The training FFN of x [b, s, d] (this rank's batch rows) under
    expert parallelism on `mesh` (the ambient one by default), as the
    reference's `moe_ffn` shard_map body: the model axis's rank midx
    holds the El = E / tp experts from midx * El, and every weight's
    FSDP dimension is split over the data ranks. The layer's weights come
    as those shards, or whole (then each rank cuts its own shard). Each
    FSDP dimension is all-gathered (`Q8AllGather` with
    `cfg.moe.int8_gather`, else a plain gather, both reduce-scattering
    the gradient), every rank routes all its tokens and computes its own
    experts' slots (`train_ffn` at e_offset midx * El), and the outputs
    sum over the model axis by an all-reduce (the reference's
    `out_scatter`, a reduce-scatter over the sequence, waits for a
    sequence-split residual stream). The aux loss is the mean of the
    ranks'. Returns (y, aux).

    The inputs the ranks of the model axis share (x and the gathered
    router) sum their gradients over it (`GradAllReduce`), since each
    rank's backward reaches them through its own experts only."""
    mesh = mesh if mesh is not None else get_mesh()
    m = cfg.moe
    sizes = mesh_shape(mesh)
    tp = sizes["model"]
    if m.num_experts % tp:
        raise ValueError(f"{m.num_experts} experts over {tp} model ranks")
    El = m.num_experts // tp
    midx, _ = local_index(mesh, ("model",))
    b, s, d = x.shape
    f = m.expert_d_ff
    full = {"router": (d, m.num_experts), "we1": (m.num_experts, d, f),
            "we3": (m.num_experts, d, f), "we2": (m.num_experts, f, d)}
    gather = Q8AllGather.apply if m.int8_gather else \
        (lambda w, mh, ax, ga, qa: C.AllGather.apply(w, mh, ax, ga))

    def gathered(name, w):
        if w is None:
            return None
        axes, ga, qa = EP_WEIGHTS[name]
        spec = logical_to_spec(mesh, axes, full[name])
        if tuple(w.shape) == full[name]:
            w = local_slice(w, mesh, spec)
        return gather(w, mesh, spec_axes(spec[ga]), ga, qa)

    router_f = C.GradAllReduce.apply(gathered("router", router), mesh,
                                     ("model",))
    we1_f, we2_f = gathered("we1", we1), gathered("we2", we2)
    we3_f = gathered("we3", we3) if cfg.act == "swiglu" else None
    xt = C.GradAllReduce.apply(x, mesh, ("model",)).reshape(-1, d)
    y, aux = train_ffn(cfg, xt, router_f, we1_f, we2_f, we3_f, midx * El)
    y = C.AllReduce.apply(y.reshape(b, s, d), mesh, ("model",))
    return y, C.AllReduce.apply(aux, mesh, ("model",)) / tp


class MoELM(DenseLM):
    """MoE decoder over the dense model's attention and paged KV pool;
    only the FFN differs: drop-free in serving (`_mlp_residual`), with
    the capacity drops and the aux loss in training (`_train_layer`).
    Raises ValueError for a sliding window or `kv_quant`, which the
    reference's MoE wave path does not define."""

    FAMILY = "moe"
    # the MoE attention and the serving experts under "model" are not
    # ported: a MoE model serves whole
    TENSOR_PARALLEL = False
    shapes = staticmethod(param_shapes)

    def __init__(self, cfg: ModelConfig, **kw):
        if cfg.sliding_window is not None or cfg.kv_quant:
            raise ValueError(f"{cfg.name}: the MoE family runs neither a "
                             "sliding window nor an int8 KV cache")
        super().__init__(cfg, **kw)

    def local_weights(self, mesh) -> Dict[str, int]:
        """Under expert parallelism (`expert_parallel`), the router and
        the experts' weights: `ep_ffn` gathers their FSDP shards itself
        (`EP_WEIGHTS`)."""
        if not expert_parallel(mesh):
            return {}
        return {n: ga + 1 for n, (_, ga, _) in EP_WEIGHTS.items()
                if hasattr(self, n)}

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
        mesh = get_mesh()
        if expert_parallel(mesh):
            out, aux = ep_ffn(self.cfg, y, self.router[i], self.we1[i],
                              self.we2[i], self.we3[i], mesh)
        else:
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
