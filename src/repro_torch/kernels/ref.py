"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each function computes what its CUDA kernel computes, with the same
sentinels and tie-breaks as the Pallas kernel it replaces: `NEG` for a
missing distance, `-NEG` for a missing score, -1 for a missing id, -1e30
for a masked attention score; ties go to the lower index. `torch.topk`,
`argmin` and `argmax` promise no tie order on CUDA, so ties are broken
explicitly here (stable sorts, or the lowest index among the extrema).
The wrappers in `ops.py` call these only for CPU tensors; `chip_smoke.py`
calls them by name on the card to check the kernels.
"""
from __future__ import annotations

import math

import torch

NEG = 3.4e38        # distance sentinel (repro.kernels.ref.NEG)
MASK = -1e30        # masked attention score


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first maximum along `dim` (jnp.argmax order)."""
    m = x.amax(dim=dim, keepdim=True)
    idx = torch.arange(x.shape[dim], device=x.device)
    shape = [1] * x.dim()
    shape[dim] = -1
    big = torch.full_like(idx, x.shape[dim]).view(shape)
    return torch.where(x == m, idx.view(shape), big).amin(dim=dim)


def first_argmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first minimum along `dim` (jnp.argmin order)."""
    return first_argmax(-x, dim)


def ecoscan(q, data, lens, probes, k: int, block_map=None):
    """q [B, d] f32; data [R, CAP, d] f32; lens [R] i32; probes [B, P] i32
    (< 0: padding); block_map [NC] i32 cluster -> scan row (< 0 masks the
    cluster; identity when None). Returns (dists [B, k] f32 ascending,
    slots [B, k] i32 = row*CAP + j), (NEG, -1) past the valid candidates.
    Distances use the kernel's form ||x||^2 - 2 x.q + ||q||^2."""
    B, d = q.shape
    R, CAP, _ = data.shape
    P = probes.shape[1]
    dev = q.device
    if block_map is None:
        block_map = torch.arange(R, dtype=torch.int32, device=dev)
    blk = block_map[probes.clamp(min=0).long()]                # [B, P]
    safe = blk.clamp(min=0).long()
    g = data[safe]                                              # [B,P,CAP,d]
    xx = (g * g).sum(-1)
    xq = torch.einsum("bpcd,bd->bpc", g, q)
    qq = (q * q).sum(-1)
    dist = (xx - 2.0 * xq) + qq[:, None, None]
    slot = torch.arange(CAP, device=dev)
    valid = ((slot[None, None, :] < lens[safe][:, :, None])
             & (probes[:, :, None] >= 0) & (blk[:, :, None] >= 0))
    dist = torch.where(valid, dist, torch.full_like(dist, NEG))
    ids = torch.where(valid, safe[:, :, None] * CAP + slot, -1)
    flat_d = dist.reshape(B, P * CAP)
    flat_i = ids.reshape(B, P * CAP).to(torch.int32)
    out_d = torch.full((B, k), NEG, dtype=torch.float32, device=dev)
    out_i = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    n = min(k, P * CAP)
    if n:
        sd, order = torch.sort(flat_d, dim=1, stable=True)
        out_d[:, :n] = sd[:, :n]
        out_i[:, :n] = torch.gather(flat_i, 1, order[:, :n])
    return out_d, out_i


def route_topk(q, centroids, n_probe: int):
    """Centroid routing: the n_probe nearest centroids per query, nearest
    first, lower centroid id on ties (lax.top_k order) -> [B, n_probe].
    Plain PyTorch on every device (one matmul and a stable sort), as the
    reference leaves it to XLA."""
    d2 = ((q * q).sum(1, keepdim=True) - 2.0 * q @ centroids.T
          + (centroids * centroids).sum(1)[None, :])
    return torch.argsort(d2, dim=1, stable=True)[:, :n_probe].to(torch.int32)


def kmeans_assign(x, centroids):
    """x [N, d]; centroids [NC, d] -> (assign [N] i32, sqdist [N] f32)."""
    d2 = ((x * x).sum(1)[:, None] - 2.0 * x @ centroids.T
          + (centroids * centroids).sum(1)[None, :])
    a = first_argmin(d2, 1)
    return a.to(torch.int32), torch.gather(d2, 1, a[:, None])[:, 0]


def scr_select(q, data, lens, doc_ids):
    """q [B, d]; data [ND, CAPW, d] window blocks; lens [ND]; doc_ids
    [B, K] (< 0: padding). Returns (scores [B, K] f32, wins [B, K] i32):
    each doc's best window score and id, first max on ties, (-NEG, -1)
    for padding and windowless docs."""
    B, K = doc_ids.shape
    ND, CAPW = data.shape[0], data.shape[1]
    dev = q.device
    if ND == 0 or CAPW == 0:
        return (torch.full((B, K), -NEG, dtype=torch.float32, device=dev),
                torch.full((B, K), -1, dtype=torch.int32, device=dev))
    safe = doc_ids.clamp(min=0).long()
    s = torch.einsum("bkwd,bd->bkw", data[safe], q)
    slot = torch.arange(CAPW, device=dev)
    valid = (slot[None, None, :] < lens[safe][:, :, None]) & \
        (doc_ids[:, :, None] >= 0)
    s = torch.where(valid, s, torch.full_like(s, -NEG))
    wins = first_argmax(s, -1)
    scores = torch.gather(s, -1, wins[..., None])[..., 0]
    wins = torch.where(valid.any(-1), wins, -1).to(torch.int32)
    return scores, wins


def decode_attention_paged(q, k, v, kv_len, table):
    """q [B, H, dh]; k, v [P, ps, G, dh] one layer of the page pool;
    kv_len [B]; table [B, W] page ids (entry w backs positions
    [w*ps, (w+1)*ps)). Gathers each row's logical K/V through its table,
    masks positions >= kv_len with -1e30, softmax in f32, probabilities
    rounded to v's type before the PV product. Returns [B, H, dh]."""
    B, H, dh = q.shape
    P, ps, G, _ = k.shape
    W = table.shape[1]
    j = torch.arange(W * ps, device=q.device)
    idx = table.long()[:, j // ps] * ps + (j % ps)              # [B, W*ps]
    kg = k.reshape(P * ps, G, dh)[idx].float()                 # [B,S,G,dh]
    vg = v.reshape(P * ps, G, dh)[idx]
    qg = q.float().reshape(B, G, H // G, dh)
    s = torch.einsum("bgnd,bsgd->bgns", qg, kg) * (1.0 / math.sqrt(dh))
    mask = j[None, :] < kv_len.long()[:, None]                   # [B, S]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, MASK))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bgns,bsgd->bgnd", p, vg.float())
    return o.reshape(B, H, dh).to(q.dtype)
