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


# rows of a probed list per block of the ecoscan kernel (kTile in
# csrc/ecoscan.cu), and the candidates its merge reads a pass (kThreads)
ECOSCAN_TILE = 32
ECOSCAN_CHUNK = 256


def ecoscan_tiled(q, data, lens, probes, k: int, block_map=None,
                  tile: int = ECOSCAN_TILE, chunk: int = ECOSCAN_CHUNK):
    """The tile walk of the ecoscan kernel in plain PyTorch (for tests:
    `ecoscan` is the contract; the kernel's tile is ECOSCAN_TILE). Each
    probed list is cut into `tile`-row tiles, list L = p*ceil(CAP/tile) +
    t; a tile's valid rows are sorted by (distance, flat index f =
    p*CAP + j) and its first kt = min(k, tile) kept, in kt slots. The
    merge of a query reads the slots position-major (slot i of every list,
    then slot i + 1), `chunk` at a time: a candidate joins when the top
    holds fewer than k or it comes before the top's k-th, and the top
    keeps the k first of the union. (NEG, -1) pads. Distances as
    `ecoscan`."""
    B = q.shape[0]
    R, CAP, _ = data.shape
    P = probes.shape[1]
    if block_map is None:
        block_map = torch.arange(R, dtype=torch.int32, device=q.device)
    blk = torch.where(probes >= 0, block_map[probes.clamp(min=0).long()], -1)
    safe = blk.clamp(min=0).long()
    g = data[safe]                                              # [B,P,CAP,d]
    dist = (((g * g).sum(-1) - 2.0 * torch.einsum("bpcd,bd->bpc", g, q))
            + (q * q).sum(-1)[:, None, None]).tolist()
    n = torch.where(blk >= 0, lens[safe].clamp(max=CAP), 0).tolist()
    kt = min(k, tile)
    out_d = torch.full((B, k), NEG, dtype=torch.float32, device=q.device)
    out_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    for b in range(B):
        lists = []                      # kt slots a list; None: no candidate
        for p in range(P):
            r = int(safe[b, p])
            for j0 in range(0, CAP, tile):
                lst = sorted((dist[b][p][j], p * CAP + j, r * CAP + j)
                             for j in range(j0, min(n[b][p], j0 + tile)))
                lists.append(lst[:kt] + [None] * (kt - len(lst[:kt])))
        slots = [lst[i] for i in range(kt) for lst in lists]
        top = []
        for base in range(0, len(slots), chunk):
            new = [c for c in slots[base:base + chunk] if c is not None
                   and (len(top) < k or c[:2] < top[k - 1][:2])]
            top = sorted(top + new)[:k]
        for i, (dv, _, slot) in enumerate(top):
            out_d[b, i] = dv
            out_i[b, i] = slot
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


# (rows per block, centroids per tile) of the kmeans_assign kernel: kBM
# and kBN in csrc/kmeans_assign.cu
KMEANS_TILE = (128, 128)


def kmeans_assign_tiled(x, centroids, bm: int, bn: int):
    """The tile walk of the kmeans_assign kernel in plain PyTorch (for
    tests: `kmeans_assign` is the contract; the kernel's tile is
    KMEANS_TILE). ||x||^2 and ||c||^2 once per row and centroid; each
    bm-row block walks the bn-wide centroid tiles in order (the last of
    each ragged), forms d2 = (xx - 2 x.c) + cc for the tile and keeps a
    running (min, id) per row that a later tile replaces only when
    strictly smaller, so ties go to the lower id."""
    N = x.shape[0]
    xx = (x * x).sum(1)
    cc = (centroids * centroids).sum(1)
    assign = torch.empty(N, dtype=torch.int32, device=x.device)
    sqdist = torch.empty(N, dtype=x.dtype, device=x.device)
    NC = centroids.shape[0]
    for r0 in range(0, N, bm):
        r1 = min(N, r0 + bm)
        best = torch.full((r1 - r0,), math.inf, dtype=x.dtype,
                          device=x.device)
        best_i = torch.full((r1 - r0,), -1, dtype=torch.int64,
                            device=x.device)
        for c0 in range(0, NC, bn):
            c1 = min(NC, c0 + bn)
            d2 = ((xx[r0:r1, None] - 2.0 * x[r0:r1] @ centroids[c0:c1].T)
                  + cc[None, c0:c1])
            a = first_argmin(d2, 1)
            v = torch.gather(d2, 1, a[:, None])[:, 0]
            take = v < best
            best = torch.where(take, v, best)
            best_i = torch.where(take, a + c0, best_i)
        assign[r0:r1] = best_i.to(torch.int32)
        sqdist[r0:r1] = best
    return assign, sqdist


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


def scr_score(windows, q):
    """windows [B, NW, d]; q [B, d] -> scores [B, NW] (inner products)."""
    return torch.einsum("bnd,bd->bn", windows, q)


PQ_SUM_BLOCK = 128     # numpy's pairwise block (PW_BLOCKSIZE)


def pairwise_sum(v):
    """numpy's float32 sum of `v` [..., n] along its last dimension,
    written as explicit adds in numpy's order (`pairwise_sum` of its
    add.reduce over a contiguous row): n < 8 in order; n <= 128 eight
    partial sums r[i % 8] over the first n - n % 8 values, the tree
    ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then the rest in order; longer
    rows split at n2 = n // 2 - (n // 2) % 8 and add the halves' sums."""
    n = v.shape[-1]
    if n < 8:
        s = v[..., 0]
        for i in range(1, n):
            s = s + v[..., i]
        return s
    if n > PQ_SUM_BLOCK:
        h = n // 2 - (n // 2) % 8
        return pairwise_sum(v[..., :h]) + pairwise_sum(v[..., h:])
    r = [v[..., i] for i in range(8)]
    i = 8
    while i < n - n % 8:
        r = [r[j] + v[..., i + j] for j in range(8)]
        i += 8
    s = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for i in range(i, n):
        s = s + v[..., i]
    return s


def pq_adc(lut, codes):
    """lut [B, M, K] distance tables; codes [N, M] uint8 -> scores [B, N]
    = sum_m lut[b, m, codes[n, m]] in f32, in the reference's order:
    numpy's `tabs[arange(M)[None], codes].sum(axis=1)`, which adds the
    row's `pairwise_sum` to the reduction's identity 0. A code >= K adds
    NaN."""
    B, M, K = lut.shape
    c = codes.long()
    m = torch.arange(M, device=lut.device)
    v = lut[:, m[None, :], c.clamp(max=K - 1)]                  # [B, N, M]
    v = torch.where((c < K)[None], v, torch.full_like(v, math.nan))
    return 0.0 + pairwise_sum(v)


def pq_adc_segments(lut, codes, starts, offsets):
    """`pq_adc` over segments of the code rows: starts [S] i32, offsets
    [S + 1] i32 non-decreasing from 0. Segment s is the rows starts[s] ..
    starts[s] + offsets[s+1] - offsets[s] - 1 of codes [N, M], scored
    into out[:, offsets[s]:offsets[s+1]] of scores [B, offsets[S]]; a
    row outside [0, N) scores NaN."""
    lens = (offsets[1:] - offsets[:-1]).long()
    first = torch.repeat_interleave(starts.long() - offsets[:-1].long(), lens)
    rows = first + torch.arange(first.numel(), device=codes.device)
    inside = (rows >= 0) & (rows < codes.shape[0])
    if not codes.shape[0]:                       # nothing to gather from
        codes = torch.zeros((1, codes.shape[1]), dtype=codes.dtype,
                            device=codes.device)
    out = pq_adc(lut, codes[rows.clamp(0, codes.shape[0] - 1)])
    return torch.where(inside[None], out, torch.full_like(out, math.nan))


def flash_prefill(q, k, v, *, causal: bool = True, window=None,
                  q_offset: int = 0, kv_len=None):
    """Masked softmax attention of a block of queries. q [B, Sq, H, dh];
    k, v [B, Sk, G, dh] with H % G == 0 (query head h reads kv head
    h // (H/G)). Query i sits at absolute position q_offset + i, key j at
    j; a key is masked with -1e30 when it is past the query (`causal`),
    `window` or more positions behind it, or at j >= kv_len. Scores
    q.k * (1/sqrt(dh)) and the softmax in f32, the probabilities rounded
    to v's type before the PV product. Returns [B, Sq, H, dh] in q's
    dtype."""
    b, sq, h, dh = q.shape
    sk, g = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, g, h // g, dh).float()
    s = torch.einsum("bqgnd,bkgd->bgnqk", qg, k.float()) * (1.0 /
                                                           math.sqrt(dh))
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    if kv_len is not None:
        mask &= kpos < kv_len
    s = torch.where(mask, s, torch.full_like(s, MASK))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    ctx = torch.einsum("bgnqk,bkgd->bqgnd", p, v.float())
    return ctx.reshape(b, sq, h, dh).to(q.dtype)


def history_rows(row, lo: int, offset: int, page_size: int, ring: int):
    """The flat pool rows (page * page_size + offset in it) of positions
    [lo, offset) of the slot whose page-table row is `row` ([W]), in
    position order: position p at ring cursor p % ring, on page
    row[cursor // page_size] (a row that never wraps is a ring of W *
    page_size)."""
    cur = torch.arange(lo, offset, device=row.device) % ring
    return row.long()[cur // page_size] * page_size + cur % page_size


def flash_prefill_paged(q, k, v, k_pool, v_pool, row, *, offset: int,
                        lo: int, page_size: int, ring_len: int = 0,
                        window=None, k_scale=None, v_scale=None):
    """A prompt chunk's attention over its slot's pages. q [1, C, H, dh];
    k, v [C, G, dh] the chunk's own keys (q's dtype); k_pool, v_pool
    [P, ps, G, dh] one layer of the pool (q's dtype, or int8 with f32
    scales k_scale, v_scale [P, ps, G]); row [W] the slot's page-table
    row. The history, positions [lo, offset) read through `row`
    (`history_rows`, ring `ring_len` or W * ps; int8 dequantized as
    `layers.dequantize_kv` does, (q.f32 * s).to(q's dtype)), then the
    chunk, go to `flash_prefill` causally with `window` at q_offset
    offset - lo and kv_len offset + C - lo. Returns [1, C, H, dh]."""
    c = k.shape[0]
    ring = ring_len or row.shape[0] * page_size
    gather = history_rows(row, lo, offset, page_size, ring)
    hist = []
    for pool, scale in ((k_pool, k_scale), (v_pool, v_scale)):
        flat = pool.reshape((-1,) + pool.shape[2:])[gather]
        if scale is not None:
            s = scale.reshape((-1,) + scale.shape[2:])[gather]
            flat = flat.float() * s[..., None].float()
        hist.append(flat.to(q.dtype))
    return flash_prefill(q, torch.cat([hist[0], k])[None],
                         torch.cat([hist[1], v])[None], causal=True,
                         window=window, q_offset=offset - lo,
                         kv_len=offset + c - lo)


def decode_attention(q, k, v, kv_len, ring: bool = False):
    """q [B, H, dh]; k, v [B, S, G, dh]; kv_len an int (shared length)
    or a [B] tensor. Softmax over each row's first kv_len positions
    (masked with -1e30), scores and softmax in f32, probabilities rounded
    to v's type before the PV product. `ring=True`: the cache is a
    sliding-window ring whose filled slots are all valid, so the mask
    length is min(kv_len, S). Returns [B, H, dh] in q's dtype."""
    B, H, dh = q.shape
    S, G = k.shape[1], k.shape[2]
    lens = torch.as_tensor(kv_len, device=q.device).long().reshape(-1)
    lens = lens.expand(B)
    if ring:
        lens = lens.clamp(max=S)
    qg = q.float().reshape(B, G, H // G, dh)
    s = torch.einsum("bgnd,bsgd->bgns", qg, k.float()) * (1.0 / math.sqrt(dh))
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, MASK))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bgns,bsgd->bgnd", p, v.float())
    return o.reshape(B, H, dh).to(q.dtype)


def decode_split_ranges(S: int, splits: int, tile: int = 64):
    """The [lo, hi) positions that split s of the decode_attention kernel
    covers: tiles [s*T // splits, (s+1)*T // splits) of the T tiles of S
    (the last tile may be ragged, so hi is cut at S)."""
    tiles = -(-S // tile)
    return [(s * tiles // splits * tile,
             min(S, (s + 1) * tiles // splits * tile)) for s in range(splits)]


def _split_merge(q, k, v, lens, n, ranges, ks=None, vs=None):
    """Partials of the position ranges [lo, hi) cut at each row's n, merged
    in range order (the arithmetic of both split decode kernels). k, v
    [B, S, G, dh]; lens [B] masks positions >= kv_len with -1e30; a
    partial is (m, l, unnormalised acc) with the probabilities rounded to
    v's type before the PV product, and an empty one has l = 0 and is
    skipped. out = sum acc_s w_s / max(sum l_s w_s, 1e-30) with w_s =
    exp(m_s - max m). ks, vs [B, S, G]: the scales of an int8 cache k, v;
    a score is then (q . k) * scale * ks, and a probability enters the PV
    product as exp(s - m) * vs rounded to q's type (the running sum takes
    it unscaled)."""
    B, H, dh = q.shape
    S, G = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, G, H // G, dh)
    s = torch.einsum("bgnd,bsgd->bgns", qg, k.float()) * (1.0 / math.sqrt(dh))
    if ks is not None:
        s = s * ks.float().permute(0, 2, 1)[:, :, None, :]
    pos = torch.arange(S, device=q.device)
    s = torch.where((pos[None, :] < lens[:, None])[:, None, None, :], s,
                    torch.full_like(s, MASK))
    parts = []
    for lo, hi in ranges:
        inside = ((pos[None, :] >= lo) & (pos[None, :] < hi)
                  & (pos[None, :] < n[:, None]))[:, None, None, :]
        m = torch.where(inside, s, torch.full_like(s, MASK)).amax(-1)
        p = torch.where(inside, torch.exp(s - m[..., None]),
                        torch.zeros_like(s))
        if vs is None:
            pv = p.to(v.dtype)
        else:
            pv = (p * vs.float().permute(0, 2, 1)[:, :, None, :]).to(q.dtype)
        acc = torch.einsum("bgns,bsgd->bgnd", pv.float(), v.float())
        parts.append((m, p.sum(-1), acc))
    mt = torch.full_like(parts[0][0], MASK)
    for m, l, _ in parts:
        mt = torch.where(l > 0, torch.maximum(mt, m), mt)
    lt = torch.zeros_like(mt)
    at = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.where(l > 0, torch.exp(m - mt), torch.zeros_like(m))
        lt = lt + l * w
        at = at + acc * w[..., None]
    out = at / lt.clamp(min=1e-30)[..., None]
    return out.reshape(B, H, dh).to(q.dtype)


DECODE_TC_DH = (32, 64, 80, 128, 256)   # ops.DECODE_TC_DH


def decode_head_groups(Hg: int, head_groups: int):
    """The [lo, hi) query heads of each of the head_groups blocks of a
    kv head's Hg heads: ceil(Hg / head_groups) heads a block, the last
    block the rest."""
    hb = -(-Hg // head_groups)
    return [(lo, min(Hg, lo + hb)) for lo in range(0, Hg, hb)]


def decode_attention_split(q, k, v, kv_len, splits: int,
                           head_groups: int = 1, route: str = "cuda"):
    """The split-and-merge arithmetic of the decode_attention kernel in
    plain PyTorch (for tests: `decode_attention` is the contract). Row b
    walks its first n = min(kv_len, S) positions (all S when kv_len <= 0)
    with positions >= kv_len masked; a ring's min(kv_len, S) is the same
    mask. Each split of `decode_split_ranges` gives a partial over its
    positions below n; the partials merge in split order (`_split_merge`),
    each head group (`decode_head_groups`: the kernel's blocks of a kv
    head's heads) on its own. `route` is the kernel's: "cuda" or "tc";
    both compute the same partials (scores in f32, probabilities rounded
    to v's type for the PV product, sums in f32), so the model differs
    only in what it takes: "tc" needs bf16 and dh in DECODE_TC_DH, and
    raises ValueError otherwise, as the kernel's entry does."""
    B = q.shape[0]
    S = k.shape[1]
    lens = torch.as_tensor(kv_len, device=q.device).long().reshape(-1)
    lens = lens.expand(B)
    n = torch.where(lens > 0, lens.clamp(max=S), torch.full_like(lens, S))
    return _grouped_split_merge("decode_attention_split", q, k, v, lens, n,
                                decode_split_ranges(S, splits), head_groups,
                                route)


def decode_paged_split_ranges(W: int, splits: int):
    """The [lo, hi) table entries that split s of the
    decode_attention_paged kernel covers: [s*W // splits,
    (s+1)*W // splits)."""
    return [(s * W // splits, (s + 1) * W // splits) for s in range(splits)]


def _gather_pages(k, table):
    """k [P, ps, ...] (values [P, ps, G, dh] or scales [P, ps, G]) through
    table [B, W] -> each row's logical [B, W*ps, ...] (entry w backs
    positions [w*ps, (w+1)*ps))."""
    P, ps = k.shape[:2]
    W = table.shape[1]
    j = torch.arange(W * ps, device=k.device)
    idx = table.long()[:, j // ps] * ps + (j % ps)              # [B, W*ps]
    return k.reshape((P * ps,) + k.shape[2:])[idx]


def _grouped_split_merge(name, q, k, v, lens, n, ranges, head_groups,
                         route, ks=None, vs=None):
    """`_split_merge` for each head group (`decode_head_groups`: the
    kernels' blocks of a kv head's heads) on its own, after the checks of
    the kernels' entries: `route` "cuda" or "tc", the tensor cores only
    for bf16 q at dh in DECODE_TC_DH, head groups that leave none empty
    (ValueError otherwise). Both routes compute the same partials, so the
    model differs only in what it takes."""
    B, H, dh = q.shape
    G = k.shape[2]
    Hg = H // G
    hb = -(-Hg // max(1, head_groups))
    if (route not in ("cuda", "tc") or not 1 <= head_groups <= Hg
            or -(-Hg // hb) != head_groups
            or (route == "tc" and (q.dtype != torch.bfloat16
                                   or dh not in DECODE_TC_DH))):
        raise ValueError(f"{name}: route {route!r}, head groups "
                         f"{head_groups} at Hg {Hg}, dh {dh}, {q.dtype}")
    qg = q.reshape(B, G, Hg, dh)
    outs = []
    for lo, hi in decode_head_groups(Hg, head_groups):
        qh = qg[:, :, lo:hi].reshape(B, G * (hi - lo), dh)
        outs.append(_split_merge(qh, k, v, lens, n, ranges, ks, vs).reshape(
            B, G, hi - lo, dh))
    return torch.cat(outs, 2).reshape(B, H, dh)


def _paged_rows(kv_len, table, ps: int, splits: int):
    """(lens, n, ranges) of the paged kernels: row b walks its first
    npg = ceil(kv_len / ps) table entries (all W when kv_len <= 0), n =
    npg * ps positions; split s covers the positions of the entries
    `decode_paged_split_ranges(W, splits)[s]`."""
    B, W = table.shape
    lens = kv_len.long().reshape(B)
    npg = torch.where(lens > 0, ((lens + ps - 1) // ps).clamp(max=W),
                      torch.full_like(lens, W))
    ranges = [(lo * ps, hi * ps)
              for lo, hi in decode_paged_split_ranges(W, splits)]
    return lens, npg * ps, ranges


def decode_attention_paged_split(q, k, v, kv_len, table, splits: int,
                                 head_groups: int = 1, route: str = "cuda"):
    """The split-and-merge arithmetic of the decode_attention_paged kernel
    in plain PyTorch (for tests: `decode_attention_paged` is the
    contract). Row b counts its first npg = ceil(kv_len / ps) table
    entries (all W when kv_len <= 0) with positions >= kv_len masked;
    each split of `decode_paged_split_ranges` gives a partial over its
    entries below npg (a split past npg is empty), and the partials merge
    in split order (`_split_merge`), each head group on its own; `route`
    as `_grouped_split_merge` takes it."""
    lens, n, ranges = _paged_rows(kv_len, table, k.shape[1], splits)
    return _grouped_split_merge(
        "decode_attention_paged_split", q, _gather_pages(k, table),
        _gather_pages(v, table), lens, n, ranges, head_groups, route)


def decode_attention_paged_q8_split(q, kq, ks, vq, vs, kv_len, table,
                                    splits: int, head_groups: int = 1,
                                    route: str = "cuda"):
    """`decode_attention_paged_split` over an int8 pool (kq, vq [P, ps, G,
    dh] int8, ks, vs [P, ps, G] f32): the decode_attention_paged_q8
    kernel's arithmetic. On the tensor cores ("tc") the int8 rows are
    widened to bf16 (exact) for the bf16 products; on either route a
    score is (q . kq) * scale * ks in f32, a probability enters the PV
    product as exp(s - m) * vs rounded to q's type, and the running sum
    takes it unscaled."""
    lens, n, ranges = _paged_rows(kv_len, table, kq.shape[1], splits)
    k, v = _gather_pages(kq, table), _gather_pages(vq, table)
    if route == "tc":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    return _grouped_split_merge(
        "decode_attention_paged_q8_split", q, k, v, lens, n, ranges,
        head_groups, route, _gather_pages(ks, table),
        _gather_pages(vs, table))


def decode_attention_paged(q, k, v, kv_len, table):
    """q [B, H, dh]; k, v [P, ps, G, dh] one layer of the page pool;
    kv_len [B]; table [B, W] page ids (entry w backs positions
    [w*ps, (w+1)*ps)). Gathers each row's logical K/V through its table
    and attends as `decode_attention` does. Returns [B, H, dh]."""
    return decode_attention(q, _gather_pages(k, table),
                            _gather_pages(v, table), kv_len)


def decode_attention_q8(q, kq, ks, vq, vs, kv_len, ring: bool = False):
    """int8-KV decode attention (`repro.models.layers.decode_attention_q8`).
    q [B, H, dh]; kq, vq [B, S, G, dh] int8; ks, vs [B, S, G] f32 scales;
    kv_len an int or a [B] tensor; `ring` as `decode_attention`. The
    scales commute through the products: scores (q . kq) * 1/sqrt(dh) in
    f32 times ks; after the softmax the probabilities times vs, rounded
    to q's type, then the product with vq. Returns [B, H, dh] in q's
    dtype."""
    B, H, dh = q.shape
    S, G = kq.shape[1], kq.shape[2]
    lens = torch.as_tensor(kv_len, device=q.device).long().reshape(-1)
    lens = lens.expand(B)
    if ring:
        lens = lens.clamp(max=S)
    qg = q.float().reshape(B, G, H // G, dh)
    s = torch.einsum("bgnd,bsgd->bgns", qg, kq.float()) * (1.0 / math.sqrt(dh))
    s = s * ks.float().permute(0, 2, 1)[:, :, None, :]
    mask = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, MASK))
    p = torch.softmax(s, dim=-1) * vs.float().permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bgns,bsgd->bgnd", p.to(q.dtype).float(), vq.float())
    return o.reshape(B, H, dh).to(q.dtype)


def decode_attention_paged_q8(q, kq, ks, vq, vs, kv_len, table):
    """`decode_attention_q8` over an int8 page pool: kq, vq [P, ps, G, dh]
    int8 and ks, vs [P, ps, G] f32 (one layer), read through table [B, W]
    (entry w backs positions [w*ps, (w+1)*ps)); kv_len [B]."""
    return decode_attention_q8(q, _gather_pages(kq, table),
                               _gather_pages(ks, table),
                               _gather_pages(vq, table),
                               _gather_pages(vs, table), kv_len)
