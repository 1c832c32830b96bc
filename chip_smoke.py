#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Phases, any failure exits non-zero (nothing is caught):

1. Print the card (`nvidia-smi` name and power limit) and build the CUDA
   kernels from `src/repro_torch/kernels/csrc/` (timed).
2. The main path: MobileRAG over a 16,384-document synthetic SQuAD-style
   corpus (HashEmbedder at the gte-small width 384: NC = 256 clusters,
   a [256, CAP, 384] EcoVector pack and a [16384, 10, 384] window pack)
   with full-width qwen2.5-0.5B in bf16 (24 layers, random weights from a
   seed), `answer_batch(16 questions, generate=True, max_new=16)` through
   4 slots; the chunked prefill runs `flash_prefill`. The port has no
   retrieval or SCR fallback: a fault raises, so zero fallbacks is the run
   reaching its end.
3. The wave path of the same model: the 16 prompts, left-padded to
   32-token buckets, through `Engine.generate(continuous=False,
   max_new=16)` (`flash_prefill` prefill, `decode_attention` decode),
   with the share of greedy tokens equal to the continuous engine's on
   the same prompts (reported, not asserted: bf16).
4. Full-width h2o-danube-1.8b in bf16 (24 layers, d 2560, window 4096,
   random weights from a seed) on the wave path: 2 prompts of 4,608
   tokens, max_new=16, so the 4,096-slot ring wraps in prefill and decode.
   Every launch counter is zeroed just before each of phases 2-4 and read
   just after it; each kernel of that path must have launched.
5. Each kernel against its plain PyTorch version on the inputs and shapes
   of phases 2-4, plus edge cases, with kernel, plain and library-call
   times (CUDA events) and the bound of the work: ids exact except at
   ties within the value tolerance, ecoscan and scr_select values 2e-5,
   kmeans_assign 1e-4 (relative), attention 1e-5 in f32 and 2e-2 in bf16
   (the attention edge cases run in both); ecoscan and scr_select also
   give the same bits on two calls. ecoscan runs at the main path's shape
   and at scale (no path runs it: 16 queries of 8 probes over a [1024,
   512, 384] pack, k 10, with the identity and with a masked block_map),
   its edge cases through the wrapper and at each forced tile
   (`ecoscan_edges`), and its kernel launches a call are counted (the
   kernel nodes of a CUDA graph captured around one call, `kernel_nodes`);
   scr_select at the main path's shape, at top_k 10 (16 questions x 10
   docs over the main path's window pack) and its edge cases
   (`scr_select_edges`). decode_attention_paged runs at
   the main path's shape and at a long-cache shape (4 rows at kv_len
   4,096 through 130-entry tables; no path runs it), and its edge cases
   also at forced split counts (`paged_edges`). kmeans_assign runs at the
   three shapes of its paths (the EcoVector build's, the IVF partition's
   and a PQ sub-quantizer's, on the baselines' own data) and its edge
   cases (`kmeans_edges`). pq_adc equals its plain version bit for bit
   (both sum in numpy's order), through the wrapper and at forced
   variants, at a real IVFPQ query's shape (its n_probe-16 lists as
   segments of the index's pack), at a flat shape (16 queries over the
   whole pack; no path runs it) and at its edge cases (`pq_adc_edges`).
   Each kernel's line shows its time over the
   library call's and the share of its bound. The launch path: the
   wrappers' current stream equals `torch.cuda.current_stream()` under a
   side stream, and `scr_score`'s cached C entry point is timed alone
   beside its wrapper and `bmm`.
   TF32 is off for every float32 matmul and convolution (the plain
   versions run in full f32).
6. The same pipeline on a small corpus with the float32 reduced model,
   on the GPU (kernels) and on the CPU (plain versions): the same doc
   ids, prompts and greedy tokens; the same wave tokens on both, equal to
   the continuous engine's on the GPU; and the float32 reduced h2o on an
   80-token prompt (its 64-slot ring wraps), the same wave tokens on both.
7. torch.profiler windows over steady decode steps of the main path,
   over a wave's prefill and decode steps (qwen2.5 and h2o; device busy
   and idle share, the kernels and host ops that take the time) and over
   each kernel wrapper alone (device time per call).

Two more paths run after phase 4, and their kernels join phases 5-7;
then the F8 phase: the EcoVector partition (the main path's 16,384
embeddings into 256 clusters) and the IVF partition (100,000 x 128 into
390) each k-means'd twice on the card, bit for bit equal, and stepped
against the CPU's plain versions from the same centroids: assignments
equal except at ties within 1e-4, cluster sums equal (`kmeans_
determinism`; a whole CPU build and two card builds with the
`index_add_` update the port had before are reported beside them):
- the legacy SCR path: the main path's pipeline with
  `use_window_index=False`, so each query re-embeds its retrieved
  documents' windows and scores them with `scr_score` (one launch per
  query), beside the window-index path's SCR time;
- the baselines path: IVF, IVFPQ, IVF-DISK and IVFPQ-DISK over 100,000
  SIFT-like vectors (128-d, 390 clusters, m_pq 8), 200 queries at k 10
  and n_probe 4 and 16, recall@10 against an exact search on the card;
  the PQ indexes score each query with one `pq_adc` launch (IVFPQ: its
  probed lists as segments of its device pack), and every query's ids
  and distances equal numpy's own sums on the host bit for bit (F9); each
  PQ search is also timed along the parent tree's path (codes stacked on
  the host, `stacked_search`), beside this tree's.

The line before the last is the kernel summary as JSON; the last line is
`{"ok": true, "device": {...}}`.
"""
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import kmeans as kmeans_mod  # noqa: E402
from repro_torch.core.baselines import make_index  # noqa: E402
from repro_torch.core.kmeans import (cluster_sums,  # noqa: E402
                                     kmeans_pp_init, lloyd)
from repro_torch.core.scr import (SCRConfig, sliding_windows,  # noqa: E402
                                  split_sentences)
from repro_torch.data.synthetic import make_qa_corpus, sift_like  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.dense import DenseLM, cache_len  # noqa: E402
from repro_torch.serving.embedder import HashEmbedder  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.rag import MobileRAG  # noqa: E402
from repro_torch.serving.trace import TraceSink  # noqa: E402

HBM_BYTES_S = 3.35e12          # H100 SXM HBM3
F32_FLOPS_S = 67e12            # f32 outside the tensor cores
BF16_FLOPS_S = 989e12          # bf16 tensor cores, dense
# device and scale of the main path
DEV = "cuda"
N_DOCS = 16384
GEN_CONFIG = get_config("qwen25_0_5b")
MAX_NEW = 16
# the sliding-window model of phase 4: prompts past its 4,096 window
H2O_CONFIG = get_config("h2o_danube_1_8b")
H2O_PROMPT = 4608
# the baselines path: the paper's SIFT-1M cut to 0.1x (the k-means++
# seeding, a numpy copy of the reference's so both give the same
# centroids, is O(N * NC * d) on the host)
SIFT_N = 100_000
SIFT_NQ = 200
BASELINES = ("IVF", "IVFPQ", "IVF-DISK", "IVFPQ-DISK")
N_PROBES = (4, 16)
M_PQ = 8
REPLACES = {
    "kmeans_assign": "src/repro/kernels/kmeans_assign.py:37",
    "ecoscan": "src/repro/kernels/ecoscan.py:163",
    "scr_select": "src/repro/kernels/scr_select.py:115",
    "decode_attention_paged": "src/repro/kernels/decode_attention.py:135",
    "flash_prefill": "src/repro/kernels/flash_prefill.py:95",
    "decode_attention": "src/repro/kernels/decode_attention.py:188",
    "scr_score": "src/repro/kernels/scr_score.py:33",
    "pq_adc": "src/repro/kernels/pq_adc.py:44",
}
# the kernels each path must launch
PATH_KERNELS = {
    "main": ("kmeans_assign", "ecoscan", "scr_select",
             "decode_attention_paged", "flash_prefill"),
    "wave": ("flash_prefill", "decode_attention"),
    "h2o": ("flash_prefill", "decode_attention"),
    "legacy": ("kmeans_assign", "ecoscan", "scr_score",
               "decode_attention_paged", "flash_prefill"),
    "baselines": ("kmeans_assign", "pq_adc"),
}


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call (CUDA events around `iters` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def close(name, got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    if not bool((err <= lim).all()):
        raise AssertionError(f"{name}: max error {err.max().item():.3g} "
                             f"beyond rtol {rtol} / atol {atol}")
    return err.max().item()


def same_or_tied(name, got_ids, want_ids, value_of, rtol, atol):
    """Ids equal, except where the two picks' plain values tie within the
    value tolerance (float sum order decides such ties)."""
    diff = got_ids != want_ids
    if diff.any():
        vg, vw = value_of(got_ids)[diff], value_of(want_ids)[diff]
        if not bool(((vg - vw).abs() <= atol + rtol * vw.abs()).all()):
            raise AssertionError(f"{name}: {int(diff.sum())} ids differ "
                                 "beyond a tie")
    return int(diff.sum())


# ------------------------------------------------------------- kernels


def _kmeans_check(label, x, cent):
    """kmeans_assign against plain: ids exact except ties within 1e-4,
    sqdist 1e-4 (relative; sums in another order). Returns (ids, max abs
    error, tied swaps)."""
    a, dist = ops.kmeans_assign(x, cent)
    pa, pdist = ref.kmeans_assign(x, cent)
    d2 = ((x * x).sum(1)[:, None] - 2.0 * x @ cent.T
          + (cent * cent).sum(1)[None, :])
    ties = same_or_tied(label, a, pa,
                        lambda ids: d2.gather(1, ids.long()[:, None])[:, 0],
                        1e-4, 1e-4)
    return a, close(label, dist, pdist, 1e-4, 1e-4), ties


def check_kmeans(label, x, cent):
    """kmeans_assign at one path shape: against plain, times (library:
    `cdist` + `argmin`), and the f32 bound of the work."""
    N, d = x.shape
    NC = cent.shape[0]
    _, err, ties = _kmeans_check(f"kmeans_assign {label}", x, cent)
    b_ms, b_by = bound((N * d + NC * d) * 4 + N * 8,
                       2.0 * N * NC * d + 2.0 * (N + NC) * d, F32_FLOPS_S)
    return dict(
        shape=f"{label}: x {list(x.shape)}, centroids {list(cent.shape)}",
        err=err, ties=ties,
        ms=time_ms(lambda: ops.kmeans_assign(x, cent)),
        plain_ms=time_ms(lambda: ref.kmeans_assign(x, cent)),
        library_ms=time_ms(lambda: torch.cdist(x, cent).argmin(1)),
        bound_ms=b_ms, bound_by=b_by)


def kmeans_edges():
    """Edge cases of kmeans_assign, each against plain (ids exact except
    ties within 1e-4, sqdist 1e-4): a ragged row count with 5 centroids
    and an exact tie (centroid 4 == centroid 0); NC 390 (a ragged last
    128-centroid tile) at d 50 (4-byte copies, a ragged feature chunk)
    with exact ties across two tile boundaries (centroid 128 == centroid
    0, centroid 256 == centroid 255), which must go to the lower id; an x
    whose base is 4 bytes off 16-byte alignment (4-byte copies); NC 1.
    Returns the number of cases."""
    g = torch.Generator(device=DEV).manual_seed(1)
    xe = torch.randn(100, 16, generator=g, device=DEV)
    ce = torch.cat([xe[:4], xe[:1]])                # centroid 4 == centroid 0
    a, _, _ = _kmeans_check("kmeans_assign edge NC 5", xe, ce)
    assert int(a[0]) == 0, "kmeans_assign: tie must go to the lower id"
    ce = torch.randn(390, 50, generator=g, device=DEV)
    ce[128] = ce[0]
    ce[256] = ce[255]
    xe = torch.randn(1000, 50, generator=g, device=DEV)
    xe[:3] = ce[0]
    xe[3:6] = ce[255]
    a, _, _ = _kmeans_check("kmeans_assign edge NC 390, d 50", xe, ce)
    assert a[:6].tolist() == [0, 0, 0, 255, 255, 255], \
        "kmeans_assign: a tie across a tile boundary must go to the lower id"
    buf = torch.randn(1 + 3000 * 64, generator=g, device=DEV)
    xm = buf[1:1 + 3000 * 64].view(3000, 64)
    assert xm.is_contiguous() and xm.data_ptr() % 16 == 4
    _kmeans_check("kmeans_assign edge x off alignment", xm,
                  torch.randn(200, 64, generator=g, device=DEV))
    _kmeans_check("kmeans_assign edge NC 1", xm[:77],
                  torch.randn(1, 64, generator=g, device=DEV))
    return 4


def _slot_dist(q, data):
    """slots [B, k] -> the plain distance of each slot's row to its query
    (NEG for -1)."""
    flat = data.reshape(-1, data.shape[-1])

    def value_of(slots):
        rows = flat[slots.long().clamp(min=0)]             # [B, k, d]
        v = ((rows * rows).sum(-1) - 2.0 * (rows * q[:, None]).sum(-1)
             + (q * q).sum(-1)[:, None])
        return torch.where(slots >= 0, v, torch.full_like(v, ref.NEG))
    return value_of


def _ecoscan_bound(q, data, lens, probes, k, block_map):
    """Bytes bound of one ecoscan call: the rows of the distinct probed
    (and mapped, unmasked) lists, q, probes, the map and the outputs."""
    B, d = q.shape
    blk = probes.long() if block_map is None else \
        block_map[probes.clamp(min=0).long()].long()
    ok = (probes >= 0) & (blk >= 0)
    rows = int(lens[torch.unique(blk[ok])].clamp(max=data.shape[1]).sum())
    cand = int(lens[blk.clamp(min=0)].clamp(max=data.shape[1])[ok].sum())
    maps = 0 if block_map is None else block_map.numel()
    return bound((rows * d + B * d + probes.numel() + maps + B * k * 2) * 4,
                 2.0 * d * (cand + rows), F32_FLOPS_S)


def _bit_equal(name, fn):
    """Two calls of fn give the same bits."""
    a, b = fn(), fn()
    assert all(torch.equal(x, y) for x, y in zip(a, b)), \
        f"{name}: two calls differ"


def _ecoscan_case(label, q, data, lens, probes, k, block_map=None):
    """ecoscan against plain through the wrapper and at each forced tile
    (ids exact except ties within 2e-5, values 2e-5), each bit-equal
    across two calls. Returns (max abs error, tied swaps, wrapper ids)."""
    want = ref.ecoscan(q, data, lens, probes, k, block_map=block_map)
    calls = [("", lambda: ops.ecoscan(q, data, lens, probes, k,
                                      block_map=block_map))]
    calls += [(f" at tile {t}", lambda t=t: ops.ecoscan_launch(
        q, data, lens, probes, k, block_map, tile=t))
        for t in ops.ECOSCAN_TILES]
    err, ties, ids = 0.0, 0, None
    for tag, fn in calls:
        dist, got = fn()
        ties = max(ties, same_or_tied(f"ecoscan {label}{tag}", got, want[1],
                                      _slot_dist(q, data), 2e-5, 2e-5))
        err = max(err, close(f"ecoscan {label}{tag}", dist, want[0], 2e-5,
                             2e-5))
        _bit_equal(f"ecoscan {label}{tag}", fn)
        ids = got if ids is None else ids
    return err, ties, ids


def check_ecoscan(label, q, data, lens, probes, k, block_map=None):
    """ecoscan at one shape: `_ecoscan_case`, times (library: `cdist` +
    `topk` over the gathered lists) and the bound of the work."""
    B, d = q.shape
    err, ties, _ = _ecoscan_case(label, q, data, lens, probes, k, block_map)
    b_ms, b_by = _ecoscan_bound(q, data, lens, probes, k, block_map)
    blk = probes.long() if block_map is None else \
        block_map[probes.clamp(min=0).long()].long()

    def library():
        g_ = data[blk.clamp(min=0)].reshape(B, -1, d)
        return torch.topk(torch.cdist(q[:, None], g_)[:, 0], k,
                          largest=False)
    call = lambda: ops.ecoscan(q, data, lens, probes, k,  # noqa: E731
                               block_map=block_map)
    return dict(
        shape=f"{label}: q {list(q.shape)}, data {list(data.shape)}, probes "
              f"{list(probes.shape)}, k {k}, block_map "
              f"{'identity' if block_map is None else 'masked'}",
        err=err, ties=ties, ms=time_ms(call),
        plain_ms=time_ms(lambda: ref.ecoscan(q, data, lens, probes, k,
                                             block_map=block_map)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def ecoscan_scale_inputs(g):
    """The at-scale ecoscan shape (no path runs it): a [1024, 512, 384]
    f32 pack (805 MB, the pack of a ~260k-passage corpus at gte-small's
    width) with lens uniform in [128, 512], 16 queries of 8 distinct
    random probes, k 10; and a block_map that permutes the clusters and
    masks every eighth."""
    R, CAP, d, B, P = 1024, 512, 384, 16, 8
    data = torch.randn(R, CAP, d, generator=g, device=DEV)
    lens = torch.randint(128, CAP + 1, (R,), generator=g, device=DEV,
                         dtype=torch.int32)
    q = torch.randn(B, d, generator=g, device=DEV)
    probes = torch.stack([torch.randperm(R, generator=g, device=DEV)[:P]
                          for _ in range(B)]).to(torch.int32)
    bm = torch.randperm(R, generator=g, device=DEV).to(torch.int32)
    bm[::8] = -1
    return (q, data, lens, probes, 10), bm


def ecoscan_edges():
    """Edge cases of ecoscan, each through the wrapper and at every forced
    tile (`_ecoscan_case`): a duplicate probe, a padded probe, masked and
    remapped clusters, a list with lens 0, k 3 and k past all candidates;
    exact ties at rows 15/16, 31/32 and 63/64 of one list and in a second
    list (small integers: every distance exact), which must come out in
    flat order; d 50 (4-byte loads) over a ragged 70-row CAP; a pack 4
    bytes off 16-byte alignment; a query whose probes are all padding.
    Returns the number of (case, tile) pairs."""
    g = torch.Generator(device=DEV).manual_seed(2)
    n = 0

    def ints(*x):
        return torch.tensor(x, dtype=torch.int32, device=DEV)
    de = torch.randn(6, 16, 32, generator=g, device=DEV)
    qe = torch.randn(2, 32, generator=g, device=DEV)
    for kk in (3, 40):
        _ecoscan_case(f"edge probes k {kk}", qe, de, ints(16, 0, 3, 16, 5, 9),
                      ints(1, 1, -1, 2, 5, 3, 4, 0).view(2, 4), kk,
                      block_map=ints(0, 2, 5, -1, 4, 1))
        n += 1
    dt = torch.randint(-3, 4, (4, 131, 12), generator=g, device=DEV).float()
    qt = torch.randint(-3, 4, (1, 12), generator=g, device=DEV).float()
    tie_rows = (15, 16, 31, 32, 63, 64)
    dt[2, list(tie_rows)] = qt[0]
    dt[0, 5] = qt[0]
    _, _, ids = _ecoscan_case("edge exact ties", qt, dt,
                              ints(131, 131, 131, 0),
                              ints(3, 2, 0).view(1, 3), 8)
    want = [2 * 131 + j for j in tie_rows] + [5]
    assert ids[0, :7].tolist() == want, \
        f"ecoscan: exact ties out of flat order: {ids[0, :7].tolist()}"
    d50 = torch.randn(9, 70, 50, generator=g, device=DEV)
    _ecoscan_case("edge d 50", torch.randn(3, 50, generator=g, device=DEV),
                  d50, torch.randint(0, 71, (9,), generator=g, device=DEV,
                                     dtype=torch.int32),
                  ints(0, 4, 8, 2, 2, 7, -1, -1, -1).view(3, 3), 5)
    buf = torch.randn(1 + 8 * 40 * 64, generator=g, device=DEV)
    dm = buf[1:].view(8, 40, 64)
    assert dm.is_contiguous() and dm.data_ptr() % 16 == 4
    _ecoscan_case("edge off alignment", torch.randn(2, 64, generator=g,
                                                    device=DEV),
                  dm, ints(40, 7, 33, 0, 40, 1, 20, 39), ints(1, 2, 6, 7)
                  .view(2, 2), 100)
    n += 3
    return n * (1 + len(ops.ECOSCAN_TILES))


def _win_score(q, data, ids):
    """wins [B, K] -> the plain score of each picked window (-NEG for
    -1)."""
    def value_of(wins):
        rows = data[ids.clamp(min=0).long(), wins.clamp(min=0).long()]
        v = (rows * q[:, None]).sum(-1)
        return torch.where(wins >= 0, v, torch.full_like(v, -ref.NEG))
    return value_of


def _scr_case(label, q, data, lens, ids):
    """scr_select against plain (ids exact except ties within 2e-5,
    scores 2e-5), bit-equal across two calls. Returns (max abs error,
    tied swaps, wins)."""
    s, w = ops.scr_select(q, data, lens, ids)
    ps_, pw = ref.scr_select(q, data, lens, ids)
    ties = same_or_tied(f"scr_select {label}", w, pw, _win_score(q, data, ids),
                        2e-5, 2e-5)
    err = close(f"scr_select {label}", s, ps_, 2e-5, 2e-5)
    _bit_equal(f"scr_select {label}", lambda: ops.scr_select(q, data, lens,
                                                             ids))
    return err, ties, w


def check_scr_select(label, q, data, lens, ids):
    """scr_select at one shape: `_scr_case`, times (library: `bmm` +
    `max` over the gathered blocks) and the bound of the work."""
    B, d = q.shape
    ND, CAPW, _ = data.shape
    K = ids.shape[1]
    err, ties, _ = _scr_case(label, q, data, lens, ids)
    valid = ids >= 0
    n_win = int(lens[ids.clamp(min=0).long()][valid].sum())
    uniq = torch.unique(ids[valid].long())
    b_ms, b_by = bound(int(lens[uniq].sum()) * d * 4 + B * d * 4
                       + ids.numel() * 4 + B * K * 8, 2.0 * d * n_win,
                       F32_FLOPS_S)

    def library():
        g_ = data[ids.clamp(min=0).long()].reshape(B, K * CAPW, d)
        return torch.bmm(g_, q[:, :, None]).reshape(B, K, CAPW).max(-1)
    return dict(
        shape=f"{label}: q {list(q.shape)}, data {list(data.shape)}, "
              f"doc_ids {list(ids.shape)}",
        err=err, ties=ties,
        ms=time_ms(lambda: ops.scr_select(q, data, lens, ids)),
        plain_ms=time_ms(lambda: ref.scr_select(q, data, lens, ids)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def scr_select_edges(data):
    """Edge cases of scr_select (`_scr_case`): padded slots, a windowless
    doc and an exact first-max tie in the main path's pack; CAPW 40 (16
    warps a pair, three windows a warp) with exact ties between windows
    on two warps (3, 20) and on one warp (5, 21); d 50 (4-byte loads);
    CAPW 3 (five pairs a block) with padding. Returns the number of
    cases."""
    g = torch.Generator(device=DEV).manual_seed(5)
    d = data.shape[2]

    def ints(*x):
        return torch.tensor(x, dtype=torch.int32, device=DEV)
    de = data[:4].clone()
    de[2, 1] = de[2, 0]
    qe = (de[2, 0] / de[2, 0].norm()).expand(2, d).contiguous()
    _, _, w = _scr_case("edge padded, windowless, first max", qe, de,
                        ints(3, 0, 8, 1), ints(0, 1, -1, 2, 3, 1).view(2, 3))
    assert int(w[1, 0]) == 0, "scr_select: tie must go to the first max"
    dw = torch.randn(3, 40, 48, generator=g, device=DEV)
    for first, second in ((3, 20), (5, 21)):
        dw[1, first] = dw[1, second] = 4.0 * torch.randn(
            48, generator=g, device=DEV)
        qw = (dw[1, first] / dw[1, first].norm())[None]
        _, _, w = _scr_case(f"edge CAPW 40, tie {first}/{second}", qw, dw,
                            ints(40, 40, 9), ints(1, 0, 2, -1).view(1, 4))
        assert int(w[0, 0]) == first,             f"scr_select: tie {first}/{second} must go to the first max"
    _scr_case("edge d 50", torch.randn(2, 50, generator=g, device=DEV),
              torch.randn(5, 12, 50, generator=g, device=DEV),
              ints(12, 0, 7, 1, 12), ints(0, 1, 2, 3, 4, 0, -1, 4).view(2, 4))
    _scr_case("edge CAPW 3", torch.randn(4, d, generator=g, device=DEV),
              torch.randn(20, 3, d, generator=g, device=DEV),
              torch.randint(0, 4, (20,), generator=g, device=DEV,
                            dtype=torch.int32),
              torch.randint(-1, 20, (4, 5), generator=g, device=DEV,
                            dtype=torch.int32))
    return 5


def kernel_nodes(fn):
    """Kernel launches of one call of fn, counted exactly: the kernel
    nodes of a CUDA graph captured around the call (cuGraphGetNodes and
    cuGraphNodeGetType of libcuda). torch.profiler is no count
    here: it drops kernel events, even in a fresh process (PERF.md 7).
    fn runs once on the capture stream first, so that nothing it sets up
    per stream is captured."""
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=s):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        kernels += kind.value == 0          # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def check_scr_score(w, q):
    """scr_score at one legacy query's shape, against plain at 1e-5 (sums
    in another order), plus edges: NW 1, NW not a multiple of the 8 rows
    of a block, d 32 and 48 (float4 loads), d 50 (scalar loads), B 3."""
    B, NW, d = w.shape
    err = close("scr_score", ops.scr_score(w, q), ref.scr_score(w, q),
                1e-5, 1e-5)
    g = torch.Generator(device=DEV).manual_seed(6)
    for b_, nw, dd in ((1, 1, 384), (1, 37, 384), (3, 13, 32), (2, 9, 48),
                       (2, 11, 50)):
        we = torch.randn(b_, nw, dd, generator=g, device=DEV)
        qe = torch.randn(b_, dd, generator=g, device=DEV)
        close(f"scr_score edge {b_}x{nw}x{dd}", ops.scr_score(we, qe),
              ref.scr_score(we, qe), 1e-5, 1e-5)
    b_ms, b_by = bound((B * NW * d + B * d + B * NW) * 4, 2.0 * B * NW * d,
                       F32_FLOPS_S)
    q3 = q[:, :, None].contiguous()
    # the cached C entry point alone, on prepared arguments: what is left
    # of a call without the wrapper's checks, allocation and stream lookup
    fn = build.entry("scr_score")
    out = torch.empty(B, NW, device=DEV)
    args = (w.data_ptr(), q.data_ptr(), B, NW, d, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    return dict(
        shape=f"legacy query: windows {list(w.shape)}, q {list(q.shape)}",
        err=err, ties=0,
        ms=time_ms(lambda: ops.scr_score(w, q), iters=50),
        plain_ms=time_ms(lambda: ref.scr_score(w, q), iters=50),
        library_ms=time_ms(lambda: torch.bmm(w, q3), iters=50),
        bare_call_ms=time_ms(lambda: fn(*args), iters=200),
        bound_ms=b_ms, bound_by=b_by)


def check_current_stream(w, q):
    """`ops._stream` gives the current stream: under a non-default stream
    its handle equals `torch.cuda.current_stream().cuda_stream`, and a
    wrapper launched there agrees with the plain version."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        handle = ops._stream(w.device)
        want = torch.cuda.current_stream().cuda_stream
        out = ops.scr_score(w, q)
    s.synchronize()
    assert handle == want == s.cuda_stream, (handle, want, s.cuda_stream)
    default = ops._stream(w.device)
    assert default == torch.cuda.current_stream().cuda_stream
    close("scr_score on a side stream", out, ref.scr_score(w, q), 1e-5, 1e-5)
    return {"raw_getter": ops._raw_stream is not None,
            "side_stream": s.cuda_stream, "handle_under_side_stream": handle,
            "handle_after": default}


PQ_FORCED = [(qb, threads, 0) for qb in (1, 2, 4) for threads in (64, 512)]


def _pq_held(label, lut, codes, seg=None):
    """pq_adc bit for bit equal to its plain version (both sum in numpy's
    order) through the wrapper and at each forced variant of PQ_FORCED
    (`ops.pq_adc_launch`: queries a lookup, threads a block), and two
    calls bit-equal. seg: (starts, offsets, rows) on the card."""
    st, off, rows = seg if seg else (None, None, codes.shape[0])
    want = (ref.pq_adc(lut, codes) if seg is None
            else ref.pq_adc_segments(lut, codes, st, off))
    got = ops.pq_adc(lut, codes, st, off, rows=rows) if seg else \
        ops.pq_adc(lut, codes)
    assert torch.equal(got, want), f"pq_adc {label}: not bit-equal"
    assert torch.equal(got, ops.pq_adc(lut, codes, st, off, rows=rows)
                       if seg else ops.pq_adc(lut, codes)), \
        f"pq_adc {label}: two calls differ"
    for forced in PQ_FORCED:
        assert torch.equal(ops.pq_adc_launch(lut, codes, st, off, rows,
                                             forced), want), \
            f"pq_adc {label} at {forced}: not bit-equal"
    return want


def _pq_times(label, lut, codes, seg=None, iters=50):
    """pq_adc held bit for bit (`_pq_held`), with times, the bytes bound
    and the library yardstick: `embedding_bag` in sum mode over the
    flattened [M*K] table, one call per query row, on the rows the call
    scores (gathered and offset outside the timing)."""
    B, M, K = lut.shape
    want = _pq_held(label, lut, codes, seg)
    rows = want.shape[1]
    if seg is None:
        def call():
            return ops.pq_adc(lut, codes)

        def plain():
            return ref.pq_adc(lut, codes)
        stacked, seg_bytes = codes, 0
    else:
        st, off, _ = seg

        def call():
            return ops.pq_adc(lut, codes, st, off, rows=rows)

        def plain():
            return ref.pq_adc_segments(lut, codes, st, off)
        lens = (off[1:] - off[:-1]).long()
        stacked = codes[torch.repeat_interleave(
            st.long() - off[:-1].long(), lens)
            + torch.arange(rows, device=DEV)]
        seg_bytes = (st.numel() + off.numel()) * 4
    b_ms, b_by = bound(rows * M + (B * M * K + B * rows) * 4 + seg_bytes,
                       float(B * rows * M), F32_FLOPS_S)
    flat = stacked.long() + K * torch.arange(M, device=DEV)
    tabs = [lut[b].reshape(M * K, 1) for b in range(B)]

    def library():
        return [F.embedding_bag(flat, t, mode="sum") for t in tabs]
    return dict(
        shape=f"{label}: lut {list(lut.shape)}, codes {list(codes.shape)}"
              + (f", {seg[0].numel()} segments, {rows} rows" if seg else ""),
        err=0.0, ties=0, ms=time_ms(call, iters=iters),
        plain_ms=time_ms(plain, iters=iters),
        library_ms=time_ms(library, iters=iters),
        bound_ms=b_ms, bound_by=b_by)


def _segments(pairs):
    """(starts, offsets, rows) on the card of (start, length) pairs."""
    lens = [n for _, n in pairs]
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return (torch.tensor([s_ for s_, _ in pairs], dtype=torch.int32,
                         device=DEV), torch.tensor(off, device=DEV),
            int(off[-1]))


def pq_adc_edges():
    """pq_adc edge cases, each held bit for bit through the wrapper and at
    every forced variant, two calls bit-equal (`_pq_held`): M 4, 5 (byte
    loads), 8 and 16, K 16 < 256, N 1, codes 0 and K-1 (row 0 all K-1,
    the last row all 0), B 1-5 (queries past the last group of 4),
    segments that are empty, one row long or start at an odd row, and a
    call whose every segment is empty (no launch, [B, 0])."""
    g = torch.Generator(device=DEV).manual_seed(7)
    cases = [(2, 4, 256, 300, None), (1, 5, 256, 77, None),
             (3, 16, 256, 64, None), (2, 8, 16, 500, None),
             (1, 8, 256, 1, None),
             (5, 8, 256, 1000, [(0, 0), (17, 1), (33, 250), (999, 1),
                                (500, 0), (101, 77)]),
             (1, 16, 256, 600, [(3, 40), (599, 1), (1, 300)]),
             (4, 5, 16, 400, [(7, 33), (0, 0), (399, 1), (11, 120)]),
             (1, 4, 256, 90, [(45, 45), (0, 45)])]
    for b_, m, k, n, pairs in cases:
        le = torch.randn(b_, m, k, generator=g, device=DEV)
        ce = torch.randint(0, k, (n, m), generator=g, device=DEV
                           ).to(torch.uint8)
        ce[0] = k - 1
        ce[-1] = 0
        _pq_held(f"edge B{b_} M{m} K{k} N{n} {pairs}", le, ce,
                 _segments(pairs) if pairs else None)
    before = ops.pq_adc.launches
    st, off, rows = _segments([(3, 0), (0, 0)])
    empty = ops.pq_adc(torch.randn(2, 8, 256, device=DEV),
                       torch.zeros(5, 8, dtype=torch.uint8, device=DEV), st,
                       off, rows=rows)
    assert empty.shape == (2, 0) and ops.pq_adc.launches == before
    return len(cases) + 1


def check_pq_adc(lut, pack, seg, flat_lut):
    """pq_adc at a real query's shape (its n_probe-16 lists as segments
    of the IVFPQ index's pack) and at a flat shape (16 queries over every
    code of the pack; not a path shape)."""
    path = _pq_times("n_probe 16 query", lut, pack, seg)
    flat = _pq_times("flat, not a path shape", flat_lut, pack, iters=10)
    return dict(path, shapes=[path, flat])


def paged_forced(q, kp, vp, kv_len, table, splits):
    """The decode_attention_paged kernel at a forced split count, through
    its C entry point (the wrapper always takes the plan); no launch is
    counted."""
    B, H, dh = q.shape
    _, ps, G, _ = kp.shape
    W = table.shape[1]
    out = torch.empty_like(q)
    part = torch.empty(B * G * splits * (H // G) * (dh + 2), device=q.device)
    err = build.entry("decode_attention_paged_" + ops._attention_dtype(q))(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kv_len.data_ptr(),
        table.data_ptr(), B, H, G, dh, ps, W, splits, part.data_ptr(),
        out.data_ptr(), ops._stream(q.device))
    assert err == 0, f"decode_attention_paged at {splits} splits: {err}"
    return out


def paged_cases(label, q, kp, vp, kv_len, table, splits=()):
    """decode_attention_paged against plain at one shape, in f32 (1e-5)
    and in bf16 (2e-2): the wrapper (the plan's splits) and the kernel at
    each forced split count. Returns the number of (case, dtype) pairs."""
    n = 0
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        a = [t.to(dt) for t in (q, kp, vp)]
        want = ref.decode_attention_paged(*a, kv_len, table)
        close(f"decode_attention_paged {label} {dt}",
              ops.decode_attention_paged(*a, kv_len, table), want, tol, tol)
        for sp in splits:
            close(f"decode_attention_paged {label} {dt} at {sp} splits",
                  paged_forced(*a, kv_len, table, sp), want, tol, tol)
        n += 1 + len(splits)
    return n


def check_decode(label, q, kp, vp, kv_len, table):
    """decode_attention_paged at one path shape: kernel against plain in
    q's type (bf16: 2e-2) and in f32 (1e-5); times, the bytes bound of
    what this run's kv_len needs, and SDPA on the gathered K/V."""
    B, H, dh = q.shape
    P, ps, G, _ = kp.shape
    W = table.shape[1]
    err = close(f"decode_attention_paged {label}",
                ops.decode_attention_paged(q, kp, vp, kv_len, table),
                ref.decode_attention_paged(q, kp, vp, kv_len, table),
                2e-2, 2e-2)
    a32 = [t.float() for t in (q, kp, vp)]
    close(f"decode_attention_paged {label} f32",
          ops.decode_attention_paged(*a32, kv_len, table),
          ref.decode_attention_paged(*a32, kv_len, table), 1e-5, 1e-5)
    kv = int(kv_len.clamp(min=0, max=W * ps).sum())
    npg = int(((kv_len.clamp(min=0) + ps - 1) // ps).clamp(max=W).sum())
    esz = q.element_size()
    b_ms, b_by = bound(2 * kv * G * dh * esz + 2 * q.numel() * esz
                       + (npg + B) * 4, 4.0 * kv * H * dh, BF16_FLOPS_S)
    j = torch.arange(W * ps, device=DEV)
    mask = (j[None, :] < kv_len[:, None])[:, None, None, :]

    def library():
        idx = table.long()[:, j // ps] * ps + (j % ps)
        kk = kp.reshape(P * ps, G, dh)[idx].repeat_interleave(H // G, 2)
        vv = vp.reshape(P * ps, G, dh)[idx].repeat_interleave(H // G, 2)
        return F.scaled_dot_product_attention(
            q[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2),
            attn_mask=mask)
    return dict(
        shape=f"{label}: q {list(q.shape)}, pool {list(kp.shape)}, table "
              f"{list(table.shape)}, kv_len {kv_len.tolist()[:4]}, splits "
              f"{ops.decode_paged_split_plan(B, G, W, ps)}, {q.dtype}",
        err=err, ties=0,
        ms=time_ms(lambda: ops.decode_attention_paged(q, kp, vp, kv_len,
                                                      table), iters=50),
        plain_ms=time_ms(lambda: ref.decode_attention_paged(
            q, kp, vp, kv_len, table)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def long_cache_inputs(H, G, dh, g):
    """The long-cache shape of decode_attention_paged (no path runs it):
    4 rows at kv_len 4,096 through 130-entry tables of 32-position pages,
    each row its own shuffled pages of a 520-page bf16 pool."""
    B, W, ps = 4, 130, 32
    P = B * W
    kp, vp = (torch.randn(P, ps, G, dh, generator=g, device=DEV
                          ).to(torch.bfloat16) for _ in range(2))
    q = torch.randn(B, H, dh, generator=g, device=DEV).to(torch.bfloat16)
    table = torch.randperm(P, generator=g, device=DEV).to(torch.int32
                                                          ).view(B, W)
    kv_len = torch.full((B,), 4096, dtype=torch.int32, device=DEV)
    return q, kp, vp, kv_len, table


def paged_edges(H, G, dh):
    """Edge cases of decode_attention_paged, each in f32 and bf16 through
    the wrapper and at forced split counts (1, several, one split per
    table entry): reduced grouping (Hg 2, ps 16) with kv_len 0 / 1 / page
    end / W*ps over tables that repeat, reverse and point tail entries at
    page 0; qwen2.5's grouping over 18-entry tables at kv_len 0, 1, a
    page end and past W*ps; Hg 16 at dh 128 (Hg*dh 2048); pages of 24
    positions, so a 64-position tile spans pages, at dh 80. Returns the
    number of (case, dtype, split count) triples checked."""
    g = torch.Generator(device=DEV).manual_seed(3)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=DEV)

    def ints(*x):
        return torch.tensor(x, dtype=torch.int32, device=DEV)
    rev = torch.arange(17, -1, -1, dtype=torch.int32, device=DEV)
    tail = torch.cat([ints(5, 9, 2), torch.zeros(15, dtype=torch.int32,
                                                  device=DEV)])
    cases = [
        ("Hg 2, ps 16", (4, 4, 2, 32, 8, 16),
         ints(0, 1, 16, 64), ints(3, 1, 0, 0, 2, 5, 7, 1, 4, 4, 6, 0,
                                  7, 6, 5, 4).view(4, 4), (1, 2, 3, 4)),
        ("qwen grouping, W 18", (4, H, G, dh, 24, 32),
         ints(0, 1, 96, 600), torch.stack([rev, tail, rev.flip(0), tail]),
         (1, 2, 7, 18)),
        ("Hg 16, dh 128", (2, 32, 2, 128, 10, 32), ints(300, 17),
         torch.stack([torch.arange(10, dtype=torch.int32, device=DEV),
                      ints(9, 9, 0, 1, 2, 3, 4, 5, 6, 7)]), (1, 3)),
        ("ps 24, dh 80", (3, 8, 2, 80, 12, 24), ints(70, 288, 25),
         torch.stack([torch.arange(12, dtype=torch.int32, device=DEV)
                      .roll(r) for r in (0, 5, 11)]), (1, 4, 12)),
    ]
    n = 0
    for label, (B, H_, G_, dh_, P, ps), kv, tb, splits in cases:
        n += paged_cases(label, rnd(B, H_, dh_), rnd(P, ps, G_, dh_),
                         rnd(P, ps, G_, dh_), kv, tb, splits)
    return n


def _expand(t, rep):
    """[B, S, G, dh] -> [B, G*rep, S, dh], the layout SDPA takes."""
    return t.repeat_interleave(rep, dim=2).transpose(1, 2)


def unmasked_pairs(sq, q_offset, kv_len, window, causal):
    """(query, key) pairs that causal / window / kv_len leave unmasked."""
    qpos = q_offset + np.arange(sq)
    hi = np.minimum(kv_len, qpos + 1) if causal else np.full(sq, kv_len)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq)
    return int(np.clip(hi - lo, 0, None).sum())


def check_flash_prefill(label, q, k, v, *, window=None, q_offset=0,
                        kv_len=None, causal=True, plain_iters=20):
    """flash_prefill at one path shape: kernel against plain in q's type
    (bf16: 2e-2) and in f32 (1e-5); times, and the bound of the work."""
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=kv_len)
    B, Sq, H, dh = q.shape
    Sk, G = k.shape[1], k.shape[2]
    kv = Sk if kv_len is None else min(kv_len, Sk)
    bf16 = q.dtype == torch.bfloat16
    tol = 2e-2 if bf16 else 1e-5
    err = close(f"flash_prefill {label}", ops.flash_prefill(q, k, v, **kw),
                ref.flash_prefill(q, k, v, **kw), tol, tol)
    if bf16:
        a32 = [t.float() for t in (q, k, v)]
        close(f"flash_prefill {label} f32", ops.flash_prefill(*a32, **kw),
              ref.flash_prefill(*a32, **kw), 1e-5, 1e-5)
    esz = q.element_size()
    pairs = unmasked_pairs(Sq, q_offset, kv, window, causal)
    b_ms, b_by = bound((2 * q.numel() + 2 * B * kv * G * dh) * esz,
                       4.0 * dh * H * B * pairs,
                       BF16_FLOPS_S if bf16 else F32_FLOPS_S)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = kpos < kv
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (qpos - kpos < window)
    qq, kk, vv = q.transpose(1, 2), _expand(k, H // G), _expand(v, H // G)
    return dict(
        shape=f"{label}: q {list(q.shape)}, k {list(k.shape)}, window "
              f"{window}, q_offset {q_offset}, kv_len {kv}, {q.dtype}",
        err=err, ties=0,
        ms=time_ms(lambda: ops.flash_prefill(q, k, v, **kw)),
        plain_ms=time_ms(lambda: ref.flash_prefill(q, k, v, **kw),
                         iters=plain_iters),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask)),
        bound_ms=b_ms, bound_by=b_by)


def check_decode_attention(label, q, k, v, kv_len, ring):
    """decode_attention at one path shape: kernel against plain in q's
    type (bf16: 2e-2) and in f32 (1e-5); times, and the bound."""
    B, H, dh = q.shape
    S, G = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    tol = 2e-2 if bf16 else 1e-5
    err = close(f"decode_attention {label}",
                ops.decode_attention(q, k, v, kv_len, ring=ring),
                ref.decode_attention(q, k, v, kv_len, ring=ring), tol, tol)
    if bf16:
        a32 = [t.float() for t in (q, k, v)]
        close(f"decode_attention {label} f32",
              ops.decode_attention(*a32, kv_len, ring=ring),
              ref.decode_attention(*a32, kv_len, ring=ring), 1e-5, 1e-5)
    n = kv_len.long().clamp(max=S)
    n = torch.where(n > 0, n, S)
    esz = q.element_size()
    b_ms, b_by = bound(2 * int(n.sum()) * G * dh * esz + 2 * q.numel() * esz
                       + 4 * B, 4.0 * int(n.sum()) * H * dh,
                       BF16_FLOPS_S if bf16 else F32_FLOPS_S)
    mask = (torch.arange(S, device=q.device)[None, :] < n[:, None])
    mask = mask[:, None, None, :]
    kk, vv = _expand(k, H // G), _expand(v, H // G)
    return dict(
        shape=f"{label}: q {list(q.shape)}, k {list(k.shape)}, kv_len "
              f"{kv_len.tolist()[:4]}..., ring {ring}, {q.dtype}",
        err=err, ties=0,
        ms=time_ms(lambda: ops.decode_attention(q, k, v, kv_len, ring=ring),
                   iters=50),
        plain_ms=time_ms(lambda: ref.decode_attention(q, k, v, kv_len,
                                                      ring=ring)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kk, vv, attn_mask=mask)),
        bound_ms=b_ms, bound_by=b_by)


def attention_edges():
    """Edge cases of the two attention kernels, each in f32 (1e-5, the
    CUDA-core route of flash_prefill) and in bf16 (2e-2, its tensor-core
    route). flash_prefill: dh 32, 64, 80 and 128; Hg 7 (14 heads over 2);
    Sq 1 and Sq 77 (ragged query tiles); window 5 (less than a tile);
    the chunk whose keys past kv_len hold 1e4 (they must get weight
    exactly zero); rows whose every key is masked (kv_len 0, and a window
    past kv_len: the uniform average). decode_attention: kv_len 1, a ring
    with kv_len > S, rows of mixed kv_len (1, 63, 4609 on a 4096-slot
    ring, 0) in one launch, S not a multiple of 64, a shape the plan
    splits at least 8 ways, and a scalar kv_len equal to the same [B]
    one. Returns the number of (case, dtype) pairs checked."""
    g = torch.Generator(device=DEV).manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=DEV)

    def qkv(sq, h, sk, g_, dh):
        return rnd(1, sq, h, dh), rnd(1, sk, g_, dh), rnd(1, sk, g_, dh)
    kc, vc = rnd(1, 96, 2, 64), rnd(1, 96, 2, 64)
    kc[:, 50:] = 1e4
    vc[:, 50:] = 1e4
    flash = [
        ("dh 32, Sq 77", (rnd(2, 77, 4, 32), rnd(2, 77, 2, 32),
                          rnd(2, 77, 2, 32)), dict()),
        ("dh 80, window 5", qkv(100, 8, 100, 2, 80), dict(window=5)),
        ("dh 80, Sq 77, window 40", qkv(77, 32, 77, 8, 80),
         dict(window=40)),
        ("dh 64, Hg 7, chunk, 1e4 past kv_len",
         (rnd(1, 10, 14, 64), kc, vc), dict(q_offset=40, kv_len=50)),
        ("dh 64, Hg 7", qkv(130, 14, 130, 2, 64), dict()),
        ("dh 64, Sq 1", qkv(1, 14, 50, 2, 64), dict(q_offset=49)),
        ("dh 128, not causal", qkv(40, 4, 40, 4, 128), dict(causal=False)),
        ("dh 128, Sq 77", qkv(77, 8, 200, 2, 128), dict(q_offset=123)),
        ("kv_len 0", qkv(70, 4, 90, 2, 64), dict(kv_len=0)),
        ("every key masked", qkv(40, 4, 100, 2, 64),
         dict(q_offset=60, window=8, kv_len=20)),
    ]
    n = 0
    for label, (q, k, v), kw in flash:
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            a = [t.to(dt) for t in (q, k, v)]
            close(f"flash_prefill edge {label} {dt}",
                  ops.flash_prefill(*a, **kw), ref.flash_prefill(*a, **kw),
                  tol, tol)
            n += 1

    def lens(*x):
        return torch.tensor(x, dtype=torch.int32, device=DEV)
    decode = [
        ("kv_len 1", (4, 4, 40, 2, 32), lens(1, 1, 1, 1), False),
        ("ring", (4, 4, 40, 2, 32), lens(1, 17, 40, 63), True),
        ("mixed kv_len on a 4096 ring", (4, 32, 4096, 8, 80),
         lens(1, 63, 4609, 0), True),
        ("S 1000", (3, 14, 1000, 2, 64), lens(1000, 999, 70), False),
        ("64 splits", (1, 8, 8192, 1, 128), lens(8000), False),
    ]
    for label, (B, H, S, G, dh), kv, ring in decode:
        q, k, v = rnd(B, H, dh), rnd(B, S, G, dh), rnd(B, S, G, dh)
        if label == "64 splits":
            assert ops.decode_split_plan(B, G, S) >= 8
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            a = [t.to(dt) for t in (q, k, v)]
            close(f"decode_attention edge {label} {dt}",
                  ops.decode_attention(*a, kv, ring=ring),
                  ref.decode_attention(*a, kv, ring=ring), tol, tol)
            n += 1
    qd, kd, vd = rnd(4, 4, 32), rnd(4, 40, 2, 32), rnd(4, 40, 2, 32)
    assert torch.equal(ops.decode_attention(qd, kd, vd, 17),
                       ops.decode_attention(qd, kd, vd, lens(17, 17, 17, 17))
                       ), \
        "decode_attention: a scalar kv_len differs from the same [B] one"
    return n + 1


# ------------------------------------------------------------- profile


def _device_events(prof):
    """(name, device µs) of every kernel the profiler saw on the GPU."""
    out = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.key, e.self_device_time_total, e.count))
    return out


def _profiled(fn, n):
    """torch.profiler over n calls of fn: wall and device ms per call,
    the device's idle share, and the device kernels and host ops that
    take the most time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    dev = _device_events(prof)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    busy = sum(t for _, t, _ in dev) / n / 1e3
    return {
        "wall_ms": wall, "device_ms": busy or None,
        "device_idle_share": (1 - busy / wall) if busy else None,
        "top_device_kernels": [
            {"name": k[:60], "ms_per_call": t / n / 1e3, "calls": c}
            for k, t, c in sorted(dev, key=lambda e: -e[1])[:6]],
        "top_host_ops": [
            {"name": e.key[:60], "ms_per_call": e.self_cpu_time_total / n
             / 1e3, "calls": e.count} for e in host[:6]],
    }


def profile_phase(slm, prompts, kernel_calls):
    """torch.profiler over steady decode steps of the main path's engine
    (4 slots decoding) and over each kernel wrapper alone: device busy
    share of a step, the kernels that take its device time, and each
    port kernel's device time per call (without the host launch cost
    that the CUDA-event loop of phase 5 includes)."""
    eng = slm.engine
    for p in prompts:
        eng.submit(p, 40)
    started = set()
    while len(started) < len(prompts) and eng.pending:
        started |= {ev.rid for ev in eng.step() if ev.kind == "token"}
    step = _profiled(eng.step, 8)
    while eng.pending:
        eng.step()
    per_kernel = {}
    for name, call in kernel_calls.items():
        per_kernel[name] = _profiled(call, 20)["device_ms"]
    return {"decode_step": step, "kernel_device_ms": per_kernel}


def profile_wave(eng, prompts, steps=4):
    """A wave's prefill and decode steps under the profiler (the wave
    has run once before, so nothing compiles or allocates cold)."""
    toks = torch.tensor(np.stack(prompts), dtype=torch.long, device=DEV)
    prefill = _profiled(lambda: eng.model.prefill(toks), 1)
    logits, cache = eng.model.prefill(toks)
    cache = eng._grow_cache(cache)
    tok = ref.first_argmax(logits.float(), -1)[:, None]
    pos = iter(range(toks.shape[1], toks.shape[1] + steps))
    decode = _profiled(lambda: eng.model.decode_step(cache, tok, next(pos)),
                       steps)
    return {"prefill": prefill, "decode_step": decode}


# ------------------------------------------------------------- phases


def drive(path, fn):
    """Run one path with every launch count zeroed just before and read
    just after; each kernel of the path must have launched."""
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    missing = [n for n in PATH_KERNELS[path] if counts[n] == 0]
    assert not missing, f"kernels not launched on the {path} path: {missing}"
    print(f"launches on the {path} path:", json.dumps(counts))
    return out, counts


def check_tokens(results, max_new, vocab):
    for r in results:
        assert r is not None, "a request did not complete"
        assert 1 <= len(r.tokens) <= max_new
        assert all(0 <= t < vocab for t in r.tokens)


def wave_summary(results):
    """TTFT p50 over requests, and decode tok/s: the tokens after each
    request's first over the summed decode time of the waves (requests
    of one prompt length share a wave and its times)."""
    waves = {r.prompt_len: r for r in results}
    ttft = sorted(r.prefill_s for r in results)
    return {"waves": len(waves), "requests": len(results),
            "ttft_p50_s": ttft[len(ttft) // 2],
            "prefill_s_total": sum(r.prefill_s for r in waves.values()),
            "decode_tok_s": sum(len(r.tokens) - 1 for r in results)
            / sum(r.decode_s for r in waves.values()),
            "tokens": sum(len(r.tokens) for r in results)}


def h2o_inputs(lm, prompt):
    """Layer 0's q, k, v of `prompt` ([1, S] tokens) and the ring cache of
    its prefill: real inputs of the two kernels at h2o's wave shapes."""
    cfg = lm.cfg
    S = prompt.shape[1]
    with torch.no_grad():
        y = L.rmsnorm(lm._embed(prompt), lm.attn_norm[0], cfg.norm_eps)
        q, k, v = lm._qkv(0, y, torch.arange(S, device=DEV)[None])
    _, cache = lm.prefill(prompt)
    return q, k, v, cache["k"][0].contiguous(), cache["v"][0].contiguous()


def _windows(sents):
    cfg = SCRConfig()
    return sliding_windows(sents, cfg.sliding_window_size, cfg.overlap_size)


def legacy_windows(answer, docs, embed, question):
    """The [1, NW, d] windows and [1, d] query that the legacy path's
    `apply_scr` scored for one answer (its docs in retrieval order)."""
    order = answer.scr.order
    ids = [answer.doc_ids[order.index(j)] for j in range(len(order))]
    win_texts = []
    for i in ids:
        sents = split_sentences(docs[i])
        win_texts += [" ".join(sents[a:b]) for a, b in _windows(sents)]
    w = torch.tensor(embed(win_texts)[None], device=DEV)
    return w, torch.tensor(embed([question]), device=DEV)


def run_baselines(base, queries):
    """Build the four IVF baselines through `make_index` and search every
    query at k 10 and each probe width: build s, per-query host wall
    times, ids and dists, and the search stats."""
    n_clusters = len(base) // 256          # benchmarks/common.py's rule
    out = {}
    for name in BASELINES:
        kw = dict(n_clusters=n_clusters, device=DEV)
        if "PQ" in name:
            kw["m_pq"] = M_PQ
        t0 = time.perf_counter()
        k0 = ops.kmeans_assign.launches
        idx = make_index(name, base.shape[1], **kw).build(base)
        torch.cuda.synchronize()
        runs = {"build_s": time.perf_counter() - t0,
                "kmeans_launches": ops.kmeans_assign.launches - k0}
        for n_probe in N_PROBES:
            idx.stats.reset()
            ids, dists, times = [], [], []
            for q in queries:
                t = time.perf_counter()
                i, d_ = idx.search(q, k=10, n_probe=n_probe)
                times.append(time.perf_counter() - t)
                ids.append(i)
                dists.append(d_)
            runs[n_probe] = dict(ids=ids, dists=dists, times=times,
                                 disk_loads=idx.stats.disk_loads,
                                 disk_bytes=idx.stats.disk_bytes,
                                 distance_ops=idx.stats.distance_ops)
        out[name] = (idx, runs)
    return out


def exact_top10(base, queries):
    """Exact ground truth: plain f32 distances on the card, top 10."""
    x = torch.tensor(base, device=DEV)
    q = torch.tensor(queries, device=DEV)
    d2 = ((q * q).sum(1)[:, None] - 2.0 * q @ x.T
          + (x * x).sum(1)[None, :])
    return torch.topk(d2, 10, largest=False).indices.cpu().numpy()


def rescore_pq(idx, queries, runs, gt):
    """Every query of a PQ index re-scored on the host with numpy's own
    sum, the reference's `tabs[arange(m)[None], codes].sum(axis=1)`, over
    the probed lists' codes (`probed_codes`): the kernel path's top-10 ids
    must be equal and its distances bit-equal (F9: no tie allowance).
    Beside it, the parent tree's order, sums in m order from 0 (what its
    kernel added): that order's recall@10 / @1 against `gt`, and each
    query whose top 10 it changes, with the ids that differ."""
    m = idx.pq.m
    m_order = {}
    for n_probe in N_PROBES:
        r = runs[n_probe]
        hits10 = hits1 = 0
        swaps = []
        for qi, (q, got, got_d) in enumerate(zip(queries, r["ids"],
                                                 r["dists"])):
            ids, codes = idx.probed_codes(q, n_probe)
            v = idx.pq.adc_table(q)[np.arange(m)[None, :],
                                    codes.astype(np.int64)]
            s = v.sum(axis=1)
            order = np.argsort(s)[:10]
            assert np.array_equal(got, ids[order]), \
                f"{idx.name}: pq_adc ids differ from numpy's sums"
            assert np.array_equal(got_d.view(np.int32),
                                  s[order].view(np.int32)), \
                f"{idx.name}: pq_adc distances differ from numpy's sums"
            seq = np.zeros(len(ids), np.float32)
            for j in range(m):
                seq += v[:, j]
            top = ids[np.argsort(seq)[:10]]
            hits10 += len(set(top.tolist()) & set(gt[qi].tolist()))
            hits1 += int(top[0] == gt[qi][0])
            if not np.array_equal(top, got):
                swaps.append([qi, sorted(set(top.tolist())
                                         ^ set(got.tolist()))])
        m_order[f"n_probe {n_probe}"] = {
            "recall_at_10": hits10 / (10 * len(queries)),
            "recall_at_1": hits1 / len(queries), "queries_swapped": swaps}
    return {"queries_equal_to_numpy": len(N_PROBES) * len(queries),
            "parent_m_order": m_order}


def stacked_search(idx, q, n_probe):
    """The parent tree's PQ search path on this tree's kernel: the probed
    lists' ids and codes stacked on the host (`probed_codes`: IVFPQ id by
    id from its codes dict, IVFPQ-DISK its loaded lists), the table and
    the codes copied from pageable memory, one flat launch, the scores
    back with `.cpu()` (`adc_scores`). Returns the top-10 ids."""
    ids, codes = idx.probed_codes(q, n_probe)
    return ids[np.argsort(idx.pq.adc_scores(q, codes))[:10]]


def stacked_search_ms(idx, queries, runs):
    """`stacked_search` per query at each probe width: its host-clock p50
    in ms, and its results equal to the pack path's (`runs`)."""
    out = {}
    for n_probe in N_PROBES:
        times = []
        for q, want in zip(queries, runs[n_probe]["ids"]):
            t = time.perf_counter()
            ids = stacked_search(idx, q, n_probe)
            times.append(time.perf_counter() - t)
            assert np.array_equal(ids, want), idx.name
        out[n_probe] = float(np.median(times) * 1e3)
    return out


def _index_add_sums(x, assign, k):
    """The port's Lloyd sums before the fixed-order update: `index_add_`,
    which adds with atomics in no fixed order on CUDA (the F8 yardstick)."""
    idx = assign.long()
    sums = torch.zeros(k, x.shape[1], device=x.device).index_add_(0, idx, x)
    return sums, torch.bincount(idx, minlength=k)


def _timed_lloyd(xt, init, iters):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cent, assign = lloyd(xt, init.to(xt.device), iters)
    torch.cuda.synchronize()
    return cent, assign, time.perf_counter() - t0


def kmeans_determinism(label, x, k, seed=0, iters=10):
    """F8: the k-means of `label` (k-means++ from `seed`, `iters` Lloyd
    iterations, as the builds run it) twice on the card: the two builds
    must be equal bit for bit. Then the card build's steps one at a time
    against the CPU's plain versions from the same centroids: each
    step's assignment equals the plain one (`ref.kmeans_assign` on the
    CPU) except at ties within 1e-4, and its cluster counts equal the
    CPU's `cluster_sums` on the same assignment and its sums within 1e-6
    (whether they are equal bit for bit is reported); stepping this way
    must reach the build's centroids. Reported beside them: a whole build
    on the CPU against the card's (a tie decided the other way in an
    early step moves a point, and the later steps carry that on), and, as
    a yardstick, two card builds with the `index_add_` update."""
    init = torch.tensor(kmeans_pp_init(x, k, seed))
    xt = torch.tensor(x, device=DEV)
    c1, a1, s1 = _timed_lloyd(xt, init, iters)
    c2, a2, s2 = _timed_lloyd(xt, init, iters)
    assert torch.equal(c1, c2) and torch.equal(a1, a2), \
        f"k-means {label}: two card builds differ"
    xc = xt.cpu()
    cent, ties, sums_equal, sums_diff = init.to(DEV), 0, True, 0.0
    for i in range(iters):
        a_card, _ = ops.kmeans_assign(xt, cent)
        a_cpu, _ = ref.kmeans_assign(xc, cent.cpu())
        d2 = ((xt * xt).sum(1)[:, None] - 2.0 * xt @ cent.T
              + (cent * cent).sum(1)[None, :])
        ties += same_or_tied(
            f"k-means {label} step {i}, card vs CPU", a_card, a_cpu.to(DEV),
            lambda ids: d2.gather(1, ids.long()[:, None])[:, 0], 1e-4, 1e-4)
        s_card, n_card = cluster_sums(xt, a_card, k)
        s_cpu, n_cpu = cluster_sums(xc, a_card.cpu(), k)
        assert torch.equal(n_card.cpu(), n_cpu), f"k-means {label}: counts"
        close(f"k-means {label} step {i} sums", s_card.cpu(), s_cpu, 1e-6,
              1e-6)
        sums_equal &= bool(torch.equal(s_card.cpu(), s_cpu))
        sums_diff = max(sums_diff, (s_card.cpu() - s_cpu).abs().max().item())
        cent, _ = lloyd(xt, cent, 1)
    assert torch.equal(cent, c1), f"k-means {label}: steps left the build"
    cc, ac = lloyd(xc, init, iters)
    fixed_sums = kmeans_mod.cluster_sums
    kmeans_mod.cluster_sums = _index_add_sums
    try:
        y1, b1, t1 = _timed_lloyd(xt, init, iters)
        y2, b2, t2 = _timed_lloyd(xt, init, iters)
    finally:
        kmeans_mod.cluster_sums = fixed_sums
    return {
        "shape": [len(x), x.shape[1]], "clusters": k, "iters": iters,
        "card_builds_bit_equal": True, "build_s": [s1, s2],
        "steps_tied_assign_diff": ties,
        "steps_sums_bit_equal_cpu": sums_equal,
        "steps_sums_max_abs_diff": sums_diff,
        "cpu_build_centroids_bit_equal": bool(torch.equal(c1.cpu(), cc)),
        "cpu_build_centroid_max_abs_diff": (c1.cpu() - cc).abs().max().item(),
        "cpu_build_assign_diff": int((a1.cpu() != ac).sum()),
        "index_add_builds_bit_equal": bool(torch.equal(y1, y2)
                                           and torch.equal(b1, b2)),
        "index_add_centroid_max_abs_diff": (y1 - y2).abs().max().item(),
        "index_add_assign_diff": int((b1 != b2).sum()),
        "index_add_build_s": [t1, t2],
    }, c1


def word_corpus(n_docs, seed):
    """Random-word documents: no two SCR windows share a bag of words,
    so the small-input comparison has no ties decided by rounding."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    return [" ".join(" ".join(rng.choice(vocab, 7)).capitalize() + "."
                     for _ in range(12)) for _ in range(n_docs)]


def small_input_agreement():
    """The pipeline on the GPU against its plain versions on the CPU:
    float32 reduced models, same random weights. MobileRAG end to end;
    the qwen2.5 wave path (and, on the GPU, its continuous engine) on the
    bucketed prompts; the h2o wave path on an 80-token prompt, past its
    64-slot window."""
    docs = word_corpus(200, seed=11)
    queries = [docs[i].split(". ")[2 + i % 5] for i in range(3, 200, 33)]
    cfg = get_config("qwen25_0_5b").reduced(dtype="float32")
    gpu = MobileRAG(docs, HashEmbedder(dim=64), top_k=3, gen_config=cfg,
                    seed=5, device=DEV)
    on_gpu = gpu.answer_batch(queries, generate=True, max_new=8)
    weights = {n: p.detach().cpu() for n, p in
               gpu.slm.model.named_parameters()}
    cpu = MobileRAG(docs, HashEmbedder(dim=64), top_k=3, gen_config=cfg,
                    gen_params=weights, device="cpu")
    on_cpu = cpu.answer_batch(queries, generate=True, max_new=8)
    for a, b in zip(on_gpu, on_cpu):
        assert a.doc_ids == b.doc_ids, (a.doc_ids, b.doc_ids)
        assert a.prompt == b.prompt
        assert a.gen_tokens == b.gen_tokens, (a.gen_tokens, b.gen_tokens)
    # the legacy SCR path, GPU against CPU, and against the window index
    legacy = [MobileRAG(docs, HashEmbedder(dim=64), top_k=3, gen_config=cfg,
                        gen_params=weights, use_window_index=False,
                        device=d).answer_batch(queries, generate=True,
                                               max_new=8)
              for d in (DEV, "cpu")]
    for a, b, w in zip(*legacy, on_gpu):
        assert a.doc_ids == b.doc_ids == w.doc_ids, (a.doc_ids, b.doc_ids)
        assert a.prompt == b.prompt == w.prompt
        assert a.gen_tokens == b.gen_tokens, (a.gen_tokens, b.gen_tokens)
    prompts = [gpu.slm.encode_prompt(a.prompt, bucket=True) for a in on_gpu]
    wave_gpu = gpu.slm.wave.generate(prompts, max_new=8, continuous=False)
    wave_cpu = cpu.slm.wave.generate(prompts, max_new=8, continuous=False)
    cont_gpu = gpu.slm.wave.generate(prompts, max_new=8)
    for w, c, e in zip(wave_gpu, wave_cpu, cont_gpu):
        assert w.tokens == c.tokens, ("wave GPU vs CPU", w.tokens, c.tokens)
        assert w.tokens == e.tokens, ("wave vs continuous", w.tokens,
                                      e.tokens)
    hcfg = H2O_CONFIG.reduced(dtype="float32")
    h_gpu = DenseLM(hcfg, device=DEV, seed=3)
    h_cpu = DenseLM(hcfg, device="cpu", params={
        n: p.detach().cpu() for n, p in h_gpu.named_parameters()})
    prompt = [np.random.default_rng(13).integers(4, 500, 80).astype(np.int32)]
    assert cache_len(hcfg, 80) == 64 < 80
    t_gpu = Engine(h_gpu, max_len=96).generate(prompt, 8, continuous=False)
    t_cpu = Engine(h_cpu, max_len=96).generate(prompt, 8, continuous=False)
    assert t_gpu[0].tokens == t_cpu[0].tokens, (t_gpu[0].tokens,
                                                t_cpu[0].tokens)
    return len(queries)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    build_s = build.build_all()
    print(f"kernel build: {build_s:.2f} s nvcc "
          f"({time.perf_counter() - t0:.2f} s with loading)")
    dev = DEV

    # ---- main path
    corpus = make_qa_corpus(n_docs=N_DOCS, n_questions=16,
                            sentences_per_doc=12, seed=0)
    questions = [e.question for e in corpus.examples]
    embed = HashEmbedder(dim=384)
    sink = TraceSink()

    def main_path():
        t0 = time.perf_counter()
        pipe = MobileRAG(corpus.docs, embed, top_k=3, gen_config=GEN_CONFIG,
                         seed=0, trace=sink, device=DEV)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        answers = pipe.answer_batch(questions, generate=True,
                                    max_new=MAX_NEW)
        torch.cuda.synchronize()
        return pipe, answers, t1 - t0, time.perf_counter() - t1
    (pipe, answers, build_wall, wall), launches = drive("main", main_path)
    slm = pipe.slm
    vocab = slm.cfg.vocab_padded
    for a in answers:
        assert a is not None, "a request did not complete"
        assert 1 <= len(a.gen_tokens) <= MAX_NEW
        assert all(0 <= t < vocab for t in a.gen_tokens)
        assert len(a.doc_ids) == 3 and a.prompt.startswith("Context:")
    data, lens, _, cap = pipe.index.device_pack()
    wdata, wlens = pipe.window_index.pack()
    steps = sink.durations("engine", "decode_step")
    active = [r.attrs["active"] for r in sink.query(comp="engine",
                                                    name="decode_step")
              if r.ph == "B"]
    ttft = sorted(a.ttft_measured_s for a in answers)
    main = {
        "docs": len(corpus.docs), "questions": len(questions),
        "clusters": int(data.shape[0]), "cap": int(cap),
        "ecovector_pack_mb": data.nbytes / 2**20,
        "window_pack": list(wdata.shape), "window_pack_mb": wdata.nbytes / 2**20,
        "build_s": build_wall, "index_build_s": pipe.build_s,
        "window_build_s": pipe.scr_build_s, "answer_wall_s": wall,
        "ttft_p50_s": ttft[len(ttft) // 2],
        "decode_tok_s": sum(active) / sum(steps),
        "decode_steps": len(steps),
        "tokens": sum(len(a.gen_tokens) for a in answers),
        "prefix_hits": slm.engine.prefix_hits,
    }
    print("main path:", json.dumps(main))

    # ---- legacy SCR path: the same pipeline without the window index
    legacy_sink = TraceSink()

    def legacy_path():
        t0 = time.perf_counter()
        lpipe = MobileRAG(corpus.docs, embed, top_k=3, use_window_index=False,
                          gen_config=GEN_CONFIG, seed=0, trace=legacy_sink,
                          device=DEV)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = lpipe.answer_batch(questions, generate=True, max_new=MAX_NEW)
        torch.cuda.synchronize()
        return out, t1 - t0, time.perf_counter() - t1
    (legacy, l_build, l_wall), legacy_launches = drive("legacy", legacy_path)
    assert legacy_launches["scr_score"] >= len(questions), legacy_launches
    for a in legacy:
        assert 1 <= len(a.gen_tokens) <= MAX_NEW
        assert all(0 <= t < vocab for t in a.gen_tokens)
        assert len(a.doc_ids) == 3 and a.prompt.startswith("Context:")
    l_steps = legacy_sink.durations("engine", "decode_step")
    l_active = [r.attrs["active"] for r in legacy_sink.query(
        comp="engine", name="decode_step") if r.ph == "B"]
    l_ttft = sorted(a.ttft_measured_s for a in legacy)
    legacy_info = {
        "build_s": l_build, "answer_wall_s": l_wall,
        "ttft_p50_s": l_ttft[len(l_ttft) // 2],
        "decode_tok_s": sum(l_active) / sum(l_steps),
        "scr_score_launches": legacy_launches["scr_score"],
        "post_s_mean": float(np.mean([a.post_s for a in legacy])),
        "window_index_post_s_mean": float(np.mean([a.post_s
                                                   for a in answers])),
        # reported, not asserted: both pipelines build the same EcoVector
        # (k-means is the same on every run, the F8 phase), so their doc
        # sets differ only if retrieval does
        "same_doc_set_share": float(np.mean([
            set(a.doc_ids) == set(b.doc_ids)
            for a, b in zip(legacy, answers)])),
        "windows_per_query_mean": float(np.mean([
            sum(len(_windows(split_sentences(corpus.docs[i])))
                for i in a.doc_ids) for a in legacy])),
    }
    print("legacy SCR path:", json.dumps(legacy_info))
    w_leg, q_leg = legacy_windows(legacy[0], corpus.docs, embed, questions[0])

    # ---- wave path, same model, the 16 prompts in 32-token buckets
    prompts = [slm.encode_prompt(a.prompt, bucket=True) for a in answers]
    wave, wave_launches = drive("wave", lambda: slm.wave.generate(
        prompts, max_new=MAX_NEW, continuous=False))
    check_tokens(wave, MAX_NEW, vocab)
    by_len = {}
    for p_ in prompts:
        by_len.setdefault(len(p_), []).append(p_)
    big = max(by_len.values(), key=len)
    print("wave profile:", json.dumps(profile_wave(slm.wave, big)))
    cont = slm.wave.generate(prompts, max_new=MAX_NEW)
    same = sum(a == b for w, c in zip(wave, cont)
               for a, b in zip(w.tokens, c.tokens))
    total = sum(max(len(w.tokens), len(c.tokens)) for w, c in zip(wave, cont))
    wave_info = dict(wave_summary(wave), greedy_equal_share=same / total,
                     bucket_lens=sorted({len(p) for p in prompts}))
    print("wave path:", json.dumps(wave_info))

    # ---- h2o-danube-1.8b at full width, 2 prompts past the window
    h2o = DenseLM(H2O_CONFIG, device=dev, seed=1)
    rng = np.random.default_rng(12)
    hp = [rng.integers(4, H2O_CONFIG.vocab_size, H2O_PROMPT).astype(np.int32)
          for _ in range(2)]
    h2o_eng = Engine(h2o, max_len=H2O_PROMPT + MAX_NEW, eos_id=-1)
    h2o_res, h2o_launches = drive("h2o", lambda: h2o_eng.generate(
        hp, max_new=MAX_NEW, continuous=False))
    check_tokens(h2o_res, MAX_NEW, H2O_CONFIG.vocab_padded)
    ring = cache_len(H2O_CONFIG, H2O_PROMPT + MAX_NEW)
    assert ring == H2O_CONFIG.sliding_window < H2O_PROMPT
    h2o_info = {
        "prompts": len(hp), "prompt_len": H2O_PROMPT, "ring_slots": ring,
        "last_decode_pos": min(H2O_PROMPT + MAX_NEW - 1,
                               h2o_eng.max_len - 1),
        "prefill_s": h2o_res[0].prefill_s, "decode_s": h2o_res[0].decode_s,
        "decode_tok_s": sum(len(r.tokens) - 1 for r in h2o_res)
        / h2o_res[0].decode_s,
        "param_gb": sum(p.numel() * p.element_size()
                        for p in h2o.parameters()) / 1e9,
    }
    print("h2o-danube-1.8b wave path:", json.dumps(h2o_info))
    print("h2o profile:", json.dumps(profile_wave(h2o_eng, hp)))
    hq, hk, hv, hck, hcv = h2o_inputs(h2o, torch.tensor(
        np.stack(hp[:1]), dtype=torch.long, device=dev))
    del h2o, h2o_eng
    torch.cuda.empty_cache()

    # ---- baselines path: IVF / IVFPQ / IVF-DISK / IVFPQ-DISK on SIFT-like
    base, bq = sift_like(n=SIFT_N, nq=SIFT_NQ, d=128, seed=0)
    print(f"baselines: SIFT-like {SIFT_N} x 128 (the paper's SIFT-1M cut "
          f"to {SIFT_N / 1e6:g}x: the host k-means++ seeding is "
          f"O(N * NC * d)), {SIFT_NQ} queries, {SIFT_N // 256} clusters, "
          f"m_pq {M_PQ}, k 10, n_probe {list(N_PROBES)}")
    indexes, base_launches = drive("baselines",
                                   lambda: run_baselines(base, bq))
    n_pq = sum("PQ" in n for n in BASELINES)
    assert base_launches["pq_adc"] == n_pq * len(N_PROBES) * SIFT_NQ, \
        base_launches
    gt = exact_top10(base, bq)
    base_info = {}
    for name, (idx, runs) in indexes.items():
        info = {"build_s": runs["build_s"], "ram_bytes": idx.ram_bytes(),
                "kmeans_launches": runs["kmeans_launches"]}
        for n_probe in N_PROBES:
            r = runs[n_probe]
            assert all(len(i) == 10 for i in r["ids"])
            info[f"n_probe {n_probe}"] = {
                "recall_at_10": float(np.mean([
                    len(set(i.tolist()) & set(g.tolist())) / 10
                    for i, g in zip(r["ids"], gt)])),
                "recall_at_1": float(np.mean([i[0] == g[0]
                                              for i, g in zip(r["ids"], gt)])),
                "search_ms_p50": float(np.median(r["times"]) * 1e3),
                "disk_loads": r["disk_loads"], "disk_bytes": r["disk_bytes"],
                "distance_ops": r["distance_ops"]}
        if "PQ" in name:
            info.update(rescore_pq(idx, bq, runs, gt))
            for n_probe, ms in stacked_search_ms(idx, bq, runs).items():
                info[f"n_probe {n_probe}"]["stacked_search_ms_p50"] = ms
        base_info[name] = info
    print("baselines path:", json.dumps(base_info))
    print("baselines search_ms_p50 (this tree's search; the parent's "
          "stacked search path re-enacted on this tree's kernel):",
          json.dumps({f"{name} n_probe {p_}": [
              info[f"n_probe {p_}"]["search_ms_p50"],
              info[f"n_probe {p_}"].get("stacked_search_ms_p50")]
              for name, info in base_info.items() for p_ in N_PROBES}))
    # ---- F8: k-means builds on the card are the same on every run
    doc_emb = embed(corpus.docs)
    eco_f8, eco_cent = kmeans_determinism(
        "EcoVector partition", doc_emb, pipe.index.n_clusters)
    eco_f8["equals_main_path_build"] = bool(np.array_equal(
        eco_cent.cpu().numpy(), pipe.index.centroids))
    ivf_f8, _ = kmeans_determinism("IVF partition", base, SIFT_N // 256)
    print("k-means determinism (F8):", json.dumps(
        {"EcoVector": eco_f8, "IVF": ivf_f8}))
    ivfpq = indexes["IVFPQ"][0]
    # pq_adc's inputs on this path: one n_probe-16 query's lists as
    # segments of the IVFPQ pack, and (not a path shape) 16 queries'
    # tables over the whole pack
    probes_q = ivfpq._probe(bq[0], max(N_PROBES))
    off_q = ivfpq.pack_offsets
    seg_q = _segments([(int(off_q[c]), int(off_q[c + 1] - off_q[c]))
                       for c in probes_q])
    lut_q = torch.tensor(ivfpq.pq.adc_table(bq[0])[None], device=dev)
    pack = ivfpq.pack
    lut_flat = torch.tensor(np.stack([ivfpq.pq.adc_table(q)
                                      for q in bq[:16]]), device=dev)
    # kmeans_assign's inputs on this path: the IVF partition (all of base
    # against the IVF index's centroids) and the first PQ sub-quantizer
    # (its 4,096-row training sample, as IVFPQ.build draws it, against
    # the trained codebook)
    ivf_x = torch.tensor(base, device=dev)
    ivf_c = torch.tensor(indexes["IVF"][0].centroids, device=dev)
    sample = base[np.random.default_rng(0).choice(
        len(base), min(len(base), 4096), replace=False)]
    dsub = base.shape[1] // M_PQ
    pq_x = torch.tensor(np.ascontiguousarray(sample[:, :dsub]), device=dev)
    pq_c = torch.tensor(ivfpq.pq.codebooks[0], device=dev)
    del indexes, ivfpq

    # ---- kernels against their plain versions, on the paths' inputs
    x = torch.tensor(doc_emb, device=dev)
    cent = torch.tensor(pipe.index.centroids, device=dev)
    qv = torch.tensor(embed(questions[:4]), device=dev)
    d_t, l_t, c_t = pipe.index.device_arrays()
    probes = ref.route_topk(qv, c_t, pipe.n_probe)
    w_t, wl_t = pipe.window_index.device_arrays()
    ids = torch.tensor([a.doc_ids for a in answers[:4]], dtype=torch.int32,
                       device=dev)
    pool = slm.engine.cache
    ps = slm.engine.page_size
    P, W = pool["k"].shape[1], slm.engine.table_width
    H, G, dh = slm.cfg.num_heads, slm.cfg.num_kv_heads, \
        slm.cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(4)
    q_dec = (torch.randn(4, H, dh, generator=g, device=dev)
             ).to(torch.bfloat16)
    table = torch.stack([torch.randperm(P, generator=g, device=dev)[:W]
                         for _ in range(4)]).to(torch.int32)
    plens = [len(slm.encode_prompt(a.prompt)) + len(a.gen_tokens)
             for a in answers[:4]]
    kv_len = torch.tensor(plens, dtype=torch.int32, device=dev)
    # the main path's prefill chunk: 32 queries at q_offset 64 over a
    # slot's gathered W*ps-position buffer
    j = torch.arange(W * ps, device=dev)
    gather = table[0].long()[j // ps] * ps + (j % ps)
    k_slot = pool["k"][0].reshape(P * ps, G, dh)[gather][None]
    v_slot = pool["v"][0].reshape(P * ps, G, dh)[gather][None]
    q_chunk = torch.randn(1, slm.PREFILL_CHUNK, H, dh, generator=g,
                          device=dev).to(torch.bfloat16)
    # the qwen2.5 wave decode: the largest bucket's grown cache
    _, wcache = slm.model.prefill(torch.tensor(np.stack(big), dtype=torch.long,
                                               device=dev))
    wcache = slm.wave._grow_cache(wcache)
    k_wave, v_wave = wcache["k"][0].contiguous(), wcache["v"][0].contiguous()
    q_wave = torch.randn(len(big), H, dh, generator=g, device=dev
                         ).to(torch.bfloat16)
    len_wave = torch.full((len(big),), len(big[0]) + MAX_NEW // 2,
                          dtype=torch.int32, device=dev)
    q_ring = torch.randn(1, H2O_CONFIG.num_heads, H2O_CONFIG.head_dim,
                         generator=g, device=dev).to(torch.bfloat16)
    len_ring = torch.tensor([H2O_PROMPT + 1], dtype=torch.int32, device=dev)
    window = H2O_CONFIG.sliding_window
    flash_shapes = [
        check_flash_prefill("main-path chunk", q_chunk, k_slot, v_slot,
                            q_offset=64, kv_len=64 + slm.PREFILL_CHUNK),
        check_flash_prefill("h2o wave", hq, hk, hv, window=window,
                            plain_iters=3),
    ]
    decode_shapes = [
        check_decode_attention("qwen wave", q_wave, k_wave, v_wave,
                               len_wave, False),
        check_decode_attention("h2o ring", q_ring, hck, hcv, len_ring, True),
    ]
    assert ops.decode_paged_split_plan(4, G, W, ps) > 1
    long_in = long_cache_inputs(H, G, dh, g)
    paged_shapes = [
        check_decode("main path", q_dec, pool["k"][0], pool["v"][0], kv_len,
                     table),
        check_decode("long cache (not a path shape)", *long_in),
    ]
    n_edges = attention_edges() + paged_edges(H, G, dh)
    n_kmeans_edges = kmeans_edges()
    n_pq_edges = pq_adc_edges()
    n_retrieval_edges = ecoscan_edges() + scr_select_edges(w_t)
    eco_scale, eco_bm = ecoscan_scale_inputs(g)
    ecoscan_shapes = [
        check_ecoscan("main path", qv, d_t, l_t, probes, pipe.top_k),
        check_ecoscan("at scale (not a path shape)", *eco_scale),
        check_ecoscan("at scale, masked block_map (not a path shape)",
                      *eco_scale, block_map=eco_bm)]
    eco_launches = kernel_nodes(
        lambda: ops.ecoscan(qv, d_t, l_t, probes, pipe.top_k))
    assert eco_launches == 1, f"ecoscan: {eco_launches} launches a call"
    # top_k 10 over the main path's window pack: the docs EcoVector
    # retrieves for the 16 questions at k 10
    ids10 = torch.tensor(pipe.index.search_device_batched(
        embed(questions), k=10, n_probe=pipe.n_probe)[0], dtype=torch.int32,
        device=dev)
    q10 = torch.tensor(embed(questions), device=dev)
    scr_shapes = [check_scr_select("main path", qv, w_t, wl_t, ids),
                  check_scr_select("top_k 10 (not a path shape)", q10, w_t,
                                   wl_t, ids10)]
    kmeans_shapes = [check_kmeans("EcoVector build", x, cent),
                     check_kmeans("IVF partition", ivf_x, ivf_c),
                     check_kmeans("PQ sub-quantizer", pq_x, pq_c)]
    stream_info = check_current_stream(w_leg, q_leg)
    results = {
        "kmeans_assign": dict(kmeans_shapes[0], shapes=kmeans_shapes),
        "ecoscan": dict(ecoscan_shapes[0], shapes=ecoscan_shapes),
        "scr_select": dict(scr_shapes[0], shapes=scr_shapes),
        "decode_attention_paged": dict(paged_shapes[0], shapes=paged_shapes),
        "flash_prefill": dict(flash_shapes[0], shapes=flash_shapes),
        "decode_attention": dict(decode_shapes[0], shapes=decode_shapes),
        "scr_score": check_scr_score(w_leg, q_leg),
        "pq_adc": check_pq_adc(lut_q, pack, seg_q, lut_flat),
    }
    calls = {
        "kmeans_assign": lambda: ops.kmeans_assign(x, cent),
        "kmeans_assign IVF partition": lambda: ops.kmeans_assign(ivf_x,
                                                                 ivf_c),
        "kmeans_assign PQ sub-quantizer": lambda: ops.kmeans_assign(pq_x,
                                                                    pq_c),
        "ecoscan": lambda: ops.ecoscan(qv, d_t, l_t, probes, pipe.top_k),
        "ecoscan at scale": lambda: ops.ecoscan(*eco_scale),
        "ecoscan at scale, masked": lambda: ops.ecoscan(
            *eco_scale, block_map=eco_bm),
        "scr_select": lambda: ops.scr_select(qv, w_t, wl_t, ids),
        "scr_select top_k 10": lambda: ops.scr_select(q10, w_t, wl_t,
                                                      ids10),
        "decode_attention_paged": lambda: ops.decode_attention_paged(
            q_dec, pool["k"][0], pool["v"][0], kv_len, table),
        "decode_attention_paged long cache":
            lambda: ops.decode_attention_paged(*long_in),
        "flash_prefill": lambda: ops.flash_prefill(
            q_chunk, k_slot, v_slot, q_offset=64,
            kv_len=64 + slm.PREFILL_CHUNK),
        "flash_prefill h2o wave": lambda: ops.flash_prefill(
            hq, hk, hv, window=window),
        "decode_attention": lambda: ops.decode_attention(
            q_wave, k_wave, v_wave, len_wave),
        "decode_attention h2o ring": lambda: ops.decode_attention(
            q_ring, hck, hcv, len_ring, ring=True),
        "scr_score": lambda: ops.scr_score(w_leg, q_leg),
        "pq_adc": lambda: ops.pq_adc(lut_q, pack, seg_q[0], seg_q[1],
                                     rows=seg_q[2]),
    }
    prof = profile_phase(slm, [slm.encode_prompt(a.prompt)
                               for a in answers[:4]], calls)
    print("profile:", json.dumps(prof))
    n_small = small_input_agreement()
    print(f"small input: {n_small} queries agree GPU vs CPU (doc ids, "
          "prompts, greedy tokens; wave tokens, wave = continuous on the "
          "GPU; the legacy SCR pipeline, whose prompts equal the window "
          "index's); reduced h2o wave tokens agree GPU vs CPU")
    print(f"attention edge cases: {n_edges} agree with the plain versions")
    print(f"kmeans_assign edge cases: {n_kmeans_edges} agree with the plain "
          "version")
    print(f"pq_adc edge cases: {n_pq_edges} equal the plain version bit "
          "for bit (through the wrapper and at forced variants "
          f"{PQ_FORCED}), each bit-equal across two calls")
    print(f"ecoscan and scr_select edge cases: {n_retrieval_edges} agree "
          "with the plain versions (ecoscan through the wrapper and at "
          f"tiles {list(ops.ECOSCAN_TILES)}), each bit-equal across two "
          "calls")
    print(f"ecoscan: {eco_launches} kernel launch a call at the main path's"
          " shape (kernel nodes of a CUDA graph of one call)")
    print("current stream:", json.dumps(stream_info))
    sc = results["scr_score"]
    print(f"scr_score launch path: wrapper {sc['ms']:.4f} ms a call, bare "
          f"cached ctypes call {sc['bare_call_ms']:.4f} ms, bmm "
          f"{sc['library_ms']:.4f} ms, device "
          f"{prof['kernel_device_ms']['scr_score']:.5f} ms")
    print("launch path (call ms, profiled device ms):", json.dumps({
        name: [r["ms"], prof["kernel_device_ms"][name]]
        for name, r in results.items()}))
    for name, r in results.items():
        for sh in r.get("shapes", [r]):
            print(f"{name}: kernel {sh['ms']:.4f} ms, plain "
                  f"{sh['plain_ms']:.4f} ms, library {sh['library_ms']:.4f} "
                  f"ms, bound {sh['bound_ms']:.6f} ms ({sh['bound_by']}), "
                  f"{sh['ms'] / sh['library_ms']:.3g}x the library's time, "
                  f"{sh['bound_ms'] / sh['ms']:.3%} of the bound, "
                  f"max abs err {sh['err']:.3g}, ties {sh['ties']}"
                  + (f" [{sh['shape']}]" if "shape" in sh else ""))
    paths = {"main": launches, "wave": wave_launches, "h2o": h2o_launches,
             "legacy": legacy_launches, "baselines": base_launches}
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": sum(c[name] for c in paths.values()),
        "launches_by_path": {p_: c[name] for p_, c in paths.items()},
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "device_ms": prof["kernel_device_ms"][name],
        "shapes": [{k: sh[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                       "bound_ms", "err")}
                   for sh in r.get("shapes", [])]}
        for name, r in results.items()]
    assert len(kernels) == len(ops.KERNELS)
    assert all(k["launches"] > 0 for k in kernels)
    assert all(math.isfinite(k["ms"]) for k in kernels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
