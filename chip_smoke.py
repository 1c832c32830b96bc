#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Phases, any failure exits non-zero (nothing is caught):

1. Print the card (`nvidia-smi` name and power limit) and build the CUDA
   kernels from `src/repro_torch/kernels/csrc/` (timed).
2. The main path: MobileRAG over a 16,384-document synthetic SQuAD-style
   corpus (HashEmbedder at the gte-small width 384: NC = 256 clusters,
   each with its HNSW graph (M 16, efc 100) spilled to disk, a [256,
   CAP, 384] EcoVector pack made from the graphs and a [16384, 10, 384]
   window pack)
   with full-width qwen2.5-0.5B in bf16 (24 layers, random weights from a
   seed), `answer_batch(16 questions, generate=True, max_new=16)` through
   4 slots; the chunked prefill runs `flash_prefill`. The retrieval and
   SCR fallbacks count what they absorb: at the end of the run every
   clean path's pipeline (main, legacy, host search, sampled, window
   updates) has counted zero, and no session of a clean path has counted
   a failure or a retry (every RagSession of the run is recorded).
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
   five shapes of its paths (the EcoVector build's, the IVF partition's
   and a PQ sub-quantizer's, on the baselines' own data; the graph
   baselines' partition and HNSWPQ's sub-quantizer) and its edge cases
   (`kmeans_edges`); ecoscan also on the pack the updates grew. pq_adc
   equals its plain version bit for bit (both sum in numpy's order),
   through the wrapper and at forced
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
   the continuous engine's on the GPU; the float32 reduced h2o on an
   80-token prompt (its 64-slot ring wraps), the same wave tokens on both;
   and the four paged families (`small_families_agreement`: sliding
   window with an 80-token prompt beside a 20-token one, int8 KV,
   sliding window + int8, MoE), each through `Engine` waves and the
   continuous engine: GPU tokens equal CPU tokens, wave equal continuous.
7. torch.profiler windows over steady decode steps of the main path,
   over a wave's prefill and decode steps (qwen2.5 and h2o; device busy
   and idle share, the kernels and host ops that take the time) and over
   each kernel wrapper alone (device time per call).

More paths run after phase 4, and their kernels join phases 5-7 (the
int8 decode kernels at their paths' shapes and their edge cases,
`q8_edges`, with the library's way: dequantize in torch, then SDPA; the
float attention kernels also at these paths' shapes: flash_prefill on
h2o's last ring chunk, its buffer re-materialized from layer 0's pool
as `prefill_chunk_paged` builds it (`chunk_buffer`), and on a MoE chunk;
decode_attention_paged over h2o's 128-page ring rows at kv_len 4,096 and
over the MoE pool; decode_attention on the MoE wave's cache); then
the F8 phase: the EcoVector partition (the main path's 16,384
embeddings into 256 clusters) and the IVF partition (100,000 x 128 into
390) each k-means'd twice on the card, bit for bit equal, and stepped
against the CPU's plain versions from the same centroids: assignments
equal except at ties within 1e-4, cluster sums equal (`kmeans_
determinism`; a whole CPU build and two card builds with the
`index_add_` update the port had before are reported beside them):
- the int8 path (after the wave path): the main path's qwen2.5 weights
  with `kv_quant`, the 16 bucketed prompts on waves and on the
  continuous engine (`decode_attention_q8`, `decode_attention_paged_q8`):
  tok/s, TTFT, the pool's bytes a position, kv head and tensor against
  bf16's, and the share of tokens equal between paths and to bf16's;
- the MoE path: full-width granite-moe-1b-a400m (32 experts top 8,
  random weights from a seed), 16 prompts of the wave's bucketed lengths,
  waves and the continuous engine, and a profiled steady decode step;
- h2o continuous and h2o int8 (after phase 4): the same h2o model and
  prompts on the continuous engine (ring pages: a 4,096-position ring
  over 128 pages a slot), then its weights with `kv_quant` on waves and
  the continuous engine; ring_len, table width and pool bytes, TTFT,
  tok/s and the token shares;
- the legacy SCR path: the main path's pipeline, on its index
  (`index=pipe.index`), with `use_window_index=False`, so each query re-embeds its retrieved
  documents' windows and scores them with `scr_score` (one launch per
  query), beside the window-index path's SCR time;
- the host search (after the legacy path): the main path's index
  searched on the host (route on the centroid graph, each probed
  cluster's graph loaded from disk, searched, merged) for the 16
  questions and 200 corpus queries at k 10: exactly n_probe disk loads a
  query (asserted: no cache, the partial-loading contract), disk bytes,
  search ms p50, recall@3 and @10 against exact search over the pack,
  top-3 sets equal to the device path's, `ram_bytes` beside the device
  tensors' and `disk_bytes`, the build split (k-means / centroid graph /
  graphs / pack); `MobileRAG(index=..., device_retrieval=False)` answers
  the 16 questions (legacy SCR), its doc sets beside the main path's
  (reported);
- the graph baselines (after the IVF baselines): HNSW, HNSWPQ, IVF-HNSW
  and EcoVector through `make_index` over the first N_G (6,000) of the
  same SIFT-like vectors (M 12, efc 60, 23 clusters, m_pq 8; the cut is
  printed under `reduced`): build s, search ms p50, recall@10 and @1
  against exact search, `ram_bytes`, disk bytes and loads, at ef 64 or
  n_probe 4 and 16; `kmeans_assign` runs in HNSWPQ's PQ training and the
  two partitions;
- the updates (after phase 7, the last user of the main path's index):
  two rounds of 128 inserts (perturbed corpus vectors, new ids) and 128
  deletes (32 re-inserted); the first stays inside CAP, the second
  overflows one cluster. After each round's device query: the device
  tensors equal the host pack bit for bit, without growth only the dirty
  blocks were copied (counted, nothing uploaded whole), with growth the
  pack grew and was uploaded once; `search_device_batched` returns the
  ids of plain `route_topk` + `ecoscan` on the same tensors (ties within
  2e-5 excepted); inserted vectors are found, deleted ids never
  returned; then ecoscan is held against its plain version on the grown
  pack;
- the sampled path (after phase 7): on the main path's pipeline, the 16
  questions through `pipe.session(greedy=False, seed=SAMPLE_SEED)`
  twice, each on a fresh engine (doc ids, prompts and tokens equal);
  one sampled request (rid 100) alone and beside 1 and 3 co-residents
  (tokens equal); the 16 bucketed prompts sampled on waves and on the
  continuous engine (the equal share reported: bf16). Then the draw on
  the card: `random_bits` of a [4, 151,936] draw equal to the CPU's bit
  for bit, `gumbel` within 2 ulp of max(|g|, 1); 20,000 draws of one
  16-way row, each frequency within 5 sigma of softmax; the draw's wall
  and device ms a call, and a decode step's wall and device ms sampled
  against greedy (fresh engines, in turns). The small-input phase also
  holds sampled sessions and sampled waves GPU = CPU, and sampled waves
  = continuous;
- the window-updates path (after the sampled path): 64 documents
  appended to the main path's corpus (`pipe.docs.append`,
  `pipe.index.insert`), 16 of them asked about through
  `answer_batch(generate=True)` with every cluster probed, which adds
  them to the window index (its rows double: one whole upload): each
  document retrieved and its marker in the prompt (the share found at
  n_probe 4 is reported: an insert routes on the centroid graph); then
  32 updates and 16 removes through the window index: only those rows
  copied, into the same storage; then one long document doubles CAPW
  (one whole upload) and scr_select at the new CAPW is held to its plain
  version at 1e-5. The device pack equals the host pack bit for bit
  after each refresh;
- the baselines path: IVF, IVFPQ, IVF-DISK and IVFPQ-DISK over 100,000
  SIFT-like vectors (128-d, 390 clusters, m_pq 8), 200 queries at k 10
  and n_probe 4 and 16, recall@10 against an exact search on the card;
  the PQ indexes score each query with one `pq_adc` launch (IVFPQ: its
  probed lists as segments of its device pack), and every query's ids
  and distances equal numpy's own sums on the host bit for bit (F9); each
  PQ search is also timed along the parent tree's path (codes stacked on
  the host, `stacked_search`), beside this tree's;
- the fire path (after the window-updates path, on the main path's
  pipeline): serving under fire. (1) A traced session of admission bound
  8 under a ChaosPipeline (retrieval errors at calls 0, 2, 5, 9, 10) is
  fed the 16 questions and a poisoned query (its embedder raises), one a
  step: each request ends in one terminal state, the counters add up, the
  poisoned query fails, the trace passes `tools/trace_check.py`, and each
  done request with its max_new unclamped has the doc ids and prompt of a
  clean `answer_batch` of its question (its tokens' share equal to the
  main path's is reported). (2) A request's deadline passes after its
  first token: shed ("deadline"), cancelled in the engine, its slot
  serves the next request. (3) SLO admission: the card's p95 stage costs
  from a warm trace window, then the questions at an SLO of half that
  run's p50 latency (degrades and sheds reported). (4) The reference's
  chaos soak (tests/test_faults.py) with `SlotScheduler` over 3 clones of
  the continuous engine, 32 requests of the main path's prompts: the
  partition, a drain, a recovery in the calm tail, no page held, all
  pages free after the prefix caches drop, a clean trace; then the
  legacy wave `Scheduler` over two callables of the wave Engine, 8
  prompts. (5) An index fault and an SCR fault each add one to their
  fallback count and serve the reference's fallback (the last good ids;
  the full documents); a `KernelError` from `ops.ecoscan` propagates out
  of `answer_batch` and `RagSession.step`, and from
  `ops.decode_attention_paged` out of `SlotScheduler.run`, moving no
  counter;
- the durable path (after the fire path, on the main path's pipeline,
  in a temp directory removed after it): `save_retrieval` (seconds and
  bytes of the EcoVector and window-index generations); 64 inserts and
  32 deletes on the index and 16 adds, 8 updates and 4 removes on the
  window index, each through the fsync'd WAL (append ms p50 / p95);
  both parts loaded into fresh objects: every op replayed, device
  search of the 216 host-search queries bit-equal to the live index's,
  the window tensors bit-equal; `TieredEcoVector.load` at budgets None,
  0.5, 0.25 of the all-resident pack and half the centroids' bytes
  (all cold, warned): the device bytes within the budget (or the
  centroid floor), equal to the tensors held and to the
  `memory_allocated` delta of the activation (up to the allocator's
  rounding, under 2 MiB a tensor);
  8 rounds of the 16 questions each bit-equal to the all-resident
  index's (hot-hit share by round, promotions, demotions, search and
  cold-gather ms); the compaction (`save_retrieval` again); then
  `MobileRAG(retrieval_state=..., device_budget_bytes=0.25)` with the
  main path's weights is built without a kmeans_assign launch or a
  document embedded, and answers the 16 questions with the live
  pipeline's doc ids and prompts (the equal token share reported: bf16).
  ecoscan is then held to its plain version at the tier shape (hot rows
  and a cold scratch under a block map), with its device ms.

The line before the last is the kernel summary as JSON; the last line is
`{"ok": true, "device": {...}}`.
"""
import collections
import contextlib
import ctypes
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import kmeans as kmeans_mod  # noqa: E402
from repro_torch.core.baselines import make_index  # noqa: E402
from repro_torch.core.ecovector import EcoVector  # noqa: E402
from repro_torch.core.kmeans import (cluster_sums,  # noqa: E402
                                     kmeans_pp_init, lloyd)
from repro_torch.core.scr import (SCRConfig, sliding_windows,  # noqa: E402
                                  split_sentences)
from repro_torch.core.tiered import TieredEcoVector  # noqa: E402
from repro_torch.core.window_index import WindowIndex  # noqa: E402
from repro_torch.data.synthetic import make_qa_corpus, sift_like  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.dense import (DenseLM, cache_len,  # noqa: E402
                                      chunk_rows)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.moe import MoELM  # noqa: E402
from repro_torch.serving import rag as rag_mod  # noqa: E402
from repro_torch.serving.embedder import HashEmbedder  # noqa: E402
from repro_torch.serving.engine import (ContinuousEngine,  # noqa: E402
                                        Engine)
from repro_torch.serving.faults import (ChaosPipeline,  # noqa: E402
                                        FaultPlan, wrap_replicas)
from repro_torch.serving.rag import MobileRAG  # noqa: E402
from repro_torch.serving.sampling import (fold_in, gumbel,  # noqa: E402
                                          prng_key, random_bits,
                                          sample_rows)
from repro_torch.serving.scheduler import (Scheduler,  # noqa: E402
                                           SlotScheduler)
from repro_torch.serving.session import RagSession  # noqa: E402
from repro_torch.serving.trace import SLOController, TraceSink  # noqa: E402

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
# the MoE model of the moe path: granite-moe-1b-a400m at full width
MOE_CONFIG = get_config("granite_moe_1b_a400m")
# the baselines path: the paper's SIFT-1M cut to 0.1x (the k-means++
# seeding, a numpy copy of the reference's so both give the same
# centroids, is O(N * NC * d) on the host)
SIFT_N = 100_000
SIFT_NQ = 200
BASELINES = ("IVF", "IVFPQ", "IVF-DISK", "IVFPQ-DISK")
N_PROBES = (4, 16)
M_PQ = 8
# the graph baselines: the first N_G of the same vectors, M 12 and efc 60
# (benchmarks/common.py's graph settings). Graph inserts are host numpy,
# 6-10 ms an insert at 1,000-4,000 nodes on the host CPU of an H100
# machine (tools/hnsw_probe.py), so N_G keeps the graph phases to a few
# minutes
N_G = 6000
GRAPH_BASELINES = ("HNSW", "HNSWPQ", "IVF-HNSW", "EcoVector")
GRAPH_KW = dict(M=12, ef_construction=60)
# the updates phase on the main path's index: inserts (perturbed corpus
# vectors, ids past the corpus) and deletes, half of each a round
N_UPDATES = 256
N_REINSERT = 32
# corpus queries of the host-search phase, beside the 16 questions
HOST_NQ = 200
# the sampled path: the sessions' seed, the draw checked on the card
# ([4, vocab]) and the frequency test (draws t = 0 .. FREQ_DRAWS - 1 of
# one 16-way row, each frequency within FREQ_SIGMAS of softmax)
SAMPLE_SEED = 7
FREQ_DRAWS = 20000
FREQ_SIGMAS = 5.0
# the window-updates path: documents appended to the main path's corpus
# (each with its own marker), every fourth asked about; documents updated
# and removed through the window index; the long document that doubles
# CAPW
N_APPEND = 64
N_WI_UPDATE = 32
N_WI_REMOVE = 16
# the fire path: the chaos pipeline of the session under fire (retrieval
# errors at calls 0, 2, 5, 9 and 10; tests/test_faults.py), its poisoned
# query, the deadline of part 2, and the reference's chaos soak
# (tests/test_faults.py: 32 requests over 3 replicas)
FIRE_PLAN = dict(seed=3, horizon=12, rates={"retrieval_error": 0.5})
POISON = "POISON: a query its embedder cannot embed"
FIRE_DEADLINE_S = 1.0
SOAK_PLAN = dict(seed=0, horizon=80,
                 rates={"replica_crash": 0.06, "slot_stall": 0.03,
                        "slow_step": 0.05},
                 stall_steps=30, slow_s=0.002)
SOAK_REQUESTS = 32
# the durable path: the journaled ops on the main path's index (inserts
# of perturbed corpus vectors under new ids, deletes of corpus ids) and
# window index, the tiered loads' budgets (a share of the all-resident
# pack; "below": half the routing centroids' bytes) and their rounds of
# the 16 questions
N_DUR_INSERT = 64
N_DUR_DELETE = 32
N_DUR_ADD = 16
N_DUR_UPDATE = 8
N_DUR_REMOVE = 4
DUR_ID0 = 10 ** 7
TIER_BUDGETS = (None, 0.5, 0.25, "below")
TIER_ROUNDS = 8
# every RagSession the run makes, with the path it ran on (CURRENT)
SESSIONS = []
CURRENT = [None]
REPLACES = {
    "kmeans_assign": "src/repro/kernels/kmeans_assign.py:37",
    "ecoscan": "src/repro/kernels/ecoscan.py:163",
    "scr_select": "src/repro/kernels/scr_select.py:115",
    "decode_attention_paged": "src/repro/kernels/decode_attention.py:135",
    "flash_prefill": "src/repro/kernels/flash_prefill.py:95",
    "decode_attention": "src/repro/kernels/decode_attention.py:188",
    "scr_score": "src/repro/kernels/scr_score.py:33",
    "pq_adc": "src/repro/kernels/pq_adc.py:44",
    # the int8 decode kernels replace the reference's jnp function (it has
    # no pallas_call): the port reads the int8 cache in a kernel
    "decode_attention_q8": "src/repro/models/layers.py:227",
    "decode_attention_paged_q8": "src/repro/models/layers.py:227",
}
# the source of each kernel (the int8 kernels share their siblings')
SOURCES = {name: f"src/repro_torch/kernels/csrc/{name}.cu" for name in
           ops.KERNELS}
SOURCES["decode_attention_q8"] = SOURCES["decode_attention"]
SOURCES["decode_attention_paged_q8"] = SOURCES["decode_attention_paged"]
# the kernels each path must launch
PATH_KERNELS = {
    "main": ("kmeans_assign", "ecoscan", "scr_select",
             "decode_attention_paged", "flash_prefill"),
    "wave": ("flash_prefill", "decode_attention"),
    "h2o": ("flash_prefill", "decode_attention"),
    "legacy": ("ecoscan", "scr_score", "decode_attention_paged",
               "flash_prefill"),
    "baselines": ("kmeans_assign", "pq_adc"),
    # the host search launches nothing; the legacy SCR of its MobileRAG
    # does
    "host_search": ("scr_score",),
    "graph_baselines": ("kmeans_assign",),
    "updates": ("ecoscan",),
    "h2o_continuous": ("flash_prefill", "decode_attention_paged"),
    "h2o_int8": ("flash_prefill", "decode_attention_q8",
                 "decode_attention_paged_q8"),
    "int8": ("flash_prefill", "decode_attention_q8",
             "decode_attention_paged_q8"),
    "moe": ("flash_prefill", "decode_attention", "decode_attention_paged"),
    "sampled": ("flash_prefill", "decode_attention_paged", "decode_attention",
                "ecoscan", "scr_select"),
    "window_updates": ("ecoscan", "scr_select", "flash_prefill",
                       "decode_attention_paged"),
    # the session and scheduler ladders; the wave Scheduler's replicas
    # run the wave Engine
    "fire": ("ecoscan", "scr_select", "flash_prefill",
             "decode_attention_paged", "decode_attention"),
    # save, journal, tiered loads and a restored pipeline answering
    "durable": ("ecoscan", "scr_select", "flash_prefill",
                "decode_attention_paged"),
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


def check_ecoscan(label, q, data, lens, probes, k, block_map=None,
                  map_kind="masked"):
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
              f"{'identity' if block_map is None else map_kind}",
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


def chunk_buffer(kp, vp, row, offset, c, ps, ring_len=0):
    """The K/V buffers `prefill_chunk_paged` hands flash_prefill for a
    chunk at `offset` through page-table `row` of one layer's pool (its
    `chunk_rows`): the slot's history in position order, then the chunk,
    here the pool rows the chunk writes. Returns (k, v, lo); the chunk's
    queries sit at q_offset offset - lo."""
    lo, gather, (pg, off) = chunk_rows(row, offset, c, offset + c, ps,
                                       ring_len)
    k, v = (torch.cat([t.reshape((-1,) + t.shape[2:])[gather], t[pg, off]]
                      )[None] for t in (kp, vp))
    return k, v, lo


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


def q8_planes(x, zero_rows=()):
    """int8 values and f32 scales of x [..., S, G, dh] (`quantize_kv`),
    with the positions `zero_rows` (indices of the S axis) zeroed first:
    their scales clamp to 1e-10."""
    x = x.clone()
    for r in zero_rows:
        x[..., r, :, :] = 0
    return L.quantize_kv(x)


def _q8_bound(n_pos, G, H, dh, q):
    """Bytes bound of an int8 decode call: int8 K and V plus their f32
    scales once for the n_pos positions the rows attend, q read and the
    output written once; operations 4*H*dh a position."""
    esz = q.element_size()
    return bound(2 * n_pos * G * (dh + 4) + 2 * q.numel() * esz
                 + 4 * q.shape[0], 4.0 * n_pos * H * dh,
                 BF16_FLOPS_S if q.dtype == torch.bfloat16 else F32_FLOPS_S)


def check_decode_q8(label, q, kq, ks, vq, vs, kv_len, ring):
    """decode_attention_q8 at one path shape: kernel against plain in q's
    type (bf16: 2e-2) and in f32 (1e-5); times, the bytes bound, and the
    library's way (dequantize in torch, then SDPA) timed as one."""
    B, H, dh = q.shape
    S, G = kq.shape[1], kq.shape[2]
    a = (kq, ks, vq, vs, kv_len)
    err = close(f"decode_attention_q8 {label}",
                ops.decode_attention_q8(q, *a, ring=ring),
                ref.decode_attention_q8(q, *a, ring=ring), 2e-2, 2e-2)
    close(f"decode_attention_q8 {label} f32",
          ops.decode_attention_q8(q.float(), *a, ring=ring),
          ref.decode_attention_q8(q.float(), *a, ring=ring), 1e-5, 1e-5)
    n = kv_len.long().clamp(max=S)
    n = torch.where(n > 0, n, S)
    b_ms, b_by = _q8_bound(int(n.sum()), G, H, dh, q)
    mask = (torch.arange(S, device=q.device)[None, :] < n[:, None]
            )[:, None, None, :]

    def library():
        k = L.dequantize_kv(kq, ks, q.dtype)
        v = L.dequantize_kv(vq, vs, q.dtype)
        return F.scaled_dot_product_attention(
            q[:, :, None], _expand(k, H // G), _expand(v, H // G),
            attn_mask=mask)
    return dict(
        shape=f"{label}: q {list(q.shape)}, kq {list(kq.shape)} int8, "
              f"kv_len {kv_len.tolist()[:4]}, ring {ring}, {q.dtype}",
        err=err, ties=0,
        ms=time_ms(lambda: ops.decode_attention_q8(q, *a, ring=ring),
                   iters=50),
        plain_ms=time_ms(lambda: ref.decode_attention_q8(q, *a, ring=ring)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def paged_q8_forced(q, kq, ks, vq, vs, kv_len, table, splits):
    """The decode_attention_paged_q8 kernel at a forced split count,
    through its C entry point; no launch is counted."""
    B, H, dh = q.shape
    _, ps, G, _ = kq.shape
    W = table.shape[1]
    out = torch.empty_like(q)
    part = torch.empty(B * G * splits * (H // G) * (dh + 2), device=q.device)
    err = build.entry("decode_attention_paged_q8_"
                      + ops._attention_dtype(q))(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
        vs.data_ptr(), kv_len.data_ptr(), table.data_ptr(), B, H, G, dh, ps,
        W, splits, part.data_ptr(), out.data_ptr(), ops._stream(q.device))
    assert err == 0, f"decode_attention_paged_q8 at {splits} splits: {err}"
    return out


def check_decode_paged_q8(label, q, kq, ks, vq, vs, kv_len, table):
    """decode_attention_paged_q8 at one path shape: kernel against plain
    in q's type (bf16: 2e-2) and in f32 (1e-5); times, the bytes bound of
    this run's kv_len, and the library's way (gather and dequantize the
    pages in torch, then SDPA) timed as one."""
    B, H, dh = q.shape
    P, ps, G, _ = kq.shape
    W = table.shape[1]
    a = (kq, ks, vq, vs, kv_len, table)
    err = close(f"decode_attention_paged_q8 {label}",
                ops.decode_attention_paged_q8(q, *a),
                ref.decode_attention_paged_q8(q, *a), 2e-2, 2e-2)
    close(f"decode_attention_paged_q8 {label} f32",
          ops.decode_attention_paged_q8(q.float(), *a),
          ref.decode_attention_paged_q8(q.float(), *a), 1e-5, 1e-5)
    kv = int(kv_len.clamp(min=0, max=W * ps).sum())
    b_ms, b_by = _q8_bound(kv, G, H, dh, q)
    j = torch.arange(W * ps, device=DEV)
    mask = (j[None, :] < kv_len[:, None])[:, None, None, :]

    def library():
        idx = table.long()[:, j // ps] * ps + (j % ps)
        k = L.dequantize_kv(kq.reshape(P * ps, G, dh)[idx],
                            ks.reshape(P * ps, G)[idx], q.dtype)
        v = L.dequantize_kv(vq.reshape(P * ps, G, dh)[idx],
                            vs.reshape(P * ps, G)[idx], q.dtype)
        return F.scaled_dot_product_attention(
            q[:, :, None], _expand(k, H // G), _expand(v, H // G),
            attn_mask=mask)
    return dict(
        shape=f"{label}: q {list(q.shape)}, pool {list(kq.shape)} int8, "
              f"table {list(table.shape)}, kv_len {kv_len.tolist()[:4]}, "
              f"splits {ops.decode_paged_split_plan(B, G, W, ps)}, "
              f"{q.dtype}",
        err=err, ties=0,
        ms=time_ms(lambda: ops.decode_attention_paged_q8(q, *a), iters=50),
        plain_ms=time_ms(lambda: ref.decode_attention_paged_q8(q, *a)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def q8_edges():
    """Edge cases of the two int8 decode kernels, each with q in f32
    (1e-5) and in bf16 (2e-2). decode_attention_q8: a ring that wraps
    (kv_len past S) beside rows of kv_len 1 and 0, positions whose K and
    V rows are all zero (their scales clamp to 1e-10), h2o's grouping at
    dh 80, and a shape the plan splits at least 8 ways.
    decode_attention_paged_q8, through the wrapper and at forced split
    counts: kv_len under one page, a 64-position ring over three
    24-position pages (ring_len not a multiple of ps: kv_len 64 < W*ps),
    zero rows, and qwen's grouping over tables that repeat, reverse and
    point tail entries at page 0 at kv_len 0, 1, a page end and past
    W*ps. Returns the number of (case, dtype, split count) triples."""
    g = torch.Generator(device=DEV).manual_seed(6)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=DEV)

    def ints(*x):
        return torch.tensor(x, dtype=torch.int32, device=DEV)
    n = 0
    contiguous = [
        ("ring wraps, kv_len 1 and 0", (4, 8, 96, 2, 64),
         ints(1, 95, 200, 0), True, ()),
        ("zero rows", (2, 4, 70, 2, 32), ints(70, 33), False, (0, 5, 32)),
        ("h2o grouping, dh 80", (3, 32, 300, 8, 80), ints(300, 1, 77), False,
         ()),
        ("8+ splits", (1, 8, 8192, 1, 128), ints(8000), False, ()),
    ]
    for label, (B, H, S, G, dh), kv, ring, zeros in contiguous:
        if label == "8+ splits":
            assert ops.decode_split_plan(B, G, S) >= 8
        q = rnd(B, H, dh)
        kq, ks = q8_planes(rnd(B, S, G, dh), zeros)
        vq, vs = q8_planes(rnd(B, S, G, dh), zeros)
        a = (kq, ks, vq, vs, kv)
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            close(f"decode_attention_q8 edge {label} {dt}",
                  ops.decode_attention_q8(q.to(dt), *a, ring=ring),
                  ref.decode_attention_q8(q.to(dt), *a, ring=ring), tol, tol)
            n += 1
    rev = torch.arange(17, -1, -1, dtype=torch.int32, device=DEV)
    tail = torch.cat([ints(5, 9, 2), torch.zeros(15, dtype=torch.int32,
                                                  device=DEV)])
    paged = [
        ("kv_len under a page", (4, 4, 2, 32, 8, 16), ints(1, 5, 0, 16),
         ints(3, 1, 0, 0, 2, 5, 7, 1, 4, 4, 6, 0, 7, 6, 5, 4).view(4, 4),
         (), (1, 2, 4)),
        ("ring_len 64 over ps 24", (3, 8, 2, 80, 12, 24), ints(64, 64, 40),
         torch.stack([torch.arange(12, dtype=torch.int32, device=DEV)
                      .roll(r)[:3] for r in (0, 5, 11)]), (), (1, 2, 3)),
        ("zero rows", (2, 4, 2, 32, 6, 16), ints(90, 17),
         torch.stack([torch.arange(6, dtype=torch.int32, device=DEV),
                      ints(5, 4, 3, 2, 1, 0)]), (0, 3, 15), (1, 6)),
        ("qwen grouping, W 18", (4, 14, 2, 64, 24, 32), ints(0, 1, 96, 600),
         torch.stack([rev, tail, rev.flip(0), tail]), (), (1, 7, 18)),
    ]
    for label, (B, H, G, dh, P, ps), kv, tb, zeros, splits in paged:
        q = rnd(B, H, dh)
        kq, ks = q8_planes(rnd(P, ps, G, dh), zeros)
        vq, vs = q8_planes(rnd(P, ps, G, dh), zeros)
        a = (kq, ks, vq, vs, kv, tb)
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            want = ref.decode_attention_paged_q8(q.to(dt), *a)
            close(f"decode_attention_paged_q8 edge {label} {dt}",
                  ops.decode_attention_paged_q8(q.to(dt), *a), want, tol,
                  tol)
            for sp in splits:
                close(f"decode_attention_paged_q8 edge {label} {dt} at {sp}"
                      " splits", paged_q8_forced(q.to(dt), *a, sp), want,
                      tol, tol)
            n += 1 + len(splits)
    return n


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


def profile_decode_steps(eng, prompts, n=8, greedy=True):
    """torch.profiler over n steady decode steps of a continuous engine:
    the prompts are submitted (40 tokens each, sampled from seed
    SAMPLE_SEED unless `greedy`) and stepped until every one has its
    first token, then n steps are profiled and the rest drained."""
    for p in prompts:
        eng.submit(p, 40, greedy=greedy, seed=SAMPLE_SEED)
    started = set()
    while len(started) < len(prompts) and eng.pending:
        started |= {ev.rid for ev in eng.step() if ev.kind == "token"}
    step = _profiled(eng.step, n)
    while eng.pending:
        eng.step()
    return step


def profile_phase(slm, prompts, kernel_calls):
    """torch.profiler over steady decode steps of the main path's engine
    (4 slots decoding) and over each kernel wrapper alone: device busy
    share of a step, the kernels that take its device time, and each
    port kernel's device time per call (without the host launch cost
    that the CUDA-event loop of phase 5 includes)."""
    step = profile_decode_steps(slm.engine, prompts)
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
    CURRENT[0] = path
    out = fn()
    torch.cuda.synchronize()
    CURRENT[0] = None
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


def equal_share(a, b):
    """Share of greedy tokens equal position by position between two runs
    of the same requests, over the longer run of each request."""
    same = sum(x == y for r, t in zip(a, b)
               for x, y in zip(r.tokens, t.tokens))
    return same / sum(max(len(r.tokens), len(t.tokens)) for r, t in zip(a, b))


def traced_continuous(eng, slots):
    """The engine's shared continuous engine of `slots` slots, with a
    fresh TraceSink attached (its decode-step spans give decode tok/s)."""
    ce = eng.continuous(slots)
    ce.trace = TraceSink()
    return ce


def continuous_summary(ce, results):
    """Prefill s (the slowest request's TTFT), decode tok/s (slot tokens
    over the summed decode-step spans), and the pool: ring_len, table
    width, pages, bytes, and bytes a position, kv head and tensor (K or
    V, with its scales)."""
    spans = ce.trace.durations("engine", "decode_step")
    active = [r.attrs["active"] for r in ce.trace.query(
        comp="engine", name="decode_step") if r.ph == "B"]
    pool = sum(t.numel() * t.element_size() for t in ce.cache.values())
    k = ce.cache["k"]
    return {"requests": len(results), "ring_len": ce.ring_len,
            "table_width": ce.table_width, "pages": ce.num_pages,
            "abs_len": ce.abs_len, "pool_bytes": pool,
            "pool_bytes_per_position_head_tensor":
                pool / (2 * k.shape[0] * k.shape[1] * k.shape[2]
                        * k.shape[3]),
            "prefill_s_max": max(r.prefill_s for r in results),
            "decode_tok_s": sum(active) / sum(spans),
            "decode_steps": len(spans),
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


def corpus_queries(docs, n):
    """n queries cut from the corpus: one middle sentence of each of n
    documents spread evenly over it."""
    step = len(docs) // n
    return [docs[i].split(". ")[2 + i % 5] for i in range(0, step * n, step)]


def exact_pack_ids(index, qvs, k):
    """Exact top-k ids over every row the index's host pack holds (plain
    f32 distances on the card)."""
    data, _, slot_ids, _ = index.device_pack()
    live = slot_ids >= 0
    x = torch.tensor(data[live], device=DEV)
    q = torch.tensor(qvs, device=DEV)
    d2 = ((q * q).sum(1)[:, None] - 2.0 * q @ x.T
          + (x * x).sum(1)[None, :])
    return slot_ids[live][torch.topk(d2, k, largest=False).indices.cpu()
                          .numpy()]


def recall(got, want, k):
    return float(np.mean([len(set(np.asarray(g)[:k].tolist())
                              & set(w[:k].tolist())) / k
                          for g, w in zip(got, want)]))


def host_search(index, qvs, n_probe, k=10):
    """EcoVector's host search (route on the centroid graph, load each
    probed cluster's graph from disk, search it, merge) a query at a
    time: ids, host-clock seconds, and disk loads and bytes of each."""
    s = index.stats
    ids, times, loads, nbytes = [], [], [], []
    for q in qvs:
        l0, b0 = s.disk_loads, s.disk_bytes
        t = time.perf_counter()
        i, _ = index.search(q, k=k, n_probe=n_probe)
        times.append(time.perf_counter() - t)
        ids.append(i)
        loads.append(s.disk_loads - l0)
        nbytes.append(s.disk_bytes - b0)
    return ids, times, loads, nbytes


def host_search_phase(pipe, embed, docs, questions):
    """The main path's index searched on the host: the 16 questions and
    200 corpus queries at k 10 and the pipeline's n_probe; each query
    loads exactly n_probe cluster graphs (no cache: the partial-loading
    contract). Then `MobileRAG(index=pipe.index, device_retrieval=False)`
    (legacy SCR, no second window index) answers the 16 questions; that
    pipeline is returned last."""
    idx = pipe.index
    assert idx.cache_clusters == 0 and not idx._quarantined
    qvs = np.asarray(embed(questions + corpus_queries(docs, HOST_NQ)),
                     np.float32)
    ids, times, loads, nbytes = host_search(idx, qvs, pipe.n_probe)
    assert loads == [pipe.n_probe] * len(qvs), \
        f"host search: disk loads a query {sorted(set(loads))}"
    hpipe = MobileRAG(docs, embed, top_k=3, index=idx, device_retrieval=False,
                      use_window_index=False, gen_config=GEN_CONFIG, seed=0,
                      device=DEV)
    return qvs, ids, times, nbytes, hpipe.answer_batch(questions), hpipe


def host_search_info(pipe, qvs, ids, times, nbytes, host_answers, answers):
    idx = pipe.index
    exact = exact_pack_ids(idx, qvs, 10)
    dev_ids, _ = idx.search_device_batched(qvs, k=3, n_probe=pipe.n_probe)
    data, lens, slot_ids, cap = idx.device_pack()
    # the host routes on the centroid graph, the device path on exact
    # centroid distances
    dense = ref.route_topk(torch.tensor(qvs, device=DEV),
                           idx.device_arrays()[2], pipe.n_probe).cpu().numpy()
    route_eq = [set(idx._route(q, pipe.n_probe)) == set(r.tolist())
                for q, r in zip(qvs, dense)]
    top3_eq = [set(np.asarray(h)[:3].tolist()) == set(d.tolist())
               for h, d in zip(ids, dev_ids)]
    nq = len(host_answers)
    return {
        "queries": len(qvs), "n_probe": pipe.n_probe, "k": 10,
        "search_ms_p50": float(np.median(times) * 1e3),
        "disk_loads_per_query": pipe.n_probe,
        "disk_bytes_per_query_mean": float(np.mean(nbytes)),
        "recall_at_3": recall(ids, exact, 3),
        "recall_at_10": recall(ids, exact, 10),
        "top3_equal_device_share": float(np.mean(top3_eq)),
        "questions_top3_equal_device_share": float(np.mean(top3_eq[:nq])),
        "route_equal_dense_share": float(np.mean(route_eq)),
        "questions_route_equal_dense_share": float(np.mean(route_eq[:nq])),
        "ram_bytes": idx.ram_bytes(),
        "ram_bytes_without_device": idx.ram_bytes()
        - idx.device_resident_bytes(),
        "device_resident_bytes": idx.device_resident_bytes(),
        "host_pack_bytes": data.nbytes + lens.nbytes + slot_ids.nbytes,
        "disk_bytes": idx.disk_bytes(),
        "avg_cluster_bytes": idx.avg_cluster_bytes(),
        "build_split_s": idx.timings,
        "rag_host_doc_set_share": float(np.mean([
            set(a.doc_ids) == set(b.doc_ids)
            for a, b in zip(host_answers, answers)])),
        "rag_host_retrieval_s_mean": float(np.mean([
            a.retrieval_s for a in host_answers])),
    }


def _routes_to(index, vec):
    """The cluster `EcoVector.insert` would put vec in."""
    return int(index.centroid_graph.search(vec, 1, ef_search=16)[0][0])


def _update_round(index, emb, rng, next_id, grow):
    """One round of N_UPDATES / 2 inserts and as many deletes. The new
    vectors are corpus rows perturbed by 0.002 a coordinate; without
    `grow` each goes where its cluster has room (its route is checked
    first), so CAP stays; with `grow` they are taken from the largest
    cluster's members, and the first ones routed there overflow it. The
    deletes are corpus ids, and N_REINSERT of them come back with their
    own vectors. Returns {id: vector} inserted, and the ids deleted and
    not re-inserted."""
    _, _, _, cap = index.device_pack()
    room = cap - index.cluster_sizes()
    if grow:
        pool = [v for v in index.cluster_members[int(np.argmax(
            index.cluster_sizes()))] if v < len(emb)]
    else:
        pool = [v for v in rng.permutation(len(emb)).tolist()
                if index.assign.get(v) is not None]
    added = {}
    for j in range(4 * N_UPDATES):
        if len(added) == N_UPDATES // 2:
            break
        v = pool[j % len(pool)]
        vec = (emb[v] + 0.002 * rng.standard_normal(emb.shape[1])).astype(
            np.float32)
        c = _routes_to(index, vec)
        if not grow and room[c] <= 0:
            continue
        room[c] -= 1
        index.insert(next_id + len(added), vec)
        added[next_id + len(added)] = vec
    assert len(added) == N_UPDATES // 2, len(added)
    gone = [v for v in rng.choice(len(emb), 2 * N_UPDATES, replace=False)
            .tolist() if index.assign.get(v) is not None][:N_UPDATES // 2]
    for v in gone:
        index.delete(v)
    back = []
    for v in gone:
        c = _routes_to(index, emb[v])
        if len(back) < N_REINSERT and (grow or room[c] > 0):
            room[c] -= 1
            index.insert(v, emb[v])
            added[v] = emb[v]
            back.append(v)
    return added, set(gone) - set(back)


def update_phase(index, emb, qvs, n_probe, next_id):
    """Two update rounds on the main path's index (`_update_round`: the
    first inside CAP, the second past it), each followed by the device
    query that repacks the dirty clusters and refreshes the device
    tensors. After each: the device tensors equal the host pack bit for
    bit; without growth only the dirty blocks were copied (counted) and
    nothing was uploaded whole, with growth the pack grew once and was
    uploaded once; `search_device_batched` over the 216 queries returns
    the ids of plain `ref.route_topk` + `ref.ecoscan` over the same
    device tensors (equal except ties within 2e-5); every vector inserted
    is in the pack and in its own top 3 with every cluster probed, or tied
    there at distance ~0 (the share at `n_probe` is reported); no deleted
    id is ever returned. The new ids start at `next_id`, past every
    document of the pipeline."""
    rng = np.random.default_rng(21)
    s = index.stats
    out, deleted = [], set()
    for grow in (False, True):
        cap0 = index.device_pack()[3]
        before = (s.pack_grows, s.mirror_uploads, s.mirror_blocks,
                  s.pack_cluster_repacks)
        t = time.perf_counter()
        added, gone = _update_round(index, emb, rng, next_id, grow)
        update_s = time.perf_counter() - t
        next_id += N_UPDATES
        deleted = (deleted | gone) - set(added)
        dirty = len(index._dirty)
        t = time.perf_counter()
        data, lens, slot_ids, cap = index.device_pack()
        repack_s = time.perf_counter() - t
        t = time.perf_counter()
        d_t, l_t, c_t = index.device_arrays()
        torch.cuda.synchronize()
        refresh_s = time.perf_counter() - t
        assert torch.equal(d_t.cpu(), torch.from_numpy(data))
        assert torch.equal(l_t.cpu(), torch.from_numpy(lens))
        grows = s.pack_grows - before[0]
        uploads = s.mirror_uploads - before[1]
        blocks = s.mirror_blocks - before[2]
        if grow:
            assert grows == 1 and uploads == 1 and cap > cap0, (grows, cap)
        else:
            assert grows == uploads == 0 and cap == cap0, (grows, uploads)
            assert blocks == dirty > 0, (blocks, dirty)
        ids, dists = index.search_device_batched(qvs, k=10, n_probe=n_probe)
        qt = torch.tensor(qvs, device=DEV)
        pd, ps = ref.ecoscan(qt, d_t, l_t, ref.route_topk(qt, c_t, n_probe),
                             10)
        ps = ps.cpu().numpy()
        close("search after updates", torch.tensor(dists), pd.cpu(), 2e-5,
              2e-5)
        pos = {v: i for i, v in enumerate(slot_ids.reshape(-1).tolist())
               if v >= 0}
        got = torch.tensor([[pos.get(v, -1) for v in row]
                            for row in ids.tolist()], device=DEV)
        ties = same_or_tied("search after updates", got,
                            torch.tensor(ps, device=DEV), _slot_dist(qt, d_t),
                            2e-5, 2e-5)
        # found: its row is in the pack, and with every cluster probed it
        # is in its own top 3 or ties there at distance ~0 (the corpus
        # holds groups of identical embeddings: the same words in
        # another order). Insert routes on the centroid graph, the
        # device path on exact centroid distances, so a probe width can
        # miss a vector the graph routed elsewhere: that share is
        # reported
        live = {v: vec for v, vec in added.items() if v not in deleted}
        live_q = np.stack(list(live.values()))
        rows = data.reshape(-1, data.shape[-1])
        assert all(v in pos and np.array_equal(rows[pos[v]], vec)
                   for v, vec in live.items()), "an inserted row is missing"
        found, found_d = index.search_device_batched(
            live_q, k=3, n_probe=index.n_clusters)
        assert all(v in row or d_[-1] <= 2e-5 for v, row, d_ in
                   zip(live, found.tolist(), found_d)), \
            "an inserted vector is not in its own top 3"
        found_p = index.search_device_batched(live_q, k=3, n_probe=n_probe)[0]
        gone_q = np.stack([emb[v] for v in sorted(deleted)])
        hit = index.search_device_batched(gone_q, k=10,
                                          n_probe=index.n_clusters)[0]
        assert not (set(ids.ravel().tolist()) | set(found.ravel().tolist())
                    | set(found_p.ravel().tolist())
                    | set(hit.ravel().tolist())) & deleted, \
            "a deleted id was returned"
        q16 = qvs[:16]
        times = []
        for _ in range(20):
            t = time.perf_counter()
            index.search_device_batched(q16, k=3, n_probe=n_probe)
            times.append(time.perf_counter() - t)
        out.append({
            "round": "past CAP" if grow else "inside CAP",
            "inserted": N_UPDATES // 2, "deleted": N_UPDATES // 2,
            "reinserted": len(added) - N_UPDATES // 2, "update_s": update_s,
            "dirty_clusters": dirty, "repack_ms": repack_s * 1e3,
            "device_refresh_ms": refresh_s * 1e3, "cap": [cap0, cap],
            "pack_cluster_repacks": s.pack_cluster_repacks - before[3],
            "pack_grows": grows, "whole_uploads": uploads,
            "blocks_copied": blocks, "tied_swaps": ties,
            "found_at_n_probe_share": float(np.mean([
                v in row for v, row in zip(live, found_p.tolist())])),
            "found_all_probes_share": float(np.mean([
                v in row for v, row in zip(live, found.tolist())])),
            "search_16_ms_p50": float(np.median(times) * 1e3)})
    return out, (d_t, l_t, c_t)


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def run_graph_baselines(base, queries):
    """HNSW, HNSWPQ, IVF-HNSW and EcoVector through `make_index` over
    `base`: build s and k-means launches, then every query at k 10 (the
    graphs at ef 64, the clustered indexes at each probe width): host
    wall times, ids, and the search stats' deltas."""
    n_clusters = max(16, len(base) // 256)    # benchmarks/common.py's rule
    out = {}
    for name in GRAPH_BASELINES:
        kw = dict(device=DEV)
        if name != "IVF-HNSW":
            kw.update(GRAPH_KW)
        if name in ("IVF-HNSW", "EcoVector"):
            kw["n_clusters"] = n_clusters
        if name == "HNSWPQ":
            kw["m_pq"] = M_PQ
        t0 = time.perf_counter()
        k0 = ops.kmeans_assign.launches
        idx = make_index(name, base.shape[1], **kw).build(base)
        torch.cuda.synchronize()
        runs = {"build_s": time.perf_counter() - t0,
                "kmeans_launches": ops.kmeans_assign.launches - k0}
        for n_probe in (N_PROBES if "n_clusters" in kw else (None,)):
            s = idx.stats
            s0 = (s.disk_loads, s.disk_bytes, s.distance_ops)
            ids, times = [], []
            for q in queries:
                t = time.perf_counter()
                i, _ = (idx.search(q, k=10, n_probe=n_probe) if n_probe
                        else idx.search(q, k=10, ef_search=64))
                times.append(time.perf_counter() - t)
                ids.append(i)
            runs[f"n_probe {n_probe}" if n_probe else "ef_search 64"] = dict(
                ids=ids, times=times, disk_loads=s.disk_loads - s0[0],
                disk_bytes=s.disk_bytes - s0[1],
                distance_ops=s.distance_ops - s0[2])
        out[name] = (idx, runs)
    return out


def graph_baselines_info(indexes, base, queries):
    gt = exact_top10(base, queries)
    info = {}
    for name, (idx, runs) in indexes.items():
        row = {"build_s": runs["build_s"], "ram_bytes": idx.ram_bytes(),
               "disk_bytes": (_dir_bytes(idx.storage_dir)
                              if hasattr(idx, "storage_dir") else 0),
               "kmeans_launches": runs["kmeans_launches"]}
        for key, r in runs.items():
            if not isinstance(r, dict):
                continue
            assert all(len(i) == 10 for i in r["ids"]), name
            row[key] = {
                "recall_at_10": recall(r["ids"], gt, 10),
                "recall_at_1": float(np.mean([i[0] == g[0] for i, g in
                                              zip(r["ids"], gt)])),
                "search_ms_p50": float(np.median(r["times"]) * 1e3),
                "disk_loads": r["disk_loads"], "disk_bytes": r["disk_bytes"],
                "distance_ops": r["distance_ops"]}
        info[name] = row
    return info


def word_corpus(n_docs, seed):
    """Random-word documents: no two SCR windows share a bag of words,
    so the small-input comparison has no ties decided by rounding."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    return [" ".join(" ".join(rng.choice(vocab, 7)).capitalize() + "."
                     for _ in range(12)) for _ in range(n_docs)]


def small_input_agreement():
    """The pipeline on the GPU against its plain versions on the CPU:
    float32 reduced models, same random weights. MobileRAG end to end,
    greedy and then sampled sessions; the qwen2.5 wave path (and, on the
    GPU, its continuous engine) on the bucketed prompts, greedy and
    sampled; the h2o wave path on an 80-token prompt, past its 64-slot
    window."""
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
    # sampled sessions on both (their engines have served the same
    # requests, so the rids and streams are the same)
    s_gpu, s_cpu = [p_.session(max_new=8, greedy=False,
                               seed=SAMPLE_SEED).run(queries)
                    for p_ in (gpu, cpu)]
    for a, b in zip(s_gpu, s_cpu):
        assert a.doc_ids == b.doc_ids and a.prompt == b.prompt
        assert a.gen_tokens == b.gen_tokens, ("sampled session GPU vs CPU",
                                              a.gen_tokens, b.gen_tokens)
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
    sampled = [m.slm.wave.generate(prompts, max_new=8, greedy=False,
                                   seed=SAMPLE_SEED, continuous=c)
               for m, c in ((gpu, False), (cpu, False), (gpu, True))]
    for w, c, e in zip(*sampled):
        assert w.tokens == c.tokens, ("sampled wave GPU vs CPU", w.tokens,
                                      c.tokens)
        assert w.tokens == e.tokens, ("sampled wave vs continuous",
                                      w.tokens, e.tokens)
    assert any(w.tokens != g.tokens for w, g in zip(sampled[0], wave_gpu))
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


def small_families_agreement():
    """The four paged families of the reference's contract, float32
    reduced, on the GPU (kernels) and on the CPU (plain versions), each
    through `Engine` waves and the continuous engine (2 slots, max_len
    96): sliding window (an 80-token prompt past its 64-position ring
    beside a 20-token one), int8 KV, sliding window + int8, and MoE. GPU
    tokens equal CPU tokens, and wave tokens equal continuous tokens.
    Returns {family: requests}."""
    rng = np.random.default_rng(17)
    mixed = [rng.integers(4, 500, n).astype(np.int32)
             for n in (16, 24, 33, 40, 9)]
    wrap = [rng.integers(4, 500, n).astype(np.int32) for n in (80, 20)]
    cases = [("swa", "h2o_danube_1_8b", {}, wrap),
             ("int8", "qwen25_0_5b", {"kv_quant": True}, mixed),
             ("swa_int8", "h2o_danube_1_8b", {"kv_quant": True},
              wrap + mixed[:2]),
             ("moe", "granite_moe_1b_a400m", {}, mixed)]
    out = {}
    for kind, arch, over, prompts in cases:
        cfg = get_config(arch).reduced(dtype="float32", **over)
        on_gpu = build_model(cfg, device=DEV, seed=3)
        on_cpu = build_model(cfg, device="cpu", params={
            n: p_.detach().cpu() for n, p_ in on_gpu.named_parameters()})
        runs = []
        for m in (on_gpu, on_cpu):
            eng = Engine(m, max_len=96, slots=2)
            runs.append([eng.generate(prompts, 8, continuous=c)
                         for c in (False, True)])
        (gw, gc), (cw, cc) = runs
        for i in range(len(prompts)):
            assert gw[i].tokens == cw[i].tokens, (kind, "wave GPU vs CPU", i)
            assert gc[i].tokens == cc[i].tokens, (kind, "continuous GPU vs "
                                                  "CPU", i)
            assert gw[i].tokens == gc[i].tokens, (kind, "wave vs continuous",
                                                  i)
        out[kind] = len(prompts)
    return out


def gen_results(answers):
    """RAG answers as results with `tokens` (for `check_tokens` and
    `equal_share`)."""
    return [SimpleNamespace(tokens=a.gen_tokens) for a in answers]


def fresh_engine(slm):
    """A new 4-slot continuous engine over the sLM's model, at the main
    path's settings (its rids start at 0)."""
    return ContinuousEngine(slm.model, slots=slm.SLOTS,
                            max_len=slm.MAX_PROMPT + slm.MAX_NEW,
                            eos_id=slm.tokenizer.eos_id,
                            prefill_chunk=slm.PREFILL_CHUNK,
                            page_size=slm.PAGE_SIZE)


def sampled_session(pipe, questions):
    """The questions through `pipe.session(greedy=False)` on a fresh
    engine (the sLM's cached one is dropped first, so the session's rids
    start again at the warmup's 0), traced: its answers and trace."""
    pipe.slm.wave._cont.pop(pipe.slm.SLOTS, None)
    trace, pipe.trace = pipe.trace, TraceSink()
    try:
        sess = pipe.session(max_new=MAX_NEW, slots=pipe.slm.SLOTS,
                            greedy=False, seed=SAMPLE_SEED)
        return sess.run(questions), pipe.trace
    finally:
        pipe.trace = trace


def coresident_runs(slm, target, others):
    """The target request (rid 100, sampled) alone and beside 1 and 3
    sampled co-residents (rids 0, 1, 2), each run on a fresh engine: the
    target's tokens of each run."""
    runs = []
    for n in (0, 1, 3):
        ce = fresh_engine(slm)
        tid = ce.submit(target, MAX_NEW, rid=100, greedy=False,
                        seed=SAMPLE_SEED)
        for i, p_ in enumerate(others[:n]):
            ce.submit(p_, MAX_NEW, rid=i, greedy=False, seed=SAMPLE_SEED)
        out = {}
        while ce.pending:
            out.update({ev.rid: ev.result.tokens for ev in ce.step()
                        if ev.kind == "done"})
        runs.append(out[tid])
    return runs


def draw_checks(vocab):
    """The draw on the card against the CPU's: `random_bits` of a [4,
    vocab] draw bit for bit, `gumbel` within 2 ulp of max(|g|, 1) (the
    card's `log` may round apart from the CPU's); then FREQ_DRAWS draws t
    = 0 .. FREQ_DRAWS - 1 of one seeded 16-way row, each category's
    frequency within FREQ_SIGMAS binomial sigmas of its softmax
    probability."""
    keys = torch.stack([fold_in(prng_key(SAMPLE_SEED), r) for r in range(4)])
    bits_cpu = random_bits(keys, (vocab,))
    bits_dev = random_bits(keys.to(DEV), (vocab,))
    assert torch.equal(bits_dev.cpu(), bits_cpu), "random_bits card != CPU"
    g_cpu = gumbel(keys, (vocab,)).numpy()
    g_dev = gumbel(keys.to(DEV), (vocab,)).cpu().numpy()
    ulps = np.abs(g_dev - g_cpu) / np.spacing(np.maximum(np.abs(g_cpu),
                                                         np.float32(1)))
    assert ulps.max() <= 2.0, f"gumbel card vs CPU: {ulps.max()} ulp"
    row = torch.tensor(np.random.default_rng(3).normal(0, 1.5, 16),
                       dtype=torch.float32, device=DEV)
    n = FREQ_DRAWS
    root = fold_in(prng_key(SAMPLE_SEED), 0).numpy()
    toks = sample_rows(row.expand(n, 16), np.repeat(root[None], n, 0),
                       np.arange(n), np.zeros(n, bool))
    freq = torch.bincount(toks, minlength=16).cpu().numpy() / n
    p = np.exp(row.double().cpu().numpy())
    p /= p.sum()
    z = np.abs(freq - p) / np.sqrt(p * (1 - p) / n)
    assert z.max() <= FREQ_SIGMAS, f"frequency test: {z.max():.2f} sigma"
    return {"bits_equal": True, "gumbel_max_ulp": float(ulps.max()),
            "gumbel_unequal_share": float(np.mean(ulps > 0)),
            "freq_draws": n, "freq_max_sigma": float(z.max()),
            "freq_max_abs": float(np.abs(freq - p).max())}


def sampled_path(pipe, questions, greedy_answers, wave_prompts):
    """The sampled path on the main path's pipeline: the questions
    through two sampled sessions on fresh engines (equal doc ids,
    prompts and tokens asserted); one target request alone and beside 1
    and 3 co-residents (equal tokens asserted); the bucketed prompts
    sampled on waves and on the continuous engine (the equal share is
    reported: bf16, F3)."""
    slm = pipe.slm
    t0 = time.perf_counter()
    first, trace = sampled_session(pipe, questions)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    second, _ = sampled_session(pipe, questions)
    for a, b in zip(first, second):
        assert a.doc_ids == b.doc_ids and a.prompt == b.prompt
        assert a.gen_tokens == b.gen_tokens, ("sampled session tokens "
                                              "differ between two runs")
    check_tokens(gen_results(first), MAX_NEW,
                 slm.cfg.vocab_padded)
    prompts = [slm.encode_prompt(a.prompt) for a in first]
    rng = np.random.default_rng(9)
    others = [rng.integers(4, 500, n_).astype(np.int32)
              for n_ in (40, 90, 130)]
    runs = coresident_runs(slm, prompts[0], others)
    assert all(r == runs[0] for r in runs[1:]), \
        f"sampled tokens depend on co-residents: {runs}"
    wave = slm.wave.generate(wave_prompts, max_new=MAX_NEW, greedy=False,
                             seed=SAMPLE_SEED, continuous=False)
    cont = slm.wave.generate(wave_prompts, max_new=MAX_NEW, greedy=False,
                             seed=SAMPLE_SEED, continuous=True)
    check_tokens(wave + cont, MAX_NEW, slm.cfg.vocab_padded)
    spans = trace.durations("engine", "decode_step")
    active = [r.attrs["active"] for r in trace.query(
        comp="engine", name="decode_step") if r.ph == "B"]
    ttft = sorted(a.ttft_measured_s for a in first)
    return {
        "questions": len(questions), "seed": SAMPLE_SEED,
        "answer_wall_s": wall, "ttft_p50_s": ttft[len(ttft) // 2],
        "decode_tok_s": sum(active) / sum(spans),
        "decode_steps": len(spans),
        "sessions_equal": True, "coresident_runs_equal": True,
        "coresident_tokens": len(runs[0]),
        "equal_to_greedy_share": equal_share(
            gen_results(first),
            gen_results(greedy_answers)),
        "wave_vs_continuous_equal_share": equal_share(wave, cont)}


def draw_cost(slm, prompts):
    """The draw's cost: `sample_rows` over [4, vocab] bf16 logits with
    every row sampled (and every row greedy), wall and device ms a call
    under the profiler; then steady decode steps of fresh engines, 4
    slots greedy and 4 sampled in turns (greedy, sampled, sampled,
    greedy), wall and device ms a step."""
    V = slm.cfg.vocab_padded
    g = torch.Generator(device=DEV).manual_seed(6)
    logits = (4 * torch.randn(4, V, generator=g, device=DEV)).to(
        torch.bfloat16)
    keys = np.stack([fold_in(prng_key(SAMPLE_SEED), r).numpy()
                     for r in range(4)])
    ts = np.arange(4)
    sampled = _profiled(lambda: sample_rows(logits, keys, ts,
                                            np.zeros(4, bool)), 20)
    greedy = _profiled(lambda: sample_rows(logits, keys, ts,
                                           np.ones(4, bool)), 20)
    steps = {"greedy": [], "sampled": []}
    for mode in ("greedy", "sampled", "sampled", "greedy"):
        st = profile_decode_steps(fresh_engine(slm), prompts,
                                  greedy=mode == "greedy")
        steps[mode].append({k: st[k] for k in ("wall_ms", "device_ms",
                                               "device_idle_share")})

    def mean(mode, key):
        vals = [r[key] for r in steps[mode]]
        return None if None in vals else float(np.mean(vals))
    out = {
        "vocab": V, "rows": 4,
        "draw_wall_ms": sampled["wall_ms"],
        "draw_device_ms": sampled["device_ms"],
        "greedy_pick_wall_ms": greedy["wall_ms"],
        "greedy_pick_device_ms": greedy["device_ms"],
        "draw_top_device_kernels": sampled["top_device_kernels"][:3],
        "step_runs": steps,
        "step_wall_ms_greedy": mean("greedy", "wall_ms"),
        "step_wall_ms_sampled": mean("sampled", "wall_ms"),
        "step_device_ms_greedy": mean("greedy", "device_ms"),
        "step_device_ms_sampled": mean("sampled", "device_ms")}
    out["draw_share_of_sampled_step_wall"] = (
        out["draw_wall_ms"] / out["step_wall_ms_sampled"])
    out["sampled_over_greedy_step_wall"] = (
        out["step_wall_ms_sampled"] / out["step_wall_ms_greedy"])
    return out


def appended_doc(i):
    """Appended document i: three sentences naming its own word
    `zeppelin{i}q`, the last carrying its marker `M{i:03d}X`."""
    m = f"zeppelin{i}q"
    place = ("Lisbon", "Osaka", "Quito", "Tallinn")[i % 4]
    return (f"The {m} was first described in {1700 + i}. "
            f"The {m} flew over {place} at dawn. "
            f"Crews of the {m} logged code M{i:03d}X."), m


def window_updates_path(pipe):
    """The window-updates path on the main path's pipeline: N_APPEND
    documents appended (`pipe.docs.append`, `pipe.index.insert`) and
    every fourth asked about through `answer_batch(generate=True)`, which
    adds them to the window index (the rows double: one whole upload);
    each question's document retrieved and its marker in the prompt.
    Retrieval probes every cluster for these questions: an insert routes
    on the centroid graph and a query on exact centroid distances, and at
    the main path's n_probe the share that still finds its document is
    reported. Then N_WI_UPDATE updates and N_WI_REMOVE removes through
    the window index: the refresh copies only those rows into the same
    storage. Then one long document doubles CAPW: one whole upload. The
    device pack equals the host pack bit for bit after each refresh.
    Returns (info, scr_select inputs at the grown CAPW)."""
    wi, emb = pipe.window_index, pipe.embed
    st = wi.stats
    n0 = len(pipe.docs)
    new = [appended_doc(i) for i in range(N_APPEND)]
    t0 = time.perf_counter()
    for text, _ in new:
        pipe.index.insert(len(pipe.docs), emb([text])[0])
        pipe.docs.append(text)
    insert_s = time.perf_counter() - t0
    asked = list(range(0, N_APPEND, 4))
    qs = [f"What is known about the {new[i][1]}?" for i in asked]
    base = (st.grows, st.mirror_uploads, st.mirror_rows, st.block_repacks)

    def held(label):
        d_t, l_t = wi.device_arrays()
        data, lens = wi.pack()
        assert torch.equal(d_t.cpu(), torch.from_numpy(data)), label
        assert torch.equal(l_t.cpu(), torch.from_numpy(lens)), label
        return d_t, l_t

    def found(answers):
        return [n0 + i in a.doc_ids and f"M{i:03d}X" in a.prompt
                for i, a in zip(asked, answers)]
    n_probe = pipe.n_probe
    pipe.n_probe = pipe.index.n_clusters
    try:
        t0 = time.perf_counter()
        answers = pipe.answer_batch(qs, generate=True, max_new=MAX_NEW)
        torch.cuda.synchronize()
        answer_s = time.perf_counter() - t0
    finally:
        pipe.n_probe = n_probe
    assert all(found(answers)), f"appended docs not answered: {found(answers)}"
    at_probe = pipe.answer_batch(qs)
    check_tokens(gen_results(answers),
                 MAX_NEW, pipe.slm.cfg.vocab_padded)
    assert len(wi) == len(pipe.docs)
    assert (st.grows - base[0], st.mirror_uploads - base[1]) == (1, 1)
    d0, _ = held("after the appends")
    rows_after_append = int(d0.shape[0])
    # updates and removes inside the pack's shape: dirty rows only
    ptr, rows0, uploads0 = d0.data_ptr(), st.mirror_rows, st.mirror_uploads
    rng = np.random.default_rng(12)
    touched = rng.choice(n0, N_WI_UPDATE + N_WI_REMOVE, replace=False)
    for di in touched[:N_WI_UPDATE]:
        # its first sentence replaced: as many windows as before
        sents = split_sentences(pipe.docs[int(di)])
        wi.update(int(di), " ".join([f"Revised entry {di}."] + sents[1:]))
    for di in touched[N_WI_UPDATE:]:
        wi.remove(int(di))
    t0 = time.perf_counter()
    wi.pack()
    repack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wi.device_arrays()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    d1, _ = held("after updates and removes")
    assert d1.data_ptr() == ptr and st.mirror_uploads == uploads0, \
        "a refresh inside the pack's shape re-uploaded the pack"
    copied = st.mirror_rows - rows0
    assert copied == N_WI_UPDATE + N_WI_REMOVE, copied
    again = pipe.answer_batch(qs)
    assert [sorted(a.doc_ids) for a in again] == \
        [sorted(a.doc_ids) for a in at_probe]
    # one long document just past CAPW: the pack doubles and is uploaded
    # whole
    capw0 = int(d1.shape[1])
    long_id = n0 + 1
    wi.update(long_id, " ".join(f"The zeppelin1q passed waypoint {j}."
                                for j in range(capw0 + 3)))
    d2, l2 = held("after the CAPW growth")
    assert int(d2.shape[1]) == 2 * capw0 and \
        st.mirror_uploads == uploads0 + 1, (d2.shape, st.mirror_uploads)
    q = torch.tensor(emb(qs + ["The zeppelin1q passed waypoint 17."]),
                     device=DEV)
    ids = torch.tensor([a.doc_ids for a in answers] + [[long_id, n0, 0]],
                       dtype=torch.int32, device=DEV)
    s, w = ops.scr_select(q, d2, l2, ids)
    ps_, pw = ref.scr_select(q, d2, l2, ids)
    err = close("scr_select at the grown CAPW", s, ps_, 1e-5, 1e-5)
    ties = same_or_tied("scr_select at the grown CAPW", w, pw,
                        _win_score(q, d2, ids), 1e-5, 1e-5)
    assert int(l2[long_id]) > capw0
    return {
        "appended": N_APPEND, "asked": len(asked), "insert_s": insert_s,
        "answer_wall_s": answer_s, "answered_all_probes": len(asked),
        "found_at_n_probe_share": float(np.mean(found(at_probe))),
        "n_probe": n_probe, "rows": [n0, rows_after_append],
        "updated": N_WI_UPDATE, "removed": N_WI_REMOVE,
        "rows_copied": copied, "repack_ms": repack_s * 1e3,
        "refresh_ms": refresh_s * 1e3,
        "whole_uploads": st.mirror_uploads - base[1],
        "grows": st.grows - base[0], "capw": [capw0, int(d2.shape[1])],
        "block_repacks": st.block_repacks - base[3],
        "scr_select_grown_err": err, "scr_select_grown_ties": ties,
        "stats": dataclasses.asdict(st)}, (q, d2, l2, ids)


# ----------------------------------------------------------- fire path


class RecordedSession(RagSession):
    """RagSession that records itself, with the path it ran on, in
    SESSIONS: the end of the run checks that no session of a clean path
    counted a failure or a retry. (`MobileRAG.session` builds this class
    once `main` installs it in the rag module.)"""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        SESSIONS.append((CURRENT[0], self))


class PoisonEmbedder:
    """Raises on any text holding the POISON marker (a scripted embedder
    failure that hits exactly one query), else embeds as `inner`."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, texts):
        if any(POISON in t for t in texts):
            raise RuntimeError("embedder down for this query")
        return self.inner(texts)


@contextlib.contextmanager
def patched(obj, name, value):
    """`obj.name = value` inside the block; the old binding is restored
    after it (an attribute `obj` did not hold itself, a method of its
    class, is deleted again)."""
    had = name in vars(obj)
    old = vars(obj).get(name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        if had:
            setattr(obj, name, old)
        else:
            delattr(obj, name)


def _raise_runtime(*a, **kw):
    raise RuntimeError("injected stage fault")


def _raise_kernel(*a, **kw):
    raise ops.KernelError("injected kernel fault")


def expect_kernel_error(fn):
    """Call `fn`, which must raise `ops.KernelError`: a kernel fault
    that a ladder absorbed fails the run (any other exception propagates
    as it is)."""
    try:
        fn()
    except ops.KernelError:
        return
    raise AssertionError("a kernel fault was absorbed")


def load_trace_check():
    """tools/trace_check.py (stdlib only, not a package), loaded by path."""
    path = Path(__file__).resolve().parent / "tools" / "trace_check.py"
    spec = importlib.util.spec_from_file_location("trace_check", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_trace(sink, label):
    """Export `sink` as JSONL under build/traces/ (gitignored) and hold
    the export to tools/trace_check.py as a complete trace. Returns the
    loaded records."""
    tc = load_trace_check()
    out = Path(__file__).resolve().parent / "build" / "traces"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{label}.jsonl"
    assert sink.export_jsonl(path) == len(sink)
    recs = tc.load_jsonl(path)
    viol = tc.check_records(recs, complete=True)
    assert not viol, f"{label} trace: {len(viol)} violations: {viol[:5]}"
    return recs


def drain_session(sess, max_steps=5000):
    """Step `sess` until it drains (at most `max_steps` steps); every
    event it produced."""
    events = []
    for _ in range(max_steps):
        if not (sess.pending or sess._events_out):
            return events
        events += sess.step()
    raise AssertionError(f"session not drained in {max_steps} steps")


def terminal_partition(sess, events, rids):
    """Every request ends in exactly one terminal state (one terminal
    event each, the state it holds) and the counters add up: completed +
    shed_* + failed = submitted. Returns the count of each state."""
    term = collections.Counter(e.req_id for e in events
                               if e.kind in ("done", "shed", "failed"))
    assert all(term[r] == 1 for r in rids), term
    states = collections.Counter(sess.requests[r].state for r in rids)
    assert set(states) <= {"done", "shed", "failed"}, states
    c = sess.counters
    assert c.submitted == len(rids)
    assert (c.completed + c.shed_deadline + c.shed_overload + c.shed_oversize
            + c.shed_slo + c.failed) == c.submitted, c
    assert states["done"] == c.completed and states["failed"] == c.failed
    return dict(states)


def session_under_fire(pipe, questions, clean, main_answers):
    """Part 1: a traced session of admission bound 8 over the pipeline
    wrapped in a ChaosPipeline (FIRE_PLAN: retrieval errors at calls 0,
    2, 5, 9 and 10), fed the questions with the poisoned query second,
    one submission a step. Every request ends in one terminal state, the
    counters add up, the poisoned query fails, the trace is clean; a done
    request whose max_new was not clamped has the doc ids and prompt of
    the clean answer of its question (`clean`), and the share of its
    tokens equal to the main path's is reported (bf16, F3)."""
    sink = TraceSink()
    cp = ChaosPipeline(pipe, FaultPlan(**FIRE_PLAN), trace=sink)
    queries = questions[:1] + [POISON] + questions[1:]
    with patched(pipe, "embed", PoisonEmbedder(pipe.embed)):
        sess = RecordedSession(cp, max_new=MAX_NEW, slots=pipe.slm.SLOTS,
                               retrieve_chunk=4, max_pending=8, trace=sink)
        rids, events = [], []
        t0 = time.perf_counter()
        for q in queries:
            rids.append(sess.submit(q))
            events += sess.step()
        events += drain_session(sess)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    states = terminal_partition(sess, events, rids)
    assert sess.requests[rids[1]].state == "failed", "poison not failed"
    assert sess.counters.failed >= 1 and sess.counters.retrieval_retries >= 1
    check_trace(sink, "fire_session")
    by_q = {q: (c, m) for q, c, m in zip(questions, clean, main_answers)}
    compared = same = positions = 0
    for r, q in zip(rids, queries):
        req = sess.requests[r]
        if req.state != "done" or req.max_new != MAX_NEW:
            continue
        c, m = by_q[q]
        assert req.answer.doc_ids == c.doc_ids and \
            req.answer.prompt == c.prompt, f"request {r} differs from clean"
        if req.answer.prompt == m.prompt:
            compared += 1
            same += sum(x == y for x, y in zip(req.answer.gen_tokens,
                                               m.gen_tokens))
            positions += max(len(req.answer.gen_tokens), len(m.gen_tokens))
    return {"requests": len(rids), "states": states,
            "counters": dataclasses.asdict(sess.counters),
            "injected": cp.injected, "answer_wall_s": wall,
            "unclamped_done_equal_clean": sum(
                sess.requests[r].state == "done"
                and sess.requests[r].max_new == MAX_NEW for r in rids),
            "tokens_compared_requests": compared,
            "equal_token_share_main_path": same / positions if positions
            else None}


def deadline_part(pipe, questions):
    """Part 2: a request with a FIRE_DEADLINE_S deadline, stepped to its
    first token, then left until the deadline passes: the next step
    sheds it ("deadline") and cancels it in the engine (pending 0), and
    the freed slot serves the next request."""
    sink = TraceSink()
    sess = pipe.session(max_new=MAX_NEW, slots=pipe.slm.SLOTS, trace=sink)
    cancelled = sess.engine.cancelled
    rid = sess.submit(questions[0], deadline_s=FIRE_DEADLINE_S)
    t0 = time.perf_counter()
    events, tokens = [], 0
    while tokens == 0:
        assert time.perf_counter() - t0 < 10 * FIRE_DEADLINE_S
        evs = sess.step()
        assert not any(e.kind == "shed" for e in evs), \
            "the deadline passed before the first token"
        events += evs
        tokens = sum(e.kind == "token" and e.req_id == rid for e in evs)
    first_token_s = time.perf_counter() - t0
    time.sleep(max(0.0, sess.requests[rid].expires_s
                   - time.perf_counter()) + 0.01)
    evs = sess.step()
    events += evs
    assert [(e.req_id, e.payload) for e in evs if e.kind == "shed"] == \
        [(rid, "deadline")], evs
    assert sess.counters.shed_deadline == 1
    assert sess.engine.pending == 0
    assert sess.engine.cancelled == cancelled + 1
    nxt = sess.run([questions[1]])[0]
    assert nxt is not None and 1 <= len(nxt.gen_tokens) <= MAX_NEW
    check_trace(sink, "fire_deadline")
    return {"deadline_s": FIRE_DEADLINE_S, "first_token_s": first_token_s,
            "tokens_before_shed": tokens,
            "next_request_tokens": len(nxt.gen_tokens)}


def slo_part(pipe, questions):
    """Part 3: a traced session runs the questions (all submitted at
    once) to warm the trace window; `SLOController.stage_costs()` reads
    the card's p95 stage costs from it; then a second session on the same
    sink runs the questions at an SLO of half the first run's p50
    latency. Its degrades and sheds are reported; the terminal partition
    and a clean trace are asserted."""
    sink = TraceSink()
    warm = pipe.session(max_new=MAX_NEW, slots=pipe.slm.SLOTS, trace=sink)
    rids = [warm.submit(q) for q in questions]
    events = drain_session(warm)
    terminal_partition(warm, events, rids)
    assert warm.counters.completed == len(questions)
    lat = sorted(warm.requests[r].latency_s for r in rids)
    p50 = lat[len(lat) // 2]
    costs = {k[:-2] + "_ms": v * 1e3
             for k, v in SLOController(sink).stage_costs().items()}
    print("SLO stage costs (p95 ms: retrieve a query, prefill chunk, decode "
          "step):", json.dumps(costs))
    slo = pipe.session(max_new=MAX_NEW, slots=pipe.slm.SLOTS, trace=sink,
                       slo_s=p50 / 2)
    rids = [slo.submit(q) for q in questions]
    events = drain_session(slo)
    states = terminal_partition(slo, events, rids)
    check_trace(sink, "fire_slo")
    return {"clean_latency_p50_s": p50, "slo_s": p50 / 2,
            "stage_costs_ms": costs,
            "states": states, "degraded_slo": slo.counters.degraded_slo,
            "shed_slo": slo.counters.shed_slo,
            "counters": dataclasses.asdict(slo.counters)}


def chaos_soak(slm, prompts):
    """Part 4: `SlotScheduler` over 3 clones of the main path's continuous
    engine (full width, bf16), under the reference's soak plan
    (SOAK_PLAN, tests/test_faults.py): 32 requests of the main path's
    condensed prompts, cycled, max_new 2-5, every eighth with a 2 ms
    deadline; then the calm tail until a drained replica recovers. The
    partition, a drain and a recovery, no page held by a drained engine,
    every page free after the prefix caches drop, and a clean trace."""
    sink = TraceSink()
    engines = [slm.engine.clone() for _ in range(3)]
    for e in engines:
        e.warmup()
        e.trace = sink
    wrapped = wrap_replicas(engines, FaultPlan(**SOAK_PLAN))
    sched = SlotScheduler(wrapped, stall_s=0.5, probe_cooldown_s=0.05,
                          max_strikes=2, max_hedges=3, max_probes=None,
                          deadline_s=30.0, trace=sink)
    rng = np.random.default_rng(1)
    rids = [sched.submit(prompts[i % len(prompts)], int(rng.integers(2, 6)),
                         deadline_s=0.002 if i % 8 == 7 else 30.0)
            for i in range(SOAK_REQUESTS)]
    t0 = time.perf_counter()
    done = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done_rids = [c.rid for c in done]
    shed_rids = [sh.rid for sh in sched.shed]
    assert len(set(done_rids)) == len(done_rids)
    assert len(set(shed_rids)) == len(shed_rids)
    assert set(done_rids).isdisjoint(shed_rids)
    assert set(done_rids) | set(shed_rids) == set(rids)
    c = sched.counters
    assert c.completed + c.shed_deadline + c.shed_queue + c.shed_engine == \
        len(rids), c
    assert c.drains >= 1, c
    for w in wrapped:
        st = w.inner.page_stats()
        assert w.inner.pending == 0 and st.mapped_refs == st.retained, st
    counters_run = dataclasses.asdict(c)
    t1 = time.perf_counter()
    tail = 0
    while sched.counters.recoveries < 1:
        assert tail < 40, "no drained replica recovered in the calm tail"
        batch = [sched.submit(rng.integers(4, 500, size=12).astype(np.int32),
                              3) for _ in range(4)]
        assert {x.rid for x in sched.run()} == set(batch)
        tail += 1
        time.sleep(0.05)
    tail_wall = time.perf_counter() - t1
    for w in wrapped:
        w.inner.drop_prefix_cache()
        st = w.inner.page_stats()
        assert st.free == st.total and st.mapped_refs == 0, st
    recs = check_trace(sink, "fire_soak")
    assert sum(r["comp"] == "chaos" for r in recs) == \
        sum(sum(w.injected.values()) for w in wrapped)
    return {"requests": len(rids), "replicas": len(engines),
            "wall_s": wall, "tail_batches": tail, "tail_wall_s": tail_wall,
            "completed": len(done), "shed": collections.Counter(
                sh.reason for sh in sched.shed),
            "counters_run": counters_run,
            "counters": dataclasses.asdict(sched.counters),
            "injected": [w.injected for w in wrapped],
            "hedged_completions": sum(x.hedged for x in done),
            "utilisation": [w.inner.utilisation() for w in wrapped],
            "latency_p50_s": float(np.median([x.latency_s for x in done])),
            "trace_records": len(recs)}


def wave_scheduler_part(slm, bucket_prompts):
    """Part 4, end: the legacy wave `Scheduler` over two callables of the
    main path's wave Engine, 8 bucketed prompts."""
    def replica(ps, max_new):
        return [r.tokens for r in slm.wave.generate(ps, max_new=max_new,
                                                    continuous=False)]
    ws = Scheduler([replica, replica], max_wave=8)
    rids = [ws.submit(p, MAX_NEW) for p in bucket_prompts[:8]]
    t0 = time.perf_counter()
    done = ws.run()
    wall = time.perf_counter() - t0
    assert sorted(x.rid for x in done) == rids
    check_tokens(done, MAX_NEW, slm.cfg.vocab_padded)
    return {"requests": len(rids), "wall_s": wall,
            "served": [s.served for s in ws.state],
            "strikes": [s.strikes for s in ws.state]}


def full_docs_prompt(docs, query, ids):
    """The reference's fallback prompt (`RAGBase._make_prompt`): the full
    retrieved documents, in retrieval order."""
    ctx = "\n\n".join(f"[Doc {i + 1}] {docs[i]}" for i in ids)
    return f"Context:\n{ctx}\n\nQuestion: {query}\nAnswer:"


def fallback_part(pipe, questions, prompts):
    """Part 5: each fallback counts exactly what was injected. An index
    fault (`search_device_batched` raising a RuntimeError) adds one
    `retrieval_fallbacks` and serves the last good batch's ids; an SCR
    fault (`apply_scr_batch` raising) adds one `scr_fallbacks` and
    serves the full documents. A `KernelError` from a kernel wrapper
    (`ops.ecoscan`; `ops.decode_attention_paged` under a
    `SlotScheduler`) propagates out of `answer_batch`, `RagSession.step`
    and `SlotScheduler.run` and moves no counter."""
    qs = questions[:4]
    r0, s0 = pipe.retrieval_fallbacks, pipe.scr_fallbacks
    last = [list(r) for r in pipe._last_good_ids]
    with patched(pipe.index, "search_device_batched", _raise_runtime):
        stale = pipe.answer_batch(qs)
    assert (pipe.retrieval_fallbacks, pipe.scr_fallbacks) == (r0 + 1, s0)
    for i, a in enumerate(stale):
        assert sorted(a.doc_ids) == sorted(last[i % len(last)])
    with patched(rag_mod, "apply_scr_batch", _raise_runtime):
        full = pipe.answer_batch(qs)
    assert (pipe.retrieval_fallbacks, pipe.scr_fallbacks) == (r0 + 1, s0 + 1)
    for q, a, ids in zip(qs, full, pipe._last_good_ids):
        assert a.scr is None and a.doc_ids == ids
        assert a.prompt == full_docs_prompt(pipe.docs, q, ids)
    counts = (pipe.retrieval_fallbacks, pipe.scr_fallbacks)
    with patched(ops, "ecoscan", _raise_kernel):
        expect_kernel_error(lambda: pipe.answer_batch(qs))
        sess = pipe.session(max_new=MAX_NEW, slots=pipe.slm.SLOTS,
                            trace=TraceSink())
        for q in qs:
            sess.submit(q)
        before = dataclasses.asdict(sess.counters)
        expect_kernel_error(sess.step)
        assert dataclasses.asdict(sess.counters) == before
    assert (pipe.retrieval_fallbacks, pipe.scr_fallbacks) == counts
    sched = SlotScheduler([pipe.slm.engine.clone() for _ in range(2)])
    for p_ in prompts[:4]:
        sched.submit(p_, 4)
    before = dataclasses.asdict(sched.counters)
    with patched(ops, "decode_attention_paged", _raise_kernel):
        expect_kernel_error(sched.run)
    assert dataclasses.asdict(sched.counters) == before
    assert all(h.healthy and h.strikes == 0 for h in sched.state)
    return {"retrieval_fallbacks": pipe.retrieval_fallbacks - r0,
            "scr_fallbacks": pipe.scr_fallbacks - s0,
            "kernel_faults_propagated": ["answer_batch (ecoscan)",
                                         "RagSession.step (ecoscan)",
                                         "SlotScheduler.run "
                                         "(decode_attention_paged)"]}


def fire_path(pipe, questions, main_answers, bucket_prompts):
    """The fire path on the main path's pipeline: the session under fire,
    a deadline, SLO admission, the chaos soak and the wave scheduler,
    then the fallbacks and the kernel-fault rule. The shared engine's
    trace sink is restored after."""
    slm = pipe.slm
    engine_trace = slm.engine.trace
    try:
        clean = pipe.answer_batch(questions)
        prompts = [slm.encode_prompt(a.prompt) for a in main_answers]
        t0 = time.perf_counter()
        info = {"session": session_under_fire(pipe, questions, clean,
                                              main_answers),
                "clean_equal_main_path": sum(
                    c.prompt == m.prompt and c.doc_ids == m.doc_ids
                    for c, m in zip(clean, main_answers))}
        info["deadline"] = deadline_part(pipe, questions)
        info["slo"] = slo_part(pipe, questions)
        info["soak"] = chaos_soak(slm, prompts)
        info["wave_scheduler"] = wave_scheduler_part(slm, bucket_prompts)
        info["fallbacks"] = fallback_part(pipe, questions, prompts)
        torch.cuda.synchronize()
        info["wall_s"] = time.perf_counter() - t0
    finally:
        slm.engine.trace = engine_trace
    return info


# --------------------------------------------------------- durable path


class CountingEmbedder:
    """Embeds as `inner` and counts the texts it was given."""

    def __init__(self, inner):
        self.inner = inner
        self.texts = 0

    def __call__(self, texts):
        self.texts += len(texts)
        return self.inner(texts)


@contextlib.contextmanager
def timed_calls(obj, name, out):
    """Append the host ms of each `obj.name(...)` call inside the block
    to `out` (the call's own result passes through)."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            out.append((time.perf_counter() - t) * 1e3)
    with patched(obj, name, timed):
        yield


def _tree_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _pct(xs, q):
    return float(np.percentile(xs, q)) if xs else None


def _same_bits(a, b):
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def durable_journal(pipe, root, hq_vs, keep):
    """Part 2 of the durable path: the journaled ops on the live index
    (N_DUR_INSERT inserts of perturbed corpus vectors under new ids,
    N_DUR_DELETE deletes of corpus ids outside `keep`) and window index
    (N_DUR_ADD adds, N_DUR_UPDATE updates, N_DUR_REMOVE removes), each
    append fsync'd (its ms recorded); then both parts loaded into fresh
    objects: WAL replayed op for op, device search of `hq_vs` bit-equal
    to the live index's, the window tensors bit-equal."""
    idx, wi = pipe.index, pipe.window_index
    rng = np.random.default_rng(23)
    n = len(pipe.docs)
    src = rng.choice(n, N_DUR_INSERT, replace=False)
    vecs = (pipe.embed([pipe.docs[i] for i in src])
            + 0.002 * rng.standard_normal((N_DUR_INSERT, idx.dim))
            ).astype(np.float32)
    gone = [int(v) for v in rng.permutation(n)
            if int(v) not in keep and int(v) in idx.assign][:N_DUR_DELETE]
    touched = [int(v) for v in rng.permutation(n)
               if int(v) not in keep][:N_DUR_UPDATE + N_DUR_REMOVE]
    wal_ms = []
    t0 = time.perf_counter()
    with timed_calls(idx._journal, "append", wal_ms), \
            timed_calls(wi._journal, "append", wal_ms):
        for j, v in enumerate(vecs):
            idx.insert(DUR_ID0 + j, v)
        for v in gone:
            idx.delete(v)
        for i in range(N_DUR_ADD):
            wi.add(appended_doc(1000 + i)[0])
        for di in touched[:N_DUR_UPDATE]:
            sents = split_sentences(wi.texts[di])
            wi.update(di, " ".join([f"Durable revision {di}."] + sents[1:]))
        for di in touched[N_DUR_UPDATE:]:
            wi.remove(di)
    ops_s = time.perf_counter() - t0
    n_eco, n_win = N_DUR_INSERT + len(gone), N_DUR_ADD + len(touched)
    assert len(wal_ms) == n_eco + n_win, len(wal_ms)
    t0 = time.perf_counter()
    ev = EcoVector.load(os.path.join(root, "ecovector"),
                        storage_dir=os.path.join(root, "replay_spill"),
                        device=DEV)
    eco_load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wi2 = WindowIndex.load(pipe.embed, os.path.join(root, "windows"),
                           device=DEV)
    win_load_s = time.perf_counter() - t0
    assert (ev.stats.wal_replayed, wi2.stats.wal_replayed) == (n_eco, n_win)
    assert ev.assign == idx.assign and wi2.texts == wi.texts
    ids, d = idx.search_device_batched(hq_vs, k=10, n_probe=pipe.n_probe)
    ids2, d2 = ev.search_device_batched(hq_vs, k=10, n_probe=pipe.n_probe)
    assert np.array_equal(ids, ids2) and _same_bits(d, d2), \
        "the replayed index searches other than the live one"
    wd, wl = wi.device_arrays()
    wd2, wl2 = wi2.device_arrays()
    assert torch.equal(wd, wd2) and torch.equal(wl, wl2), \
        "the replayed window pack differs from the live one"
    info = {"index_ops": n_eco, "window_ops": n_win, "ops_s": ops_s,
            "wal_append_ms_p50": _pct(wal_ms, 50),
            "wal_append_ms_p95": _pct(wal_ms, 95),
            "wal_bytes": os.path.getsize(idx._journal.wal_path(0))
            + os.path.getsize(wi._journal.wal_path(0)),
            "ecovector_load_s": eco_load_s, "window_load_s": win_load_s,
            "window_reembedded_windows": wi2.stats.windows_embedded,
            "queries_bit_equal": len(hq_vs)}
    del ev, wi2, wd2, wl2
    torch.cuda.empty_cache()
    return info


def tier_budget(pipe, root, q16, budget, live, tier_inputs):
    """Part 3 of the durable path at one budget: `TieredEcoVector.load` of
    the saved index (its WAL replayed), the budget set and the tiers
    activated (device bytes within the budget or the centroid floor,
    equal to the tensors held and to the `memory_allocated` delta up to
    the caching allocator's rounding: 512-byte blocks, and the unsplit
    tail of a large segment, under 2 MiB a tensor), then TIER_ROUNDS rounds of the 16
    questions: ids and distances bit-equal to the live all-resident
    index's every round. At budget 0.25 the first round's ecoscan inputs
    (hot rows + cold scratch, the block map) go to `tier_inputs`."""
    tv = TieredEcoVector.load(os.path.join(root, "ecovector"),
                              storage_dir=os.path.join(root, f"tier_{budget}"),
                              device=DEV)
    full = tv.all_resident_bytes()
    b = (None if budget is None else tv._fixed_device_bytes() // 2
         if budget == "below" else int(budget * full))
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        tv.set_device_budget(b)
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tv.activate()
        torch.cuda.synchronize()
        activate_s = time.perf_counter() - t0
        m1 = torch.cuda.memory_allocated()
        all_cold = any("serving all-cold" in str(w.message) for w in warned)
    assert all_cold == (budget == "below"), (budget, all_cold)
    held_t = tv.device_tensors()
    held = sum(t.numel() * t.element_size() for t in held_t)
    assert tv.device_resident_bytes() == held, (tv.device_resident_bytes(),
                                                held)
    # the caching allocator rounds a block up to 512 bytes, and leaves a
    # large segment's tail (< 2 MiB, never split off) in its block
    assert 0 <= (m1 - m0) - held < len(held_t) * 2 ** 21, (m1 - m0, held)
    if b is not None:
        assert held <= max(b, tv._fixed_device_bytes()), (held, b)
    live_ids, live_d = live
    gather_ms, search_ms, hot_share = [], [], []
    real = ops.ecoscan_launch

    def record(q, data, lens, probes, k, block_map=None, tile=None):
        # the first launch at 0.25 whose scan holds cold scratch rows
        if budget == 0.25 and not tier_inputs and \
                data.shape[0] > len(tv._row_cluster):
            tier_inputs.extend([q, data, lens, probes, k, block_map])
        return real(q, data, lens, probes, k, block_map, tile=tile)
    s = tv.stats
    with timed_calls(tv, "_gather_cold", gather_ms), \
            patched(ops, "ecoscan_launch", record):
        for _ in range(TIER_ROUNDS):
            h0, c0 = s.tier_hot_hits, s.tier_cold_hits
            t0 = time.perf_counter()
            ids, d = tv.search_device_batched(q16, k=10,
                                              n_probe=pipe.n_probe)
            search_ms.append((time.perf_counter() - t0) * 1e3)
            assert np.array_equal(ids, live_ids) and _same_bits(d, live_d), \
                f"tiered search at budget {budget} differs from all-resident"
            hits = s.tier_hot_hits - h0 + s.tier_cold_hits - c0
            hot_share.append((s.tier_hot_hits - h0) / hits)
            if b is not None:
                assert tv.device_resident_bytes() <= max(
                    b, tv._fixed_device_bytes())
    info = {"budget": budget, "budget_bytes": b, "all_resident_bytes": full,
            "device_resident_bytes": tv.device_resident_bytes(),
            "memory_allocated_delta": m1 - m0, "hot_rows":
            len(tv._row_cluster), "hot": len(tv.hot_clusters()),
            "cold": len(tv.cold_clusters()), "cap": tv._cap,
            "wal_replayed": s.wal_replayed, "activate_s": activate_s,
            "hot_hit_share_by_round": hot_share,
            "promotions": s.promotions, "demotions": s.demotions,
            "search_ms_first": search_ms[0], "search_ms_last": search_ms[-1],
            "search_ms_p50": _pct(search_ms, 50),
            "cold_gather_ms_p50": _pct(gather_ms, 50),
            "cold_gathers": len(gather_ms),
            "cold_pack_bytes": tv._cold.file_bytes()}
    return info


def durable_path(pipe, questions, hq_vs, main_answers, main_build_s):
    """The durable path on the main path's pipeline, after the fire path
    (the window-updates path's documents included), in a temp directory
    removed at the end: (1) `save_retrieval` (seconds and bytes of each
    part); (2) `durable_journal`; (3) `tier_budget` at each of
    TIER_BUDGETS, beside the all-resident search's ms; (4) the compaction
    (`save_retrieval` again: generation 1, empty WALs), then
    `MobileRAG(retrieval_state=, device_budget_bytes=0.25)` with the main
    path's weights: no kmeans_assign launch and no document embedded
    while it is built; its `answer_batch(generate=True)` of the 16
    questions gives the live pipeline's doc ids and prompts (the equal
    token share reported: bf16), without a fallback. Returns (info, the
    ecoscan inputs at the tier shape)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    idx, wi = pipe.index, pipe.window_index
    info = {}
    rpipe = None
    try:
        t_path = time.perf_counter()
        part_s = {}
        with timed_calls(idx, "save", part_s.setdefault("ecovector", [])), \
                timed_calls(wi, "save", part_s.setdefault("windows", [])):
            t0 = time.perf_counter()
            pipe.save_retrieval(root)
            save_s = time.perf_counter() - t0
        info["save"] = {
            "s": save_s, "part_s": {k: v[0] / 1e3 for k, v in part_s.items()},
            "part_bytes": {k: _tree_bytes(os.path.join(root, k))
                           for k in part_s},
            "window_pack": list(wi.pack()[0].shape)}
        keep = {i for a in main_answers for i in a.doc_ids}
        info["journal"] = durable_journal(pipe, root, hq_vs, keep)
        q16 = np.asarray(hq_vs[:len(questions)], np.float32)
        live = idx.search_device_batched(q16, k=10, n_probe=pipe.n_probe)
        live_ms = []
        for _ in range(TIER_ROUNDS):
            t0 = time.perf_counter()
            idx.search_device_batched(q16, k=10, n_probe=pipe.n_probe)
            live_ms.append((time.perf_counter() - t0) * 1e3)
        tier_inputs = []
        info["tiers"] = [tier_budget(pipe, root, q16, b, live, tier_inputs)
                         for b in TIER_BUDGETS]
        info["all_resident_search_ms_p50"] = _pct(live_ms, 50)
        assert len(tier_inputs) == 6, "no tiered scan over cold scratch"
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pipe.save_retrieval()
        info["compaction_s"] = time.perf_counter() - t0
        for part, obj in (("ecovector", idx), ("windows", wi)):
            assert obj._journal.generation == 1 and \
                obj._journal.wal_records() == 0, part
        counted = CountingEmbedder(pipe.embed)
        params = dict(pipe.slm.model.named_parameters())
        rsink = TraceSink()
        k0 = ops.launch_counts()["kmeans_assign"]
        t0 = time.perf_counter()
        rpipe = MobileRAG(pipe.docs, counted, top_k=3, retrieval_state=root,
                          device_budget_bytes=0.25, gen_config=GEN_CONFIG,
                          gen_params=params, seed=0, trace=rsink, device=DEV)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        assert counted.texts == 0, counted.texts
        assert ops.launch_counts()["kmeans_assign"] == k0
        assert isinstance(rpipe.index, TieredEcoVector)
        live_ans = pipe.answer_batch(questions, generate=True,
                                     max_new=MAX_NEW)
        t0 = time.perf_counter()
        got = rpipe.answer_batch(questions, generate=True, max_new=MAX_NEW)
        torch.cuda.synchronize()
        answer_s = time.perf_counter() - t0
        assert [a.doc_ids for a in got] == [a.doc_ids for a in live_ans]
        assert [a.prompt for a in got] == [a.prompt for a in live_ans]
        check_tokens(gen_results(got), MAX_NEW, rpipe.slm.cfg.vocab_padded)
        assert (rpipe.retrieval_fallbacks, rpipe.scr_fallbacks) == (0, 0)
        steps = rsink.durations("engine", "decode_step")
        active = [r.attrs["active"] for r in rsink.query(
            comp="engine", name="decode_step") if r.ph == "B"]
        ttft = sorted(a.ttft_measured_s for a in got)
        info["restore"] = {
            "construction_s": restore_s, "main_build_s": main_build_s,
            "kmeans_assign_launches": 0, "documents_embedded": 0,
            "budget_bytes": rpipe.index.device_budget_bytes,
            "device_resident_bytes": rpipe.index.device_resident_bytes(),
            "hot": len(rpipe.index.hot_clusters()),
            "cold": len(rpipe.index.cold_clusters()),
            "answer_wall_s": answer_s,
            "doc_ids_equal": len(got), "prompts_equal": len(got),
            "equal_token_share": equal_share(gen_results(got),
                                             gen_results(live_ans)),
            "ttft_p50_s": ttft[len(ttft) // 2],
            "decode_tok_s": sum(active) / sum(steps),
            "query_texts_embedded": counted.texts}
        info["wall_s"] = time.perf_counter() - t_path
        return info, tier_inputs
    finally:
        # the live index and window index stop journaling into `root`
        for obj in (idx, wi):
            if obj._journal is not None:
                obj._journal.close()
            obj._journal = obj._persist_root = None
        pipe.retrieval_state = None
        if rpipe is not None:
            shutil.rmtree(rpipe.index.storage_dir, ignore_errors=True)
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rag_mod.RagSession = RecordedSession
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
        "index_build_split_s": dict(pipe.index.timings),
    }
    print("main path:", json.dumps(main))

    # ---- legacy SCR path: the same pipeline without the window index
    legacy_sink = TraceSink()

    def legacy_path():
        t0 = time.perf_counter()
        lpipe = MobileRAG(corpus.docs, embed, top_k=3, use_window_index=False,
                          index=pipe.index, gen_config=GEN_CONFIG, seed=0,
                          trace=legacy_sink, device=DEV)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = lpipe.answer_batch(questions, generate=True, max_new=MAX_NEW)
        torch.cuda.synchronize()
        return out, t1 - t0, time.perf_counter() - t1, lpipe
    (legacy, l_build, l_wall, lpipe), legacy_launches = drive("legacy",
                                                              legacy_path)
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
        # reported, not asserted: both pipelines retrieve from the same
        # index, so their doc sets differ only if the retrieval does
        "same_doc_set_share": float(np.mean([
            set(a.doc_ids) == set(b.doc_ids)
            for a, b in zip(legacy, answers)])),
        "windows_per_query_mean": float(np.mean([
            sum(len(_windows(split_sentences(corpus.docs[i])))
                for i in a.doc_ids) for a in legacy])),
    }
    print("legacy SCR path:", json.dumps(legacy_info))
    w_leg, q_leg = legacy_windows(legacy[0], corpus.docs, embed, questions[0])

    # ---- EcoVector host search on the main path's index
    (hq_vs, h_ids, h_times, h_bytes, h_answers, hpipe), host_launches = \
        drive("host_search", lambda: host_search_phase(pipe, embed,
                                                       corpus.docs, questions))
    assert host_launches["ecoscan"] == 0, host_launches
    print("EcoVector host search:", json.dumps(host_search_info(
        pipe, hq_vs, h_ids, h_times, h_bytes, h_answers, answers)))

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

    # ---- int8 KV: the same weights with kv_quant, wave and continuous
    q8_lm = DenseLM(dataclasses.replace(GEN_CONFIG, kv_quant=True),
                    device=dev, params=dict(slm.model.named_parameters()))
    q8_eng = Engine(q8_lm, max_len=slm.MAX_PROMPT + slm.MAX_NEW,
                    eos_id=slm.tokenizer.eos_id,
                    prefill_chunk=slm.PREFILL_CHUNK, slots=slm.SLOTS,
                    page_size=slm.PAGE_SIZE)
    q8_ce = traced_continuous(q8_eng, slm.SLOTS)
    (i8_wave, i8_cont), int8_launches = drive("int8", lambda: [
        q8_eng.generate(prompts, max_new=MAX_NEW, continuous=c)
        for c in (False, True)])
    check_tokens(i8_wave + i8_cont, MAX_NEW, vocab)
    i8_info = {
        "wave": wave_summary(i8_wave),
        "continuous": continuous_summary(q8_ce, i8_cont),
        "bf16_pool_bytes_per_position_head_tensor": sum(
            t.numel() * t.element_size() for t in slm.engine.cache.values())
        / (2 * math.prod(slm.engine.cache["k"].shape[:4])),
        # reported, not asserted: bf16 activations (F3)
        "greedy_equal_share_wave_continuous": equal_share(i8_wave, i8_cont),
        "greedy_equal_share_int8_bf16_wave": equal_share(i8_wave, wave),
        "greedy_equal_share_int8_bf16_continuous": equal_share(i8_cont,
                                                               cont)}
    print("int8 KV path (qwen2.5-0.5B):", json.dumps(i8_info))
    _, wc8 = q8_lm.prefill(torch.tensor(np.stack(big), dtype=torch.long,
                                        device=dev))
    wc8 = q8_eng._grow_cache(wc8)
    i8_wave_in = [wc8[n][0].contiguous() for n in ("k", "k_s", "v", "v_s")]
    i8_pool = [q8_ce.cache[n][0].clone() for n in ("k", "k_s", "v", "v_s")]
    del q8_lm, q8_eng, q8_ce, wc8

    # ---- MoE: granite-moe-1b-a400m at full width, wave and continuous
    moe_lm = MoELM(MOE_CONFIG, device=dev, seed=2)
    mrng = np.random.default_rng(21)
    moe_prompts = [mrng.integers(4, MOE_CONFIG.vocab_size, len(p_)
                                 ).astype(np.int32) for p_ in prompts]
    moe_eng = Engine(moe_lm, max_len=slm.MAX_PROMPT + slm.MAX_NEW,
                     eos_id=-1, prefill_chunk=slm.PREFILL_CHUNK,
                     slots=slm.SLOTS, page_size=slm.PAGE_SIZE)
    moe_ce = traced_continuous(moe_eng, slm.SLOTS)
    (m_wave, m_cont), moe_launches = drive("moe", lambda: [
        moe_eng.generate(moe_prompts, max_new=MAX_NEW, continuous=c)
        for c in (False, True)])
    check_tokens(m_wave + m_cont, MAX_NEW, MOE_CONFIG.vocab_padded)
    moe_info = {
        "experts": MOE_CONFIG.moe.num_experts, "top_k": MOE_CONFIG.moe.top_k,
        "param_gb": sum(p_.numel() * p_.element_size()
                        for p_ in moe_lm.parameters()) / 1e9,
        "wave": wave_summary(m_wave),
        "continuous": continuous_summary(moe_ce, m_cont),
        # reported, not asserted: bf16 (F3)
        "greedy_equal_share_wave_continuous": equal_share(m_wave, m_cont),
        "decode_step_profile": profile_decode_steps(moe_ce,
                                                    moe_prompts[:4])}
    print("MoE path (granite-moe-1b-a400m):", json.dumps(moe_info))
    # layer 0 of the MoE pool and of its largest wave's grown cache: the
    # attention kernels' inputs at the moe path's grouping
    moe_pool = [moe_ce.cache[n][0].clone() for n in ("k", "v")]
    moe_big = [p_ for p_ in moe_prompts if len(p_) == len(big[0])]
    _, mwc = moe_lm.prefill(torch.tensor(np.stack(moe_big), dtype=torch.long,
                                         device=dev))
    mwc = moe_eng._grow_cache(mwc)
    moe_wave_kv = [mwc[n][0].contiguous() for n in ("k", "v")]
    del moe_lm, moe_eng, moe_ce, mwc
    torch.cuda.empty_cache()

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
    # ---- the same model and prompts on the continuous engine: ring pages
    h2o_c_eng = Engine(h2o, max_len=H2O_PROMPT + MAX_NEW, eos_id=-1,
                       slots=2)
    h2o_ce = traced_continuous(h2o_c_eng, 2)
    h2o_cres, h2o_c_launches = drive("h2o_continuous", lambda:
                                     h2o_c_eng.generate(hp, max_new=MAX_NEW,
                                                        continuous=True))
    check_tokens(h2o_cres, MAX_NEW, H2O_CONFIG.vocab_padded)
    assert h2o_ce.ring_len == H2O_CONFIG.sliding_window
    assert h2o_ce.table_width == -(-h2o_ce.ring_len // h2o_ce.page_size)
    h2o_c_info = dict(continuous_summary(h2o_ce, h2o_cres),
                      # reported, not asserted: bf16 (F3)
                      greedy_equal_share_wave=equal_share(h2o_cres, h2o_res))
    print("h2o-danube-1.8b continuous path:", json.dumps(h2o_c_info))
    h2o_pool = [h2o_ce.cache[n][0].clone() for n in ("k", "v")]
    h2o_ring_len, h2o_W = h2o_ce.ring_len, h2o_ce.table_width
    h2o_ps = h2o_ce.page_size
    del h2o_c_eng, h2o_ce
    # ---- the same weights with an int8 KV cache, wave and continuous
    h2o_q8 = DenseLM(dataclasses.replace(H2O_CONFIG, kv_quant=True),
                     device=dev, params=dict(h2o.named_parameters()))
    h8_eng = Engine(h2o_q8, max_len=H2O_PROMPT + MAX_NEW, eos_id=-1,
                    slots=2)
    h8_ce = traced_continuous(h8_eng, 2)
    (h8_wave, h8_cont), h2o_q8_launches = drive("h2o_int8", lambda: [
        h8_eng.generate(hp, max_new=MAX_NEW, continuous=c)
        for c in (False, True)])
    check_tokens(h8_wave + h8_cont, MAX_NEW, H2O_CONFIG.vocab_padded)
    h8_info = {
        "wave": {"prefill_s": h8_wave[0].prefill_s,
                 "decode_tok_s": sum(len(r.tokens) - 1 for r in h8_wave)
                 / h8_wave[0].decode_s},
        "continuous": continuous_summary(h8_ce, h8_cont),
        "bf16_pool_bytes_per_position_head_tensor":
            h2o_c_info["pool_bytes_per_position_head_tensor"],
        "bf16_pool_bytes": h2o_c_info["pool_bytes"],
        # reported, not asserted: bf16 activations (F3)
        "greedy_equal_share_wave_continuous": equal_share(h8_wave, h8_cont),
        "greedy_equal_share_int8_bf16_wave": equal_share(h8_wave, h2o_res),
        "greedy_equal_share_int8_bf16_continuous": equal_share(h8_cont,
                                                               h2o_cres)}
    print("h2o-danube-1.8b int8 KV path:", json.dumps(h8_info))
    _, c8 = h2o_q8.prefill(torch.tensor(np.stack(hp[:1]), dtype=torch.long,
                                        device=dev))
    h8_in = [c8[n][0].contiguous() for n in ("k", "k_s", "v", "v_s")]
    h8_pool = [h8_ce.cache[n][0].clone() for n in ("k", "k_s", "v", "v_s")]
    h8_W = h8_ce.table_width
    del h2o_q8, h8_eng, h8_ce, c8
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
    # ---- graph baselines: HNSW / HNSWPQ / IVF-HNSW / EcoVector
    base_g = base[:N_G]
    g_indexes, graph_launches = drive(
        "graph_baselines", lambda: run_graph_baselines(base_g, bq))
    graph_info = graph_baselines_info(g_indexes, base_g, bq)
    graph_info["reduced"] = {
        "n": N_G, "of": SIFT_N, "queries": SIFT_NQ,
        "why": "graph inserts are host numpy (tools/hnsw_probe.py: 6-10 "
               "ms an insert at 1,000-4,000 nodes on an H100 machine's "
               "host CPU)"}
    g_ivfh, g_eco = g_indexes["IVF-HNSW"][0], g_indexes["EcoVector"][0]
    graph_info["ivf_hnsw_ecovector_same_partition"] = bool(np.array_equal(
        g_ivfh.centroids, g_eco.centroids))
    print(f"graph baselines: the first {N_G} of the {SIFT_N} SIFT-like "
          f"vectors, {SIFT_NQ} queries, M {GRAPH_KW['M']}, efc "
          f"{GRAPH_KW['ef_construction']}, {max(16, N_G // 256)} clusters, "
          f"m_pq {M_PQ}, k 10")
    print("graph baselines path:", json.dumps(graph_info))
    # kmeans_assign's inputs on this path: the IVF-HNSW (and EcoVector)
    # partition, and HNSWPQ's first sub-quantizer on its training sample
    g_x = torch.tensor(base_g, device=dev)
    g_c = torch.tensor(g_ivfh.centroids, device=dev)
    g_sample = base_g[np.random.default_rng(0).choice(
        N_G, min(N_G, 4096), replace=False)]
    g_dsub = base.shape[1] // M_PQ
    gpq_x = torch.tensor(np.ascontiguousarray(g_sample[:, :g_dsub]),
                         device=dev)
    gpq_c = torch.tensor(g_indexes["HNSWPQ"][0].pq.codebooks[0], device=dev)
    del g_indexes, g_ivfh, g_eco

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
    # slot's 64 positions of history and the chunk
    k_slot, v_slot, _ = chunk_buffer(pool["k"][0], pool["v"][0], table[0],
                                     64, slm.PREFILL_CHUNK, ps)
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
    C = slm.PREFILL_CHUNK
    # h2o's last prompt chunk on the continuous engine (the ring wrapped):
    # its buffer from layer 0's pool through a random 128-page row, and
    # the chunk's own queries
    Ph = h2o_pool[0].shape[0]
    table_h2o = torch.stack([torch.randperm(Ph, generator=g, device=dev)[
        :h2o_W] for _ in range(2)]).to(torch.int32)
    h_off = (H2O_PROMPT - 1) // C * C
    k_ring, v_ring, h_lo = chunk_buffer(*h2o_pool, table_h2o[0], h_off, C,
                                        h2o_ps, h2o_ring_len)
    # the moe path's grouping (16 heads over 8, dh 64): a chunk at offset
    # 64 through a random row of its pool, its wave decode over the
    # largest bucket's grown cache, and its paged decode
    Hm, dhm = MOE_CONFIG.num_heads, MOE_CONFIG.resolved_head_dim
    Pm = moe_pool[0].shape[0]
    table_moe = torch.stack([torch.randperm(Pm, generator=g, device=dev)[:W]
                             for _ in range(4)]).to(torch.int32)
    k_moe, v_moe, _ = chunk_buffer(*moe_pool, table_moe[0], 64, C, ps)
    q_moe_chunk = torch.randn(1, C, Hm, dhm, generator=g, device=dev
                              ).to(torch.bfloat16)
    q_moe_wave = torch.randn(len(big), Hm, dhm, generator=g, device=dev
                             ).to(torch.bfloat16)
    q_moe_dec = torch.randn(4, Hm, dhm, generator=g, device=dev
                            ).to(torch.bfloat16)
    flash_shapes = [
        check_flash_prefill("main-path chunk", q_chunk, k_slot, v_slot,
                            q_offset=64, kv_len=64 + slm.PREFILL_CHUNK),
        check_flash_prefill("h2o wave", hq, hk, hv, window=window,
                            plain_iters=3),
        check_flash_prefill("h2o ring chunk", hq[:, h_off:h_off + C],
                            k_ring, v_ring, window=window,
                            q_offset=h_off - h_lo, kv_len=h_off + C - h_lo),
        check_flash_prefill("moe chunk", q_moe_chunk, k_moe, v_moe,
                            q_offset=64, kv_len=64 + C),
    ]
    decode_shapes = [
        check_decode_attention("qwen wave", q_wave, k_wave, v_wave,
                               len_wave, False),
        check_decode_attention("h2o ring", q_ring, hck, hcv, len_ring, True),
        check_decode_attention("moe wave", q_moe_wave, *moe_wave_kv,
                               len_wave, False),
    ]
    q8_shapes = [
        check_decode_q8("qwen int8 wave", q_wave, *i8_wave_in, len_wave,
                        False),
        check_decode_q8("h2o int8 ring", q_ring, *h8_in, len_ring, True),
    ]
    P8 = i8_pool[0].shape[0]
    table8 = torch.stack([torch.randperm(P8, generator=g, device=dev)[:W]
                          for _ in range(4)]).to(torch.int32)
    Ph8 = h8_pool[0].shape[0]
    table_h8 = torch.stack([torch.randperm(Ph8, generator=g, device=dev)[
        :h8_W] for _ in range(2)]).to(torch.int32)
    q_ring2 = torch.randn(2, H2O_CONFIG.num_heads, H2O_CONFIG.head_dim,
                          generator=g, device=dev).to(torch.bfloat16)
    len_ring2 = torch.full((2,), window, dtype=torch.int32, device=dev)
    pq8_shapes = [
        check_decode_paged_q8("qwen int8 continuous", q_dec, *i8_pool,
                              kv_len, table8),
        check_decode_paged_q8("h2o int8 ring pages", q_ring2, *h8_pool,
                              len_ring2, table_h8),
    ]
    assert ops.decode_paged_split_plan(4, G, W, ps) > 1
    long_in = long_cache_inputs(H, G, dh, g)
    paged_shapes = [
        check_decode("main path", q_dec, pool["k"][0], pool["v"][0], kv_len,
                     table),
        check_decode("h2o ring pages", q_ring2, *h2o_pool, len_ring2,
                     table_h2o),
        check_decode("moe continuous", q_moe_dec, *moe_pool, kv_len,
                     table_moe),
        check_decode("long cache (not a path shape)", *long_in),
    ]
    n_edges = attention_edges() + paged_edges(H, G, dh) + q8_edges()
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
                     check_kmeans("PQ sub-quantizer", pq_x, pq_c),
                     check_kmeans("IVF-HNSW / EcoVector partition (graph "
                                  "baselines)", g_x, g_c),
                     check_kmeans("HNSWPQ sub-quantizer (graph baselines)",
                                  gpq_x, gpq_c)]
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
        "decode_attention_q8": dict(q8_shapes[0], shapes=q8_shapes),
        "decode_attention_paged_q8": dict(pq8_shapes[0], shapes=pq8_shapes),
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
        "decode_attention_q8": lambda: ops.decode_attention_q8(
            q_wave, *i8_wave_in, len_wave),
        "decode_attention_q8 h2o ring": lambda: ops.decode_attention_q8(
            q_ring, *h8_in, len_ring, ring=True),
        "decode_attention_paged_q8": lambda: ops.decode_attention_paged_q8(
            q_dec, *i8_pool, kv_len, table8),
        "decode_attention_paged_q8 h2o ring pages":
            lambda: ops.decode_attention_paged_q8(q_ring2, *h8_pool,
                                                  len_ring2, table_h8),
    }
    prof = profile_phase(slm, [slm.encode_prompt(a.prompt)
                               for a in answers[:4]], calls)
    print("profile:", json.dumps(prof))
    # ---- sampled decoding on the main path's pipeline, then the draw on
    # the card and its cost a decode step
    sampled_info, sampled_launches = drive(
        "sampled", lambda: sampled_path(pipe, questions, answers, prompts))
    print("sampled path:", json.dumps(sampled_info))
    print("sampled draw on the card:", json.dumps(draw_checks(vocab)))
    print("sampled draw cost:", json.dumps(draw_cost(
        slm, [slm.encode_prompt(a.prompt) for a in answers[:4]])))
    # ---- documents appended after the build, window-index updates
    (wu_info, wu_scr), wu_launches = drive(
        "window_updates", lambda: window_updates_path(pipe))
    print("window updates path:", json.dumps(wu_info))
    # ---- serving under fire on the main path's pipeline; the pipeline's
    # fallback counts of the clean paths before it (main, sampled, window
    # updates)
    clean_fallbacks = {"main": (pipe.retrieval_fallbacks, pipe.scr_fallbacks)}
    fire_info, fire_launches = drive("fire", lambda: fire_path(
        pipe, questions, answers, prompts))
    print("fire path:", json.dumps(fire_info))
    assert (pipe.retrieval_fallbacks, pipe.scr_fallbacks) == (1, 1), \
        "the fire path's fallbacks counted other than what it injected"
    # ---- durability and tiers on the main path's pipeline: save, the
    # journal and its replay, tiered loads under budgets, a restored
    # pipeline answering
    (dur_info, tier_in), dur_launches = drive("durable", lambda: durable_path(
        pipe, questions, hq_vs, answers, main["build_s"]))
    assert dur_launches["kmeans_assign"] == 0, dur_launches
    assert (pipe.retrieval_fallbacks, pipe.scr_fallbacks) == (1, 1)
    print("durable path:", json.dumps(dur_info))
    tier_shape = check_ecoscan("tiered at 0.25: hot rows + cold scratch",
                               *tier_in[:5], block_map=tier_in[5],
                               map_kind="hot rows, cold clusters to scratch")
    tier_shape["device_ms"] = _profiled(lambda: ops.ecoscan(
        *tier_in[:5], block_map=tier_in[5]), 20)["device_ms"]
    results["ecoscan"]["shapes"].append(tier_shape)
    print("ecoscan at the tier shape:", json.dumps(tier_shape))
    del tier_in
    # ---- updates on the main path's index, after every path that uses
    # it; then ecoscan on the grown pack
    (upd, (ud_t, ul_t, uc_t)), upd_launches = drive(
        "updates", lambda: update_phase(pipe.index, doc_emb, hq_vs,
                                        pipe.n_probe, len(pipe.docs)))
    print("updates:", json.dumps(upd))
    results["ecoscan"]["shapes"].append(check_ecoscan(
        "after updates, CAP grown", qv, ud_t, ul_t,
        ref.route_topk(qv, uc_t, pipe.n_probe), pipe.top_k))
    results["scr_select"]["shapes"].append(check_scr_select(
        "after window updates, CAPW grown", *wu_scr))
    n_small = small_input_agreement()
    n_families = small_families_agreement()
    print(f"small input: {n_small} queries agree GPU vs CPU (doc ids, "
          "prompts, greedy tokens; wave tokens, wave = continuous on the "
          "GPU; the legacy SCR pipeline, whose prompts equal the window "
          "index's; sampled sessions, sampled waves, sampled wave = "
          "continuous on the GPU); reduced h2o wave tokens agree GPU vs "
          "CPU")
    print("small input, paged families (requests):", json.dumps(n_families),
          "GPU tokens = CPU tokens and wave = continuous, on each")
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
    sc_dev = prof["kernel_device_ms"]["scr_score"]
    print(f"scr_score launch path: wrapper {sc['ms']:.4f} ms a call, bare "
          f"cached ctypes call {sc['bare_call_ms']:.4f} ms, bmm "
          f"{sc['library_ms']:.4f} ms, device "
          + ("not measured (the profiler recorded no event)" if sc_dev is None
             else f"{sc_dev:.5f} ms"))
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
    # no clean path's pipeline fell back, no clean session failed or
    # retried
    clean_fallbacks.update({
        "legacy": (lpipe.retrieval_fallbacks, lpipe.scr_fallbacks),
        "host_search": (hpipe.retrieval_fallbacks, hpipe.scr_fallbacks)})
    assert all(v == (0, 0) for v in clean_fallbacks.values()), clean_fallbacks
    clean_sessions = [(p_, s_) for p_, s_ in SESSIONS if p_ != "fire"]
    assert clean_sessions and all(
        s_.counters.failed == s_.counters.retrieval_retries == 0
        for _, s_ in clean_sessions), [(p_, s_.counters)
                                       for p_, s_ in clean_sessions]
    print("clean paths: retrieval and SCR fallbacks (main / sampled / window "
          "updates share the main pipeline):", json.dumps(clean_fallbacks),
          f"; {len(clean_sessions)} sessions without a failure or a retry "
          "(paths:", json.dumps(collections.Counter(
              str(p_) for p_, _ in clean_sessions)), ")")
    paths = {"main": launches, "wave": wave_launches, "h2o": h2o_launches,
             "legacy": legacy_launches, "baselines": base_launches,
             "host_search": host_launches, "graph_baselines": graph_launches,
             "updates": upd_launches, "h2o_continuous": h2o_c_launches,
             "h2o_int8": h2o_q8_launches, "int8": int8_launches,
             "moe": moe_launches, "sampled": sampled_launches,
             "window_updates": wu_launches, "fire": fire_launches,
             "durable": dur_launches}
    kernels = [{
        "name": name, "route": "cuda",
        "source": SOURCES[name],
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
