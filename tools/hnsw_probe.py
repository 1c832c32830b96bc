#!/usr/bin/env python3
"""Insert and search rates of the port's HNSW (`repro_torch.core.hnsw`)
on the host CPU: `python3 tools/hnsw_probe.py [--n-base N]`.

The graphs are numpy on the host, so this measures the machine's CPU,
not the card: run on the machine that holds the card, its rates size
chip_smoke's graph phases. Two shapes:
- main: the main path's EcoVector clusters. The 16,384-document
  synthetic corpus embedded at 384 (HashEmbedder) and k-means'd into
  256 clusters on the CPU (the port's plain versions); the first
  `--clusters` clusters each get a graph (M 16, efc 100, seed 0 + c) as
  `EcoVector.build` makes them. Prints ms an insert and the whole
  build's graph time projected from it.
- base: one graph over the first `--n-base` SIFT-like vectors (128-d,
  M 12, efc 60: the baselines' graph settings), ms an insert over each
  block of 1,000, then 200 searches at ef 64, k 10 (ms p50).
Prints one JSON line per shape.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.hnsw import HNSW  # noqa: E402
from repro_torch.core.kmeans import kmeans  # noqa: E402
from repro_torch.data.synthetic import make_qa_corpus, sift_like  # noqa: E402
from repro_torch.serving.embedder import HashEmbedder  # noqa: E402


def main_shape(n_clusters_built: int) -> dict:
    corpus = make_qa_corpus(n_docs=16384, n_questions=16,
                            sentences_per_doc=12, seed=0)
    x = HashEmbedder(dim=384)(corpus.docs)
    _, assign = kmeans(x, 256, seed=0, device="cpu")
    sizes = np.bincount(assign, minlength=256)
    t0 = time.perf_counter()
    n = 0
    for c in range(n_clusters_built):
        g = HNSW(384, M=16, ef_construction=100, seed=c,
                 max_elements=max(int(sizes[c]), 4))
        for vid in np.flatnonzero(assign == c):
            g.insert(int(vid), x[vid])
            n += 1
    dt = time.perf_counter() - t0
    return {"shape": "main", "clusters_built": n_clusters_built,
            "inserts": n, "ms_per_insert": dt / n * 1e3,
            "projected_graphs_s": dt / n * len(x),
            "cluster_size_mean": float(sizes.mean()),
            "cluster_size_max": int(sizes.max())}


def base_shape(n_base: int) -> dict:
    base, queries = sift_like(n=n_base, nq=200, d=128, seed=0)
    g = HNSW(128, M=12, ef_construction=60, seed=0)
    blocks = []
    t0 = time.perf_counter()
    for i, v in enumerate(base):
        g.insert(i, v)
        if (i + 1) % 1000 == 0 or i + 1 == n_base:
            t1 = time.perf_counter()
            blocks.append([i + 1, (t1 - t0) / ((i % 1000) + 1) * 1e3])
            t0 = t1
    times = []
    for q in queries:
        t = time.perf_counter()
        g.search(q, 10, ef_search=64)
        times.append(time.perf_counter() - t)
    return {"shape": "base", "n": n_base,
            "ms_per_insert_by_block": blocks,
            "search_ms_p50": float(np.median(times) * 1e3)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", type=int, default=32)
    ap.add_argument("--n-base", type=int, default=4000)
    args = ap.parse_args()
    print(json.dumps({"cpu_count": os.cpu_count()}))
    print(json.dumps(main_shape(args.clusters)), flush=True)
    print(json.dumps(base_shape(args.n_base)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
