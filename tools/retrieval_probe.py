#!/usr/bin/env python3
"""Probe of the port's two retrieval kernels on one GPU:
`python3 tools/retrieval_probe.py [--src DIR] [--answers]` (`--src` names
the `src` directory whose `repro_torch` is imported, so that a parent
tree unpacked with git archive under `build/` can be timed in the same
call; `--answers` instead drives chip_smoke.py's main path, the same
corpus, seeds and model, and prints each question's retrieved doc ids
and greedy tokens, so that two trees' answers can be compared).

ecoscan at the main path's shape (q [4, 384] over a [256, 110, 384]
pack, lens 30-110, 4 probes, k 3) and at scale (q [16, 384] over a
[1024, 512, 384] pack, lens 128-512, 8 distinct probes, k 10; once with
the identity map and once with a block_map that permutes the clusters
and masks every eighth): the wrapper, the kernel at each forced tile of
`ops.ECOSCAN_TILES` (where the tree has the `ecoscan_tile` entry), and
`cdist` + `topk` on the gathered lists. scr_select at the main path's
shape (q [4, 384], a [16384, 10, 384] window pack, K 3) and at top_k 10
(B 16, K 10), beside `bmm` + `max`. Inputs come from a seeded
torch.Generator on the card; each call is held against the tree's plain
version (ids equal except ties within 2e-5, values 2e-5).

Times: CUDA events over back-to-back calls (`call_ms`, host launch
included) and torch.profiler's device time per call (`device_ms`, all of
a call's kernels summed; `launches` the kernel events a call), beside
the bound: each input read once and each output written once at 3.35
TB/s (the probed rows of distinct clusters, the valid windows of
distinct docs). Prints the card and one JSON line per measurement;
exits 2 without a GPU.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_S = 3.35e12
DEV = "cuda"
ops = ref = None              # repro_torch.kernels of --src, set by main()


def call_ms(fn, iters=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, n=20):
    """(device ms a call, kernel launches a call) by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in ev) / n / 1e3,
            sum(e.count for e in ev) / n)


def held(label, got, want, value_of):
    """Values within 2e-5; ids equal except where the two picks' plain
    values tie within 2e-5. Returns the tied swaps."""
    (gv, gi), (wv, wi) = got, want
    assert bool(((gv - wv).abs() <= 2e-5 + 2e-5 * wv.abs()).all()), label
    diff = gi != wi
    if diff.any():
        a, b = value_of(gi)[diff], value_of(wi)[diff]
        assert bool(((a - b).abs() <= 2e-5 + 2e-5 * b.abs()).all()), label
    return int(diff.sum())


def eco_inputs(g, R, CAP, lo, B, P, k):
    """(q [B, 384], data [R, CAP, 384], lens in [lo, CAP], probes [B, P]
    distinct a query, k)."""
    d = 384
    data = torch.randn(R, CAP, d, generator=g, device=DEV)
    lens = torch.randint(lo, CAP + 1, (R,), generator=g, device=DEV,
                         dtype=torch.int32)
    q = torch.randn(B, d, generator=g, device=DEV)
    probes = torch.stack([torch.randperm(R, generator=g, device=DEV)[:P]
                          for _ in range(B)]).to(torch.int32)
    return q, data, lens, probes, k


def masked_map(g, R):
    """A block_map that permutes R clusters and masks every eighth."""
    bm = torch.randperm(R, generator=g, device=DEV).to(torch.int32)
    bm[::8] = -1
    return bm


def eco_bound(q, data, lens, probes, k, bm):
    B, d = q.shape
    blk = probes.long() if bm is None else bm[probes.long()].long()
    blk = torch.unique(blk[(probes >= 0) & (blk >= 0)])
    rows = int(lens[blk].clamp(max=data.shape[1]).sum())
    nbytes = (rows * d + B * d + probes.numel() + B * k * 2) * 4
    if bm is not None:
        nbytes += bm.numel() * 4
    return nbytes / HBM_BYTES_S * 1e3


def eco_probe(label, inp, bm=None):
    q, data, lens, probes, k = inp
    B, d = q.shape
    flat = data.reshape(-1, d)

    def value_of(slots):
        rows = flat[slots.long().clamp(min=0)]
        v = ((rows * rows).sum(-1) - 2.0 * (rows * q[:, None]).sum(-1)
             + (q * q).sum(-1)[:, None])
        return torch.where(slots >= 0, v, torch.full_like(v, ref.NEG))
    want = ref.ecoscan(q, data, lens, probes, k, block_map=bm)
    bound = eco_bound(*inp, bm)
    blk = probes.long() if bm is None else bm[probes.long()].long()

    def library():
        g_ = data[blk.clamp(min=0)].reshape(B, -1, d)
        return torch.topk(torch.cdist(q[:, None], g_)[:, 0], k,
                          largest=False)
    dev, n = device_ms(library)
    print(json.dumps({"ecoscan": label, "bound_ms": bound,
                      "library call_ms": call_ms(library),
                      "library device_ms": dev}))
    calls = [("wrapper", lambda: ops.ecoscan(q, data, lens, probes, k,
                                             block_map=bm))]
    if hasattr(ops, "ecoscan_launch"):
        calls += [(t, lambda t=t: ops.ecoscan_launch(
            q, data, lens, probes, k, bm, tile=t))
            for t in ops.ECOSCAN_TILES]
    for tile, fn in calls:
        ties = held(f"ecoscan {label} {tile}", fn(), want, value_of)
        a, b = fn(), fn()
        bit_equal = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        dev, n = device_ms(fn)
        print(json.dumps({"ecoscan": label, "tile": tile, "ties": ties,
                          "bit_equal": bit_equal, "call_ms": call_ms(fn),
                          "device_ms": dev, "launches": n,
                          "bound_share": bound / dev if dev else None}))


def scr_probe(label, g, data, lens, B, K):
    d = data.shape[2]
    ND, CAPW = data.shape[:2]
    q = torch.randn(B, d, generator=g, device=DEV)
    ids = torch.stack([torch.randperm(ND, generator=g, device=DEV)[:K]
                       for _ in range(B)]).to(torch.int32)

    def value_of(wins):
        rows = data[ids.long(), wins.long().clamp(min=0)]
        v = (rows * q[:, None]).sum(-1)
        return torch.where(wins >= 0, v, torch.full_like(v, -ref.NEG))
    want = ref.scr_select(q, data, lens, ids)
    uniq = torch.unique(ids.long())
    bound = ((int(lens[uniq].sum()) * d + B * d + ids.numel() * 3) * 4
             / HBM_BYTES_S * 1e3)

    def library():
        g_ = data[ids.long()].reshape(B, K * CAPW, d)
        return torch.bmm(g_, q[:, :, None]).reshape(B, K, CAPW).max(-1)

    def fn():
        return ops.scr_select(q, data, lens, ids)
    ties = held(f"scr_select {label}", fn(), want, value_of)
    a, b = fn(), fn()
    dev, n = device_ms(fn)
    ldev, _ = device_ms(library)
    print(json.dumps({"scr_select": label, "ties": ties,
                      "bit_equal": torch.equal(a[0], b[0])
                      and torch.equal(a[1], b[1]),
                      "call_ms": call_ms(fn), "device_ms": dev,
                      "launches": n, "bound_ms": bound,
                      "bound_share": bound / dev if dev else None,
                      "library call_ms": call_ms(library),
                      "library device_ms": ldev}))


def answers_probe():
    """chip_smoke.py's main path: MobileRAG over the 16,384-document
    corpus (HashEmbedder at 384, top_k 3) with qwen2.5-0.5B in bf16 (seed
    0), 16 questions, max_new 16; prints one JSON line of each answer's
    [doc ids, greedy tokens]."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_qa_corpus
    from repro_torch.serving.embedder import HashEmbedder
    from repro_torch.serving.rag import MobileRAG
    corpus = make_qa_corpus(n_docs=16384, n_questions=16,
                            sentences_per_doc=12, seed=0)
    pipe = MobileRAG(corpus.docs, HashEmbedder(dim=384), top_k=3,
                     gen_config=get_config("qwen25_0_5b"), seed=0,
                     device=DEV)
    answers = pipe.answer_batch([e.question for e in corpus.examples],
                                generate=True, max_new=16)
    print(json.dumps({"answers": [[[int(i) for i in a.doc_ids],
                                   [int(t) for t in a.gen_tokens]]
                                  for a in answers]}))


def main() -> int:
    global ops, ref
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--answers", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("retrieval_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build, ops, ref
    print(json.dumps({"src": args.src}))
    torch.backends.cuda.matmul.allow_tf32 = False     # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    if args.answers:
        answers_probe()
        return 0
    g = torch.Generator(device=DEV).manual_seed(0)
    eco_probe("main path", eco_inputs(g, 256, 110, 30, 4, 4, 3))
    big = eco_inputs(g, 1024, 512, 128, 16, 8, 10)
    eco_probe("at scale", big)
    eco_probe("at scale, block_map", big, masked_map(g, big[1].shape[0]))
    del big
    torch.cuda.empty_cache()
    wdata = torch.randn(16384, 10, 384, generator=g, device=DEV)
    wlens = torch.randint(6, 11, (16384,), generator=g, device=DEV,
                          dtype=torch.int32)
    scr_probe("main path", g, wdata, wlens, 4, 3)
    scr_probe("top_k 10", g, wdata, wlens, 16, 10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
