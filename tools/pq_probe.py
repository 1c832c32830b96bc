#!/usr/bin/env python3
"""Probe of `pq_adc` and the IVFPQ search around it on one GPU:
`python3 tools/pq_probe.py [--src DIR] [--kernel]` (`--src` names the
`src` directory whose `repro_torch` is imported, so that a parent tree
unpacked with git archive under `build/` runs in turns with this one in
one call; `--kernel` stops after the kernel part).

Kernel part, on inputs drawn from a seed (uniform codes, tables in [0,
100)): the path shape, one query's table [1, 8, 256] over 4,946 rows of
a [100000, 8] pack in 16 segments (an n_probe-16 IVFPQ search of the
baselines path; a tree without segments scores the 4,946 rows stacked,
as its search did), and the flat shape, 16 tables over all 100,000 rows.
Each call is held bit for bit against the tree's plain version, then
timed: CUDA events over back-to-back calls (`call_ms`, host launch
included) and torch.profiler's device time a call (`device_ms`, its
kernels summed; `launches` the kernel events a call), beside the bytes
bound (codes read, tables read, scores written once at 3.35 TB/s). Where
the tree has `ops.pq_adc_launch`, every forced variant (queries a lookup
1 / 2 / 4, threads a block, grid width) runs too. The flat call also
runs on codes without bank conflicts (row n's codes all n % 256, and all
0), to show what the random codes' conflicted lookups cost.

Search part: IVFPQ and IVFPQ-DISK built through `make_index` over the
baselines path's 100,000 SIFT-like vectors (128-d, 390 clusters, m_pq
8); 200 queries at k 10 and n_probe 4 and 16: `search_ms_p50` of
`idx.search` (host clock), and the host breakdown of one search,
its steps re-enacted with the tree's own functions and timed one by one
(perf_counter, medians over the queries): route, table, codes (the
parent's IVFPQ: stacking the probed rows id by id; this tree's: the
segments; IVFPQ-DISK: loading and concatenating the probed lists),
copies to the device, launch, scores back (`.cpu()`, which waits for
the kernel), top-k. Prints the card (`nvidia-smi` name and power limit)
and one JSON line per measurement; exits 2 without a GPU.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_S = 3.35e12
DEV = "cuda"
N_PACK, M, K = 100_000, 8, 256
PATH_SEGMENTS, PATH_ROWS = 16, 4946
FLAT_B = 16
ops = ref = None              # repro_torch.kernels of --src, set by main()


def call_ms(fn, iters=100):
    for _ in range(5):
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


def path_segments(g):
    """16 segments of a [N_PACK, 8] pack, PATH_ROWS rows in all (lengths
    250 and 368 in turn, distinct random starts, the first odd): (starts,
    offsets) as int32 on the card and the stacked row ids."""
    lens = 309 + 59 * (torch.arange(PATH_SEGMENTS) % 2 * 2 - 1)
    lens[0] += PATH_ROWS - int(lens.sum())
    starts = torch.randperm(N_PACK // 512, generator=g)[:PATH_SEGMENTS] * 512
    starts[0] += 1
    offsets = torch.cat([torch.zeros(1, dtype=torch.long), lens.cumsum(0)])
    rows = torch.cat([torch.arange(s, s + n) for s, n in zip(starts, lens)])
    return (starts.to(torch.int32).to(DEV), offsets.to(torch.int32).to(DEV),
            rows.to(DEV))


def bound_ms(B, rows):
    return (rows * M + B * M * K * 4 + B * rows * 4) / HBM_BYTES_S * 1e3


def timed(label, variant, fn, want, bound, exact=True):
    """Hold fn() against the plain version (bit for bit; within 1e-5 for
    a tree whose kernel sums in another order than its plain version),
    then time it."""
    got = fn()
    if exact:
        assert torch.equal(got, want), f"{label} {variant}: not bit-equal"
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(fn(), got), f"{label} {variant}: two calls differ"
    dev, n = device_ms(fn)
    print(json.dumps({"pq_adc": label, "variant": variant,
                      "call_ms": call_ms(fn), "device_ms": dev,
                      "launches": n, "bound_ms": bound,
                      "bound_share": bound / dev if dev else None}))


def kernel_part():
    g = torch.Generator().manual_seed(0)
    pack = torch.randint(0, K, (N_PACK, M), generator=g).to(torch.uint8)
    pack = pack.to(DEV)
    lut1 = (torch.rand(1, M, K, generator=g) * 100).to(DEV)
    lut16 = (torch.rand(FLAT_B, M, K, generator=g) * 100).to(DEV)
    starts, offsets, rows = path_segments(g)
    stacked = pack[rows].contiguous()
    want1 = ref.pq_adc(lut1, stacked)
    want16 = ref.pq_adc(lut16, pack)
    seg = hasattr(ops, "pq_adc_launch")
    if seg:
        path = ("path, 16 segments of the pack",
                lambda: ops.pq_adc(lut1, pack, starts, offsets,
                                   rows=PATH_ROWS))
    else:
        path = ("path, stacked rows", lambda: ops.pq_adc(lut1, stacked))
    timed(path[0], "wrapper", path[1], want1, bound_ms(1, PATH_ROWS), seg)
    timed("flat", "wrapper", lambda: ops.pq_adc(lut16, pack), want16,
          bound_ms(FLAT_B, N_PACK), seg)
    # the same call on codes that spread a warp's lookups over every bank
    # (row n's codes all n % 256), or put them all on one word (all 0):
    # what the random codes' bank conflicts cost
    spread = (torch.arange(N_PACK, device=DEV) % K).to(torch.uint8)
    for name, c in (("codes n % 256", spread[:, None].expand(-1, M)),
                    ("codes all 0", torch.zeros_like(pack))):
        c = c.contiguous()
        timed("flat", f"wrapper, {name}", lambda c=c: ops.pq_adc(lut16, c),
              ref.pq_adc(lut16, c), bound_ms(FLAT_B, N_PACK), seg)
    if not seg:
        return
    for threads in (128, 256, 512):
        for gx in (0, 5, 10, 20, 40):
            timed(path[0], f"qb 1, threads {threads}, grid {gx or 'auto'}",
                  lambda t=threads, x=gx: ops.pq_adc_launch(
                      lut1, pack, starts, offsets, PATH_ROWS, (1, t, x)),
                  want1, bound_ms(1, PATH_ROWS))
    for qb in (1, 2, 4):
        for threads in (128, 256, 512, 1024):
            for per_sm in (0, 1, 2, 4):
                gx = -(-132 * per_sm // -(-FLAT_B // qb))
                timed("flat", f"qb {qb}, threads {threads}, grid "
                      f"{gx or 'auto'}",
                      lambda q=qb, t=threads, x=gx: ops.pq_adc_launch(
                          lut16, pack, None, None, N_PACK, (q, t, x)),
                      want16, bound_ms(FLAT_B, N_PACK))


def breakdown(idx, q, n_probe, topk):
    """Host seconds of each step of one PQ search, re-enacted with the
    tree's own functions (the scores must equal idx.search's)."""
    t = [time.perf_counter()]
    probes = idx._probe(q, n_probe)
    t.append(time.perf_counter())
    tabs = idx.pq.adc_table(q)
    t.append(time.perf_counter())
    if getattr(idx, "pack", None) is not None:
        starts = idx.pack_offsets[probes]
        lens = idx.pack_offsets[probes + 1] - starts
        ids = np.concatenate([idx.lists[c] for c in probes])
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        t.append(time.perf_counter())
        lut, st, off = idx.pq._stage(tabs[None], starts.astype(np.int32),
                                     offsets)
        t.append(time.perf_counter())
        out = ops.pq_adc(lut, idx.pack, st, off, rows=int(offsets[-1]))
    else:
        if idx.on_disk:
            lists = [idx._load_list(int(c)) for c in probes]
            ids = np.concatenate([i for i, _ in lists])
            codes = np.concatenate([c for _, c in lists])
        else:
            ids = np.concatenate([idx.lists[c] for c in probes])
            codes = np.stack([idx.codes[int(i)] for i in ids])
        t.append(time.perf_counter())
        lut = torch.tensor(tabs[None], device=DEV)
        c = torch.tensor(codes, device=DEV)
        t.append(time.perf_counter())
        out = ops.pq_adc(lut, c)
    t.append(time.perf_counter())
    scores = out[0].cpu().numpy()
    t.append(time.perf_counter())
    got = topk(ids, scores, 10)
    t.append(time.perf_counter())
    return np.diff(t), got


def search_part():
    from repro_torch.core.baselines import _topk, make_index
    from repro_torch.data.synthetic import sift_like
    base, queries = sift_like(n=N_PACK, nq=200, d=128, seed=0)
    for name in ("IVFPQ", "IVFPQ-DISK"):
        t0 = time.perf_counter()
        idx = make_index(name, 128, n_clusters=N_PACK // 256, m_pq=M,
                         device=DEV).build(base)
        torch.cuda.synchronize()
        print(json.dumps({"index": name, "build_s":
                          time.perf_counter() - t0}))
        for n_probe in (4, 16):
            for q in queries[:5]:                       # warm-up
                idx.search(q, k=10, n_probe=n_probe)
            times = []
            for q in queries:
                t = time.perf_counter()
                idx.search(q, k=10, n_probe=n_probe)
                times.append(time.perf_counter() - t)
            info = {"index": name, "n_probe": n_probe,
                    "search_ms_p50": float(np.median(times) * 1e3),
                    "search_ms_mean": float(np.mean(times) * 1e3)}
            steps = []
            for q in queries:
                s, got = breakdown(idx, q, n_probe, _topk)
                want = idx.search(q, k=10, n_probe=n_probe)
                assert all(np.array_equal(a, b)
                           for a, b in zip(got, want))
                steps.append(s)
            med = np.median(np.array(steps), axis=0) * 1e3
            info["host_ms_p50"] = dict(zip(
                ("route", "table", "codes", "copies", "launch",
                 "scores back", "top-k"), map(float, med)))
            print(json.dumps(info))
        del idx


def main() -> int:
    global ops, ref
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--kernel", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pq_probe: no CUDA device", file=sys.stderr)
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
    kernel_part()
    if not args.kernel:
        search_part()
    return 0


if __name__ == "__main__":
    sys.exit(main())
