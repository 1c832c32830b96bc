#!/usr/bin/env python3
"""Launch-path probe of the port's eight kernel wrappers on one GPU:
`python3 tools/launch_probe.py [--src DIR] [--iters N] [--steps]`.

Times each wrapper of `repro_torch.kernels.ops` at a small shape of its
path (synthetic inputs from a seed; the shapes of chip_smoke.py's kernel
checks, the window and EcoVector packs cut to a few hundred blocks) with
CUDA events over `--iters` back-to-back calls: the call time, host
launch included, which at these shapes is mostly the wrapper's host
cost. `--src` names the `src` directory whose `repro_torch` is imported
(default: this checkout's), so that two trees, such as a parent commit
unpacked with `git archive`, can be timed in turns on one card. Prints
the card (`nvidia-smi` name and power limit), then one JSON line
{"src": ..., "call_ms": {wrapper: ms}}; exits 2 without a GPU.

`--steps` also prints {"scr_score host_us": {step: us}}: the host time
of each step of a `scr_score` call at the legacy SCR path's shape (the
wrapper, its checks, its output, its stream lookup against the public
`torch.cuda.current_stream()`, the bare cached ctypes call) beside
`bmm`, by perf_counter over many calls (the wrappers of this checkout's
launch path only).
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def call_ms(fn, iters):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def host_us(fn, n=2000):
    """Mean host time of one call in microseconds (perf_counter over n
    calls after a warm-up)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def scr_score_steps(build, ops):
    """Host us of each step of an `ops.scr_score` call, windows [1, 30,
    384] and q [1, 384], beside `bmm` on the same inputs."""
    g = torch.Generator(device="cuda").manual_seed(1)
    w = torch.randn(1, 30, 384, generator=g, device="cuda")
    q = torch.randn(1, 384, generator=g, device="cuda")
    q3 = q[:, :, None].contiguous()
    fn = build.entry("scr_score")
    out = torch.empty(1, 30, device="cuda")
    args = (w.data_ptr(), q.data_ptr(), 1, 30, 384, out.data_ptr(),
            ops._stream(w.device))
    specs = ((w, "windows", torch.float32, 3), (q, "q", torch.float32, 2))
    return {
        "wrapper": host_us(lambda: ops.scr_score(w, q)),
        "bare ctypes call": host_us(lambda: fn(*args)),
        "checks": host_us(lambda: ops._checked(*specs)),
        "output new_empty": host_us(lambda: w.new_empty((1, 30))),
        "stream, raw getter": host_us(lambda: ops._stream(w.device)),
        "stream, torch.cuda.current_stream()": host_us(
            lambda: torch.cuda.current_stream().cuda_stream),
        "bmm": host_us(lambda: torch.bmm(w, q3)),
    }


def calls(ops):
    """One call of each wrapper at a path shape, on inputs from a seed."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    bf = torch.bfloat16
    x, c = rnd(4096, 16), rnd(256, 16)                 # a PQ sub-quantizer
    q4 = rnd(4, 384)
    eco, eco_lens = rnd(256, 110, 384), torch.full(
        (256,), 110, dtype=torch.int32, device="cuda")
    probes = torch.stack([torch.randperm(256, generator=g, device="cuda")[:4]
                          for _ in range(4)]).to(torch.int32)
    win, win_lens = rnd(512, 10, 384), torch.full(
        (512,), 10, dtype=torch.int32, device="cuda")
    doc_ids = ints(512, 4, 3)
    qd, kp, vp = rnd(4, 14, 64, dtype=bf), rnd(128, 16, 2, 64, dtype=bf), \
        rnd(128, 16, 2, 64, dtype=bf)
    table = torch.stack([torch.randperm(128, generator=g, device="cuda")[:22]
                         for _ in range(4)]).to(torch.int32)
    kv_paged = torch.full((4,), 300, dtype=torch.int32, device="cuda")
    qc, kc, vc = rnd(1, 32, 14, 64, dtype=bf), rnd(1, 352, 2, 64, dtype=bf), \
        rnd(1, 352, 2, 64, dtype=bf)
    qw, kw, vw = rnd(16, 14, 64, dtype=bf), rnd(16, 280, 2, 64, dtype=bf), \
        rnd(16, 280, 2, 64, dtype=bf)
    kv_wave = torch.full((16,), 136, dtype=torch.int32, device="cuda")
    qr, kr, vr = rnd(1, 32, 80, dtype=bf), rnd(1, 4096, 8, 80, dtype=bf), \
        rnd(1, 4096, 8, 80, dtype=bf)
    kv_ring = torch.full((1,), 4609, dtype=torch.int32, device="cuda")
    w, qs = rnd(1, 30, 384), rnd(1, 384)
    lut, codes = rnd(1, 8, 256), ints(256, 4946, 8).to(torch.uint8)
    return {
        "kmeans_assign": lambda: ops.kmeans_assign(x, c),
        "ecoscan": lambda: ops.ecoscan(q4, eco, eco_lens, probes, 3),
        "scr_select": lambda: ops.scr_select(q4, win, win_lens, doc_ids),
        "decode_attention_paged": lambda: ops.decode_attention_paged(
            qd, kp, vp, kv_paged, table),
        "flash_prefill": lambda: ops.flash_prefill(qc, kc, vc, q_offset=64,
                                                   kv_len=96),
        "decode_attention": lambda: ops.decode_attention(qw, kw, vw, kv_wave),
        "decode_attention h2o ring": lambda: ops.decode_attention(
            qr, kr, vr, kv_ring, ring=True),
        "scr_score": lambda: ops.scr_score(w, qs),
        "pq_adc": lambda: ops.pq_adc(lut, codes),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--steps", action="store_true",
                    help="also time the steps of a scr_score call")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("launch_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build, ops
    build.build_all()
    fns = calls(ops)
    print(json.dumps({"src": args.src, "call_ms": {
        name: call_ms(fn, args.iters) for name, fn in fns.items()}}))
    if args.steps:
        print(json.dumps({"scr_score host_us": scr_score_steps(build, ops)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
