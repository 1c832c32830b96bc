#!/usr/bin/env python3
"""Tile-shape probe of the `kmeans_assign` kernel on one GPU:
`python3 tools/kmeans_probe.py`.

Builds `csrc/kmeans_assign.cu` once per setting of its knobs (the block
tile kBM rows x kBN centroids, so a per-thread register tile of kBM/16 x
kBN/16; kBK features per staged chunk; kMinBlocks blocks per SM that the
register budget must allow; the first setting is the committed one)
into `build/kmeans_probe/` and prints nvcc's `-Xptxas -v` registers,
shared memory and spills of every instantiation (16-byte or 4-byte
copies). Then, at the three shapes the port runs the kernel at and at
two edge shapes, it holds each build against `ref.kmeans_assign` (ids
equal except ties within 1e-4, sqdist 1e-4) and times it beside
`ops.kmeans_assign` (the committed kernel through its wrapper),
`torch.cdist(x, c).argmin(1)` and, as the card's f32 GEMM yardstick,
`x @ c.T` alone (cuBLAS, TF32 off):
- main: the EcoVector build, x [16384, 384] against 256 centroids;
- ivf: the IVF baselines' partition, 100,000 SIFT-like vectors [., 128]
  against 390 centroids;
- pq: a PQ sub-quantizer, [4096, 16] against 256 centroids;
- edges: d 50 (4-byte copies, a ragged feature chunk) and NC 390 with a
  centroid equal to centroid 0 in the next tile, and an x whose base is
  4 bytes off 16-byte alignment (4-byte copies).

Times: CUDA events over back-to-back calls (`call_ms`, host launch
included) and torch.profiler's device time per call (`device_ms`); the
f32 bound is 2*N*NC*d flops at 67 TFLOP/s. TF32 is off. Prints the card
(`nvidia-smi` name and power limit) and one JSON line per measurement;
exits 2 without a GPU.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.data.synthetic import sift_like  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

F32_FLOPS_S = 67e12            # f32 outside the tensor cores
HBM_BYTES_S = 3.35e12
OUT = ROOT / "build" / "kmeans_probe"
# knob settings of the kernel, each changed from the committed one (the
# first): 4 x 8 and 8 x 4 sums a thread, other chunk depths, two blocks
# an SM (a 128-register cap)
KNOBS = [dict(kBM=128, kBN=128, kBK=32, kMinBlocks=1),
         dict(kBM=64, kBN=128, kBK=32, kMinBlocks=1),
         dict(kBM=128, kBN=64, kBK=32, kMinBlocks=1),
         dict(kBM=128, kBN=128, kBK=64, kMinBlocks=1),
         dict(kBM=128, kBN=128, kBK=16, kMinBlocks=1),
         dict(kBM=128, kBN=128, kBK=32, kMinBlocks=2)]


def variant_source(src, knobs):
    for name, value in knobs.items():
        line = next(ln for ln in src.splitlines()
                    if ln.startswith(f"constexpr int {name} = "))
        src = src.replace(line, f"constexpr int {name} = {value};")
    return src


def build_variants():
    """Compile every knob setting in parallel; returns [(knobs, fn)]."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "kmeans_assign.cu").read_text()
    procs = []
    for i, knobs in enumerate(KNOBS):
        cu, so = OUT / f"kmeans_assign_{i}.cu", OUT / f"kmeans_assign_{i}.so"
        cu.write_text(variant_source(src, knobs))
        procs.append((knobs, so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    out = []
    for knobs, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {knobs}:\n{log}")
        for rec in ptxas_report(log):
            print(json.dumps(dict(knobs=knobs, **rec)))
        fn = ctypes.CDLL(str(so)).kmeans_assign
        fn.argtypes = build.SIGNATURES["kmeans_assign"]["kmeans_assign"]
        fn.restype = ctypes.c_int
        out.append((knobs, fn))
    return out


def ptxas_report(log):
    """Registers, shared memory and spills of each kmeans_assign
    instantiation, from nvcc's `-Xptxas -v` output."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            t = re.search(r"ILb(\d)E", m.group(1))
            name = (f"{'16-byte' if t.group(1) == '1' else '4-byte'} copies"
                    if t else m.group(1))
            out[name] = {"kernel": name}
        elif name and "spill" in ln:
            out[name]["spills"] = ln.strip()
        elif name and "Used" in ln:
            out[name]["used"] = ln.split(":", 1)[1].strip()
    return list(out.values())


def call_ms(fn, iters=20):
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
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / n / 1e3


def check(label, x, c, a, dist):
    """Ids equal except where the two picks' plain d2 tie within 1e-4;
    sqdist within 1e-4. Returns (max abs error, tied swaps)."""
    pa, pdist = ref.kmeans_assign(x, c)
    d2 = ((x * x).sum(1)[:, None] - 2.0 * x @ c.T + (c * c).sum(1)[None, :])
    diff = a != pa
    if diff.any():
        vg = d2.gather(1, a.long()[:, None])[:, 0][diff]
        vw = d2.gather(1, pa.long()[:, None])[:, 0][diff]
        assert bool(((vg - vw).abs() <= 1e-4 + 1e-4 * vw.abs()).all()), \
            f"{label}: ids differ beyond a tie"
    err = (dist - pdist).abs()
    assert bool((err <= 1e-4 + 1e-4 * pdist.abs()).all()), \
        f"{label}: sqdist error {err.max().item():.3g}"
    return err.max().item(), int(diff.sum())


def shapes(g):
    base, _ = sift_like(n=100_000, nq=1, d=128, seed=0)
    rng = np.random.default_rng(0)
    ivf_x = torch.tensor(base, device="cuda")
    ivf_c = ivf_x[torch.tensor(rng.choice(len(base), 390, replace=False),
                               device="cuda")].contiguous()
    pq_x = ivf_x[:4096, :16].contiguous()
    pq_c = pq_x[torch.tensor(rng.choice(4096, 256, replace=False),
                             device="cuda")].contiguous()
    edge_c = torch.randn(390, 50, generator=g, device="cuda")
    edge_c[128] = edge_c[0]
    edge_x = torch.randn(1000, 50, generator=g, device="cuda")
    edge_x[:3] = edge_c[0]
    buf = torch.randn(1 + 3000 * 64, generator=g, device="cuda")
    return [
        ("main", torch.randn(16384, 384, generator=g, device="cuda"),
         torch.randn(256, 384, generator=g, device="cuda")),
        ("ivf", ivf_x, ivf_c),
        ("pq", pq_x, pq_c),
        ("edge d 50, NC 390, tie across a tile", edge_x, edge_c),
        ("edge x 4 bytes off alignment", buf[1:].view(3000, 64),
         torch.randn(200, 64, generator=g, device="cuda")),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("kmeans_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.build_all()
    variants = build_variants()
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, x, c in shapes(g):
        N, d = x.shape
        NC = c.shape[0]
        flops = 2.0 * N * NC * d
        bound = max(flops / F32_FLOPS_S, (N * d + NC * d + 2 * N) * 4
                    / HBM_BYTES_S) * 1e3
        lib = lambda: torch.cdist(x, c).argmin(1)  # noqa: E731
        print(json.dumps({"shape": label, "N": N, "d": d, "NC": NC,
                          "bound_ms": bound,
                          "cdist+argmin call_ms": call_ms(lib),
                          "x @ c.T call_ms": call_ms(lambda: x @ c.T),
                          "wrapper call_ms": call_ms(
                              lambda: ops.kmeans_assign(x, c))}))
        for knobs, fn in variants:
            a = torch.empty(N, dtype=torch.int32, device="cuda")
            dist = torch.empty(N, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                err = fn(x.data_ptr(), c.data_ptr(), N, NC, d, a.data_ptr(),
                         dist.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            call()
            torch.cuda.synchronize()
            err, ties = check(f"{label} {knobs}", x, c, a, dist)
            if label.startswith("edge d 50"):
                assert a[:3].tolist() == [0, 0, 0], \
                    "a tie across a tile must go to the lower id"
            ms = call_ms(call)
            print(json.dumps({"shape": label, "knobs": knobs,
                              "thread_tile": [knobs["kBM"] // 16,
                                              knobs["kBN"] // 16],
                              "max_abs_err": err, "ties": ties,
                              "call_ms": ms, "device_ms": device_ms(call),
                              "share_of_bound": bound / ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
