#!/usr/bin/env python3
"""Timeline of flash_prefill_paged's wgmma kernel on one GPU:
`python3 tools/paged_trace.py` (~1.5 minutes of command).

Builds a copy of csrc/flash_prefill_paged_sm90.cu (and of
csrc/prefill_paged.cuh, the split merge) with time stamps patched in at
fixed source lines into `build/paged_trace/`, swaps it in for the wgmma
route's C entry, and runs it at three path shapes of
`attention_probe.CHUNK_SHAPES` (the main path's chunk at offsets 64 and
0, h2o's last ring chunk; bf16 and int8 pools; h2o also at forced 8 and
16 splits). For each call it prints:
- block (0, 0, 0)'s steps in SM cycles (clock64) from its producer
  warps' start: when the consumer's Q has landed, when each tile's K and
  V stage was free to the producer ("empty ok") and its boxes issued,
  when the consumer found each tile's K and V full and when its softmax
  ended, the consumer's loop end and the block's end;
- every block's start, end of its own work and, in the last split block
  of each (kv head, row block), the merge's steps (ticket taken, m and l
  loaded, weights, end), in ns of the global timer from the first
  block's start;
- the patched kernel's profiler device ms (the stamps cost a few %).
A source line the patch looks for that has moved makes it stop with the
line. Prints the card; exits 2 without a GPU.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
OUT = ROOT / "build" / "paged_trace"

STAMPS = '''
__device__ long long g_cycles[2048];
__device__ unsigned long long g_blocks[3][1024];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define TR(i) do { if (blockIdx.x + blockIdx.y + blockIdx.z == 0) \\
  g_cycles[i] = clock64(); } while (0)
#define BT(k) do { const int b_ = blockIdx.x + gridDim.x * (blockIdx.y + \\
  gridDim.y * blockIdx.z); if (b_ < 1024) g_blocks[k][b_] = gtime(); } \\
  while (0)
'''
# (source line, stamp after it)
KERNEL_STAMPS = [
    ("  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;\n",
     "  if (threadIdx.x == 0) BT(0);\n"),
    ("  __syncthreads();\n\n  if (warp < 4) {", "\n    if (lane == 0) TR(10);"),
    ("      mbar_wait(base + 8 * (eb + s), ((i / ST) & 1) ^ 1);\n",
     "      if (lane == 0) TR((is_k ? 100 : 600) + i);\n"),
    ("      // the atoms no box carries, row by row: int8 pool rows to the\n",
     "      if (lane == 0) TR((is_k ? 400 : 900) + i);\n"),
    ("      fence_proxy_async();\n      bar_sync<128>(1);\n    }\n",
     "    if (threadIdx.x == 128) TR(1);\n"),
    ("    mbar_wait(kfull(0), 0);\n", "    if (threadIdx.x == 128) TR(200);\n"),
    ("      mbar_wait(kfull(st), (i / ST) & 1);\n",
     "      if (threadIdx.x == 128) TR(200 + i);\n"),
    ("      mbar_wait(vfull(pst), ((i - 1) / ST) & 1);\n",
     "      if (threadIdx.x == 128) TR(1000 + i - 1);\n"),
    ("    softmax(p0);\n", "    if (threadIdx.x == 128) TR(300);\n"),
    ("      softmax(p0 + i * BK);\n",
     "      if (threadIdx.x == 128) TR(300 + i);\n"),
    ("    if (lane == 0) mbar_arrive(vempty(pst));\n    float lr[2];\n",
     "    if (threadIdx.x == 128) TR(2);\n"),
]
MERGE_STAMPS = [
    ("  const int ns = splits * ROWS;\n", "  MT(0);\n"),
    ("  __syncthreads();\n  for (int r = threadIdx.x; r < ROWS; r += NT) {\n",
     "  MT(1);\n"),
    ("  // four neighbouring outputs a float4; a thread takes kU of them at\n",
     "  MT(2);\n"),
]
ENTRIES = '''
extern "C" int paged_trace_read(void* cycles, void* blocks, void* merges) {
  cudaMemcpyFromSymbol(cycles, g_cycles, sizeof(g_cycles));
  cudaMemcpyFromSymbol(blocks, g_blocks, sizeof(g_blocks));
  return (int)cudaMemcpyFromSymbol(merges, g_merge, sizeof(g_merge));
}
extern "C" int paged_trace_clear() {
  static long long c[2048] = {0};
  static unsigned long long b[3][1024] = {{0}}, m[4][64] = {{0}};
  cudaMemcpyToSymbol(g_cycles, c, sizeof(c));
  cudaMemcpyToSymbol(g_blocks, b, sizeof(b));
  return (int)cudaMemcpyToSymbol(g_merge, m, sizeof(m));
}
'''


def patch(text, stamps):
    for line, stamp in stamps:
        if text.count(line) != 1:
            raise SystemExit(f"paged_trace: source line moved: {line!r}")
        text = text.replace(line, line + stamp)
    return text


def build_traced(build):
    """The patched copy of the wgmma route's library -> its ctypes lib."""
    OUT.mkdir(parents=True, exist_ok=True)
    hdr = (build.CSRC / "prefill_paged.cuh").read_text().replace(
        "namespace {\n", "namespace {\n__device__ unsigned long long "
        "g_merge[4][64];\n#define MT(k) do { if (threadIdx.x == 0) { "
        "unsigned long long t_; asm volatile(\"mov.u64 %0, %globaltimer;\" "
        ": \"=l\"(t_)); const int p_ = blockIdx.z * gridDim.y + blockIdx.y;"
        " if (p_ < 64) g_merge[k][p_] = t_; } } while (0)\n", 1)
    (OUT / "prefill_paged.cuh").write_text(patch(hdr, MERGE_STAMPS))
    src = (build.CSRC / "flash_prefill_paged_sm90.cu").read_text()
    src = patch(src, [('#include "sm90.cuh"\n', STAMPS)] + KERNEL_STAMPS)
    src = src.replace("  if (a.splits == 1) return;\n",
                      "  if (threadIdx.x == 128) BT(1);\n"
                      "  if (a.splits == 1) return;\n")
    src = patch(src, [("      reinterpret_cast<float*>(sm + L::Q), a.out);\n",
                       "  __syncthreads();\n  if (threadIdx.x == 0) BT(2);\n"
                       "  MT(3);\n")])
    cu, so = OUT / "traced.cu", OUT / "traced.so"
    cu.write_text(src + ENTRIES)
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(OUT), "-I",
                        str(build.CSRC), "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"paged_trace: nvcc failed:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(so))


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_trace: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from repro_torch.kernels import build, ops, ref
    import attention_probe as ap
    ap.build, ap.ops, ap.ref = build, ops, ref
    build.build_all()
    lib = build_traced(build)
    fn = lib.flash_prefill_paged_wgmma
    fn.argtypes = build.SIGNATURES["flash_prefill_paged_sm90"][
        "flash_prefill_paged_wgmma"]
    fn.restype = ctypes.c_int
    build.ENTRY["flash_prefill_paged_wgmma"] = fn
    cyc = (ctypes.c_longlong * 2048)()
    blk = (ctypes.c_ulonglong * 3072)()
    mrg = (ctypes.c_ulonglong * 256)()
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, H, G, dh, ps, W, P, offset, ring_len, window in \
            ap.CHUNK_SHAPES[:3]:
        for q8 in (False, True):
            q, k, v, kp, vp, row, sc = ap.chunk_inputs(g, H, G, dh, ps, W, P,
                                                       q8)
            ring = ring_len or W * ps
            lo = max(0, offset - ring) // 64 * 64
            kw = dict(offset=offset, lo=lo, page_size=ps, ring_len=ring_len,
                      window=window, **sc)
            want = ref.flash_prefill_paged(q, k, v, kp, vp, row, **kw).float()
            for n in ((None, 8, 16) if offset > 1000 else (None,)):
                def call(n=n):
                    return ops.flash_prefill_paged_launch(
                        q, k, v, kp, vp, row, splits=n, route="wgmma", **kw)
                ap.chunk_held(call(), want, label)
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
                lib.paged_trace_clear()
                call()
                torch.cuda.synchronize()
                lib.paged_trace_read(cyc, blk, mrg)
                c, b, m = list(cyc), list(blk), list(mrg)
                st = [x for x in b[0:1024] if x]
                en = [x for x in b[1024:2048] if x]
                mg = [x for x in b[2048:3072] if x]
                t0 = min(st)
                en.sort()
                print(json.dumps({
                    "shape": label + (" int8" if q8 else ""), "splits": n,
                    "blocks": len(st), "start spread ns": max(st) - t0,
                    "own work end ns (min, median, max)":
                        [en[0] - t0, en[len(en) // 2] - t0, en[-1] - t0],
                    "merge end ns (max)": max(mg) - t0 if mg else None,
                    "merge steps ns (ticket, m and l, weights, end)": {
                        p: [m[k * 64 + p] - t0 for k in range(4)]
                        for p in range(64) if m[p]}}))

                def rel(i):
                    return c[i] - c[10] if c[i] else None
                print(json.dumps({
                    "block (0, 0, 0) cycles": label, "consumer Q loaded":
                        rel(1), "loop end": rel(2),
                    "tiles": [[rel(100 + i), rel(400 + i), rel(600 + i),
                               rel(900 + i), rel(200 + i), rel(1000 + i),
                               rel(300 + i)] for i in range(8)
                              if c[200 + i]],
                    "tile columns": "K empty ok, K issued, V empty ok, V "
                                    "issued, K full ok, V full ok, "
                                    "softmax done"}))
                print(json.dumps({"device_ms": ap.device_ms(call, 50)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
