#!/usr/bin/env python3
"""Tile-shape probe of the port's attention kernels on one GPU:
`python3 tools/attention_probe.py [--prefill | --paged | --decode | --q8 |
--zoo | --tp | --chunk [--q8]] [--src DIR]` (`--tp` runs only the three
attention kernels of qwen2-72b's tensor-parallel share, `--prefill` only
flash_prefill's routes at its bf16 path shapes, `--paged` only the decode_attention_paged
rows, `--decode` only the decode_attention rows, `--q8` only the int8
rows, `--paged --q8` both, `--zoo` only the model zoo's shapes; `--src`
names the `src` directory whose `repro_torch` is imported, so that a
parent tree unpacked with git archive can be timed in the same call,
and with `--paged` / `--q8` the tree timed in turns beside this
checkout's).

prefill (`--prefill`): nvcc's registers and spills of every
flash_prefill instantiation (`-Xptxas -v`; the wgmma plans' shared bytes
from `ops.prefill_plan`, which ptxas does not see: they are dynamic),
the host microseconds of the wgmma route's three tensor maps (the C entry
`flash_prefill_wgmma_maps`), then at each bf16 path shape
(PREFILL_SHAPES: h2o-danube-1.8b's wave prefill at B 1 and at the wave
path's B 2, q [B, 4608, 32, 80] over 8 kv heads, window 4,096;
recurrentgemma-9b's local window, q [1, 512, 16, 256] over one kv head,
window 2,048; one device's share of qwen2.5's prefill_32k, whisper's
encoder and cross-attention, gte-small's encoder, qwen2-vl's prefill, the
main path's chunk and nemotron's chunk) the `tc` route and, where the
tree routes the dh there, the `wgmma` route (`ops.flash_prefill_launch`)
held against `ref.flash_prefill` (bf16, 2e-2; the share on its first and
last 32 queries) and timed in turns with SDPA (tc, wgmma, SDPA, SDPA,
wgmma, tc: profiler device ms, and call ms), then every compiled wgmma
plan (`ops.PREFILL_PLANS`, the tile knobs: keys a tile, stages,
consumers, blocks an SM) at each shape; each route's share of the bound
of `kernels/cost.py` beside it. A timing is the mean of 20 calls, of 5
where Sq passes 8,192. A
`--src` tree without `ops.prefill_route` (a parent of the wgmma route):
its wrapper and SDPA at each shape.

flash_prefill: builds `csrc/flash_prefill.cu` once per setting of its
tensor-core route's knobs (kMT 16-row m-tiles per warp, kBK keys per
tile, kStages ring depth) into `build/attention_probe/`, holds each
build against `ref.flash_prefill` (bf16, 2e-2) and times it at the
h2o-danube-1.8b wave shape (q [B, 4608, 32, 80], k/v [B, 4608, 8, 80],
window 4096; B 1 and 2), at the main path's prefill chunk and at the
gte-small encoder's non-causal shape (q, k, v [256, 64, 6, 64]), beside
SDPA on the same inputs. decode_attention: the built kernel at h2o's
ring (q [B, 32, 80], k/v [B, 4096, 8, 80], kv_len 4609) and at the qwen2.5
wave's decode (q [16, 14, 64], k/v [16, 280, 2, 64], kv_len 136) for
at the MoE wave's (q [16, 16, 64] over 8 kv heads), at recurrentgemma's
ring and at whisper's cross-attention (below): the plan and route, the
wrapper and SDPA, then both routes (`ops.decode_attention_launch`) at
forced split counts and head groupings, each held against the plain
version (2e-2) (a `--src` tree without that entry: the wrapper only).
decode_attention_paged (`--paged`) and its int8 twin (`--q8`; both
flags together run both): nvcc's registers and spills of every
decode_attention_paged and decode_attention instantiation (they share
csrc/decode_body.cuh), then at the five path shapes (`paged_shapes`: the
main path's pages, q [4, 14, 64] over a 72-page pool through 18-entry
tables of 32-position pages at kv_len 150-240; h2o's ring pages, q [2,
32, 80] over a 256-page pool through 128-entry tables at kv_len 4,096;
the long cache, 4 rows at kv_len 4,096 through 130-entry tables; and
the int8 pool of the first two, `quantize_kv` of the same values) the
wrapper held against its plain version (2e-2) and timed in turns with a
second tree's wrapper where `--src` names one (a parent unpacked with
git archive, imported beside this checkout's in the same process:
parent, new, new, parent), with SDPA on the gathered (int8: gathered and
dequantized) K/V, and the bound of `kernels/cost.py`; then this
checkout's kernel at every forced route, split count and head grouping
(`ops.decode_attention_paged_launch`, `_q8_launch`), each held against
the plain version; with `--paged` and a second tree, also
decode_attention (the same kernel body and merge over a contiguous
cache) at its bf16 path shapes in turns with that tree's. In these two
modes `--src` names that second tree, not the one imported.
int8 (`--q8`) also: the wrappers of the two int8 decode kernels and of
their bf16 siblings, in turns (bf16, int8, int8, bf16), on the same values
(the int8 planes are `quantize_kv` of the bf16 K/V), at chip_smoke's
path shapes: the qwen2.5 wave (q [16, 14, 64], K/V [16, 280, 2, 64],
kv_len 136), h2o's ring (q [1, 32, 80], K/V [1, 4096, 8, 80], kv_len
4609), the main path's pages and h2o's ring pages; each held against its
plain version (2e-2).

chunk (`--chunk`, with `--q8` over int8 pools): nvcc's registers and
spills of every flash_prefill_paged instantiation (both sources), then
flash_prefill_paged at its path shapes (CHUNK_SHAPES: the main path's
chunk, qwen2.5-0.5B's q [1, 32, 14, 64] at offset 64 through an 11-entry
row of a 44-page pool of 32-position pages, and the same at offset 0;
h2o's last ring chunk, q [1, 32, 32, 80] at offset 4,576 through a
128-entry row of a 256-page pool, ring and window 4,096; the MoE chunk, q
[1, 32, 16, 64] over 8 kv heads; nemotron's, q [1, 32, 48, 128] over 8
kv heads at dh 128): the host microseconds of the wgmma route's four
tensor maps (the C entry `flash_prefill_paged_wgmma_maps`), both bf16
routes (`ops.flash_prefill_paged_launch(route=)`: wgmma, tc) held against
`ref.flash_prefill_paged` (bf16: rtol 2e-2, atol 2e-2 times the output's
largest value, capped at 2e-2) and timed in turns, with `--src` naming a
parent tree between that tree's flash_prefill_paged (parent, tc, wgmma,
wgmma, tc, parent); each route's share of the bound of
`kernels/cost.py`, and beside them gather + `cat` + SDPA. Then the f32
route equal bit for bit to this tree's f32 flash_prefill on the gathered
buffer, both bf16 routes at forced split counts; last the main path's
chunk taken apart in turns (`chunk_anatomy`: both routes, the wgmma route
at forced splits and through an identity row, a history of 0,
flash_prefill's wgmma and tc routes on the gathered buffer), and the
wgmma route rebuilt at each setting of its knobs (`chunk_knobs`:
CHUNK_KNOBS, the tallest TMA box, the ring's stages, the tiles of row
entries fetched ahead), timed in turns at every path shape.

zoo (`--zoo`): nvcc's registers and spills of every flash_prefill,
decode_attention and decode_attention_paged instantiation (`-Xptxas -v`,
from the build logs; `--decode` prints decode_attention's),
then the wrappers in f32 (1e-5) and bf16 (2e-2) against their plain
versions at the model zoo's shapes: flash_prefill at recurrentgemma-9b's
local attention (q [1, 512, 16, 256] over one kv head, window 2,048),
whisper-small's encoder (q, k, v [2, 1500, 12, 64], not causal) and
cross-attention (q [2, 32, 12, 64] over 1,500 frames), qwen2-vl-2b's
prefill (q [2, 320, 12, 128] over 2 kv heads); decode_attention at
recurrentgemma's ring (q [2, 16, 256] over [2, 512, 1, 256], kv_len 520)
and whisper's cross-attention (q [2, 12, 64] over 1,500 frames), each
with its plan and route beside SDPA, and in bf16 the other route's
device ms at the same plan.

Times: CUDA events over back-to-back calls (`call_ms`, host launch
included), torch.profiler's device time per call (`device_ms`, every
kernel of the call summed) and, for decode_attention and the int8 rows,
the call's time on the device timeline in a CUDA graph (`graph_ms`: the
gap before a second launch included, no host cost). Prints the card and one JSON line per
measurement; exits 2 without a GPU.
"""
import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "attention_probe"
build = ops = ref = kcost = None   # repro_torch.kernels, set by main()
# knob settings of flash_prefill's tensor-core route; the first is the
# committed one
KNOBS = [dict(kMT=1, kBK=64, kStages=2), dict(kMT=2, kBK=64, kStages=2),
         dict(kMT=1, kBK=128, kStages=2), dict(kMT=1, kBK=32, kStages=2),
         dict(kMT=1, kBK=64, kStages=3)]
SPLITS = (1, 8, 17, 32)
# flash_prefill's bf16 path shapes: (label, B, Sq, H, Sk, G, dh,
# q_offset, kv_len, causal, window)
PREFILL_SHAPES = [
    ("h2o wave B1", 1, 4608, 32, 4608, 8, 80, 0, 4608, True, 4096),
    ("h2o wave B2 (the wave path's)", 2, 4608, 32, 4608, 8, 80, 0, 4608,
     True, 4096),
    ("recurrentgemma window", 1, 512, 16, 512, 1, 256, 0, 512, True, 2048),
    ("prefill_32k share", 2, 32768, 14, 32768, 2, 64, 0, 32768, True, None),
    ("whisper encoder", 2, 1500, 12, 1500, 12, 64, 0, 1500, False, None),
    ("whisper cross", 2, 32, 12, 1500, 12, 64, 0, 1500, False, None),
    ("gte encoder", 256, 64, 6, 64, 6, 64, 0, 64, False, None),
    ("qwen2-vl prefill", 2, 320, 12, 320, 2, 128, 0, 320, True, None),
    ("main chunk", 1, 32, 14, 96, 2, 64, 64, 96, True, None),
    ("nemotron chunk", 1, 32, 48, 96, 8, 128, 64, 96, True, None),
    ("dh 128, 8k (not a path shape)", 2, 8192, 12, 8192, 2, 128, 0, 8192,
     True, None),
]


def variant_source(src, knobs):
    for name, value in knobs.items():
        line = next(ln for ln in src.splitlines()
                    if ln.startswith(f"constexpr int {name} = "))
        src = src.replace(line, f"constexpr int {name} = {value};")
    return src


def build_variants(name, entry, settings):
    """Compile `name`.cu at every knob setting in parallel; returns
    [(knobs, C entry point `entry`)]."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / f"{name}.cu").read_text()
    procs = []
    for i, knobs in enumerate(settings):
        cu, so = OUT / f"{name}_{i}.cu", OUT / f"{name}_{i}.so"
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
        regs = [ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                if "Used" in ln]
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln
                  and not ln.strip().startswith("0 bytes stack frame, 0 "
                                                 "bytes spill stores")]
        print(json.dumps({f"{name} build": knobs, "registers": regs,
                          "spill lines": spills}))
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = build.SIGNATURES[name][entry]
        fn.restype = ctypes.c_int
        out.append((knobs, fn))
    return out


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


def graph_ms(fn, n=20, reps=10):
    """Device time of one call on the card's own timeline: n calls
    captured in a CUDA graph, replayed `reps` times between CUDA events,
    so that no host launch cost enters and the gaps between a call's
    kernels do (a call of two launches pays its second launch's gap,
    which the profiler's sum of kernel times leaves out)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()                        # per-stream set-up outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * reps)


def stream():
    return torch.cuda.current_stream().cuda_stream


def flash_probe(variants, g):
    shapes = [("h2o wave B1", 1, 4608, 32, 4608, 8, 80, 4096, 0, 4608, 1),
              ("h2o wave B2", 2, 4608, 32, 4608, 8, 80, 4096, 0, 4608, 1),
              ("main-path chunk", 1, 32, 14, 352, 2, 64, 0, 64, 96, 1),
              ("gte encoder, non-causal", 256, 64, 6, 64, 6, 64, 0, 0, 64,
               0)]
    for label, B, Sq, H, Sk, G, dh, win, q_off, kv, causal in shapes:
        q = torch.randn(B, Sq, H, dh, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, Sk, G, dh, generator=g, device="cuda"
                            ).bfloat16() for _ in range(2))
        want = ref.flash_prefill(q, k, v, causal=bool(causal),
                                 window=win or None, q_offset=q_off,
                                 kv_len=kv)
        qp = q_off + torch.arange(Sq, device="cuda")[:, None]
        kp = torch.arange(Sk, device="cuda")[None, :]
        mask = ((kp <= qp) | (not causal)) & (kp < kv)
        if win:
            mask &= qp - kp < win
        qq = q.transpose(1, 2)
        kk, vv = (t.repeat_interleave(H // G, 2).transpose(1, 2)
                  for t in (k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qq, kk, vv, attn_mask=mask)
        print(json.dumps({"flash_prefill": label, "sdpa call_ms":
                          call_ms(sdpa), "sdpa device_ms": device_ms(sdpa)}))
        for knobs, fn in variants:
            out = torch.empty_like(q)

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Sq, Sk,
                         H, G, dh, causal, win, q_off, kv,
                         1.0 / math.sqrt(dh), out.data_ptr(), stream())
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            call()
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs()
            assert bool((err <= 2e-2 + 2e-2 * want.float().abs()).all()), \
                (label, knobs)
            print(json.dumps({"flash_prefill": label, "knobs": knobs,
                              "max_abs_err": err.max().item(),
                              "call_ms": call_ms(call),
                              "device_ms": device_ms(call)}))


# decode_attention's path shapes: (label, B, H, S, G, dh, kv_len, ring)
DECODE_SHAPES = [
    ("h2o ring B1", 1, 32, 4096, 8, 80, 4609, True),
    ("h2o ring B2", 2, 32, 4096, 8, 80, 4609, True),
    ("qwen wave", 16, 14, 280, 2, 64, 136, False),
    ("moe wave", 16, 16, 280, 8, 64, 136, False),
    ("recurrentgemma ring", 2, 16, 512, 1, 256, 520, True),
    ("whisper cross", 2, 12, 1500, 12, 64, 1500, False),
]


def decode_inputs(g, B, H, S, G, dh, kv, dtype=torch.bfloat16):
    q = torch.randn(B, H, dh, generator=g, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, G, dh, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v, torch.full((B,), kv, dtype=torch.int32, device="cuda")


def sdpa_decode(q, k, v, kv, ring):
    """SDPA on the same inputs (K/V expanded to H heads)."""
    H, S, G = q.shape[1], k.shape[1], k.shape[2]
    kk, vv = (t.repeat_interleave(H // G, 2).transpose(1, 2) for t in (k, v))
    n = min(kv, S) if ring else kv
    mask = (torch.arange(S, device="cuda") < n)[None, None, None, :]
    return lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[:, :, None], kk, vv, attn_mask=mask)


def forced_variants(B, H, S, G):
    """(splits, head_groups) to time beside the plan: one split, splits of
    one tile, of two, three and four, and SPLITS, at every head grouping
    with no empty group."""
    Hg, tiles = H // G, -(-S // ops.DECODE_TILE)
    plan = ops.decode_split_plan(B, G, S, Hg)
    splits = sorted({1, plan[0], tiles, max(1, tiles // 2),
                     max(1, tiles // 3), max(1, tiles // 4),
                     max(1, 2 * tiles // 3)}
                    | {s for s in SPLITS if s <= tiles})
    groups = [n for n in (1, 2, 4, 7, 8, 16)
              if n <= Hg and -(-Hg // -(-Hg // n)) == n]
    return [(s, n) for s in splits for n in groups]


def decode_probe(g):
    """Each path shape in bf16: the plan, SDPA and the wrapper; then, where
    this tree has `ops.decode_attention_launch`, both routes at every
    forced split count and head grouping, each held against the plain
    version (2e-2), with device ms."""
    forced = hasattr(ops, "decode_attention_launch")
    if forced:
        print_ptxas(("decode_attention",))
    for label, B, H, S, G, dh, kv, ring in DECODE_SHAPES:
        q, k, v, lens = decode_inputs(g, B, H, S, G, dh, kv)
        want = ref.decode_attention(q, k, v, lens, ring=ring).float()
        sdpa = sdpa_decode(q, k, v, kv, ring)
        wrap = lambda: ops.decode_attention(  # noqa: E731
            q, k, v, lens, ring=ring)
        row = {"decode_attention": label,
               "plan": ops.decode_split_plan(B, G, S, *(
                   [H // G] if forced else []))}
        if forced:
            row["route"] = ops.decode_route(q.dtype, dh)
        row.update({"sdpa call_ms": call_ms(sdpa, 50),
                    "sdpa device_ms": device_ms(sdpa),
                    "sdpa graph_ms": graph_ms(sdpa),
                    "wrapper call_ms": call_ms(wrap, 50),
                    "wrapper device_ms": device_ms(wrap),
                    "wrapper graph_ms": graph_ms(wrap)})
        print(json.dumps(row))
        if not forced:
            continue
        for route in ops.DECODE_ROUTES:
            for splits, groups in forced_variants(B, H, S, G):
                def call():
                    return ops.decode_attention_launch(
                        q, k, v, lens, route=route, splits=splits,
                        head_groups=groups)
                err = (call().float() - want).abs()
                assert bool((err <= 2e-2 + 2e-2 * want.abs()).all()), \
                    (label, route, splits, groups)
                print(json.dumps({"decode_attention": label, "route": route,
                                  "splits": splits, "head_groups": groups,
                                  "max_abs_err": err.max().item(),
                                  "device_ms": device_ms(call)}))


def paged_inputs(g, W, P, lens):
    B, H, G, dh, ps = len(lens), 14, 2, 64, 32
    q = torch.randn(B, H, dh, generator=g, device="cuda").bfloat16()
    kp, vp = (torch.randn(P, ps, G, dh, generator=g, device="cuda"
                          ).bfloat16() for _ in range(2))
    table = torch.randperm(P, generator=g, device="cuda")[:B * W].view(
        B, W).to(torch.int32)
    return q, kp, vp, torch.tensor(lens, dtype=torch.int32,
                                   device="cuda"), table


def load_tree(src):
    """`src`'s repro_torch.kernels as (build, ops, ref, cost), imported
    beside this checkout's: its modules are taken out of sys.modules
    again, and keep their own globals (its build directory, its ticket
    buffers), so both trees' wrappers run in one process."""
    def ours():
        return {n: m for n, m in sys.modules.items()
                if n == "repro_torch" or n.startswith("repro_torch.")}
    saved = ours()
    for n in saved:
        del sys.modules[n]
    sys.path.insert(0, src)
    try:
        from repro_torch.kernels import build as b, cost as c, ops as o, \
            ref as r
    finally:
        sys.path.remove(src)
        for n in ours():
            del sys.modules[n]
        sys.modules.update(saved)
    b.build_all()
    return b, o, r, c


def paged_shapes(g, q8):
    """(label, wrapper arguments) at the paged path shapes: bf16 pools,
    or (q8) the int8 pool (`quantize_kv`) of the first two."""
    from repro_torch.models import layers as L
    rows = [("main path", paged_inputs(g, 18, 72, [180, 210, 150, 240])),
            ("h2o ring pages", h2o_ring_pages(g)),
            ("long cache", paged_inputs(g, 130, 520, [4096] * 4))]
    if not q8:
        return rows
    return [(f"{label} int8", (q, *L.quantize_kv(kp), *L.quantize_kv(vp),
                               lens, table))
            for label, (q, kp, vp, lens, table) in rows[:2]]


def paged_library(args, q8):
    """SDPA over the gathered (int8: gathered and dequantized) K/V."""
    from repro_torch.models import layers as L
    q, lens, table = args[0], args[-2], args[-1]
    B, H, dh = q.shape
    ps, G = args[1].shape[1], args[1].shape[2]
    W = table.shape[1]
    j = torch.arange(W * ps, device="cuda")
    idx = table.long()[:, j // ps] * ps + (j % ps)
    mask = (j[None, :] < lens[:, None])[:, None, None, :]

    def rows(t, s=None):
        x = t.reshape((-1,) + t.shape[2:])[idx]
        if s is not None:
            x = L.dequantize_kv(x, s.reshape(-1, G)[idx], q.dtype)
        return x.repeat_interleave(H // G, 2).transpose(1, 2)

    def call():
        if q8:
            k, v = rows(args[1], args[2]), rows(args[3], args[4])
        else:
            k, v = rows(args[1]), rows(args[2])
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask)
    return call


def paged_probe(g, q8, parent):
    """The paged path shapes in turns with `parent` (module doc), then
    this checkout's kernel at every forced route, split count and head
    grouping."""
    name = "decode_attention_paged_q8" if q8 else "decode_attention_paged"
    launch = getattr(ops, name + "_launch")
    for label, args in paged_shapes(g, q8):
        q, table = args[0], args[-1]
        B, H, dh = q.shape
        ps, G = args[1].shape[1], args[1].shape[2]
        W, Hg = table.shape[1], H // G
        want = getattr(ref, name)(*args).float()
        fns = {"new": lambda args=args: getattr(ops, name)(*args)}
        if parent:
            fns["parent"] = lambda args=args: getattr(parent[1], name)(*args)
        plan = ops.decode_paged_split_plan(B, G, W, ps, Hg)
        b_ms, b_by = getattr(kcost, name)(*args).bound_ms()
        row = {name: label, "plan": plan,
               "route": ops.decode_paged_route(q.dtype, dh),
               "bound_ms": b_ms, "bound_by": b_by}
        for tree, fn in fns.items():
            err = (fn().float() - want).abs()
            assert bool((err <= 2e-2 + 2e-2 * want.abs()).all()), \
                (label, tree)
            row[f"{tree} max_abs_err"] = err.max().item()
        for turn, tree in enumerate(("parent", "new", "new", "parent")
                                    if parent else ("new", "new")):
            row[f"{tree} device_ms {turn}"] = device_ms(fns[tree], 50)
            row[f"{tree} call_ms {turn}"] = call_ms(fns[tree], 50)
            row[f"{tree} graph_ms {turn}"] = graph_ms(fns[tree])
        lib = paged_library(args, q8)
        row["sdpa device_ms"] = device_ms(lib)
        row["sdpa call_ms"] = call_ms(lib)
        print(json.dumps(row))
        routes = [r for r in ops.DECODE_ROUTES if r == "cuda"
                  or ops.decode_paged_route(q.dtype, dh) == "tc"]
        splits = sorted({1, 2, 4, 8, plan[0], W // 4, W // 2, W}
                        & set(range(1, W + 1)))
        groups = [n for n in (1, 2, 4, 7, 8, 16)
                  if n <= Hg and -(-Hg // -(-Hg // n)) == n]
        for route in routes:
            for sp in splits:
                for hg in groups:
                    def call(route=route, sp=sp, hg=hg):
                        return launch(*args, route=route, splits=sp,
                                      head_groups=hg)
                    err = (call().float() - want).abs()
                    assert bool((err <= 2e-2 + 2e-2 * want.abs()).all()), \
                        (label, route, sp, hg)
                    print(json.dumps({name: label, "route": route,
                                      "splits": sp, "head_groups": hg,
                                      "max_abs_err": err.max().item(),
                                      "device_ms": device_ms(call)}))


def shared_body_turns(g, parent):
    """decode_attention (whose body and merge the paged kernel shares) at
    its bf16 path shapes, and decode_attention_q8 at three of them, in
    turns with `parent`'s: device (and graph) ms."""
    for label, B, H, S, G, dh, kv, ring in DECODE_SHAPES:
        q, k, v, lens = decode_inputs(g, B, H, S, G, dh, kv)
        want = ref.decode_attention(q, k, v, lens, ring=ring).float()
        fns = {"new": lambda: ops.decode_attention(q, k, v, lens, ring=ring),
               "parent": lambda: parent[1].decode_attention(q, k, v, lens,
                                                            ring=ring)}
        row = {"decode_attention": label,
               "plan": ops.decode_split_plan(B, G, S, H // G)}
        for tree, fn in fns.items():
            err = (fn().float() - want).abs()
            assert bool((err <= 2e-2 + 2e-2 * want.abs()).all()), \
                (label, tree)
        for turn, tree in enumerate(("parent", "new", "new", "parent")):
            row[f"{tree} device_ms {turn}"] = device_ms(fns[tree], 50)
            row[f"{tree} graph_ms {turn}"] = graph_ms(fns[tree])
        print(json.dumps(row))
    from repro_torch.models import layers as L
    for label, B, H, S, G, dh, kv, ring in DECODE_SHAPES[:3]:
        q, k, v, lens = decode_inputs(g, B, H, S, G, dh, kv)
        a8 = (*L.quantize_kv(k), *L.quantize_kv(v), lens)
        want = ref.decode_attention_q8(q, *a8, ring=ring).float()
        fns = {"new": lambda: ops.decode_attention_q8(q, *a8, ring=ring),
               "parent": lambda: parent[1].decode_attention_q8(q, *a8,
                                                               ring=ring)}
        row = {"decode_attention_q8": label}
        for tree, fn in fns.items():
            err = (fn().float() - want).abs()
            assert bool((err <= 2e-2 + 2e-2 * want.abs()).all()), \
                (label, tree)
        for turn, tree in enumerate(("parent", "new", "new", "parent")):
            row[f"{tree} device_ms {turn}"] = device_ms(fns[tree], 50)
        print(json.dumps(row))


def q8_probe(g):
    from repro_torch.models import layers as L
    wave = [("qwen wave", 16, 14, 280, 2, 64, 136, False),
            ("h2o ring", 1, 32, 4096, 8, 80, 4609, True)]
    cases = []
    for label, B, H, S, G, dh, kv, ring in wave:
        q = torch.randn(B, H, dh, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, S, G, dh, generator=g, device="cuda"
                            ).bfloat16() for _ in range(2))
        lens = torch.full((B,), kv, dtype=torch.int32, device="cuda")
        a8 = (*L.quantize_kv(k), *L.quantize_kv(v), lens)
        cases.append((label, (
            lambda q=q, k=k, v=v, lens=lens, ring=ring:
                ops.decode_attention(q, k, v, lens, ring=ring),
            lambda q=q, a8=a8, ring=ring:
                ops.decode_attention_q8(q, *a8, ring=ring),
            lambda q=q, a8=a8, ring=ring:
                ref.decode_attention_q8(q, *a8, ring=ring))))
    paged = [("main path", paged_inputs(g, 18, 72, [180, 210, 150, 240])),
             ("h2o ring pages", h2o_ring_pages(g))]
    for label, (q, kp, vp, lens, table) in paged:
        a8 = (*L.quantize_kv(kp), *L.quantize_kv(vp), lens, table)
        cases.append((label, (
            lambda q=q, kp=kp, vp=vp, lens=lens, table=table:
                ops.decode_attention_paged(q, kp, vp, lens, table),
            lambda q=q, a8=a8: ops.decode_attention_paged_q8(q, *a8),
            lambda q=q, a8=a8: ref.decode_attention_paged_q8(q, *a8))))
    for label, (bf16, int8, plain) in cases:
        want = plain().float()
        err = (int8().float() - want).abs()
        assert bool((err <= 2e-2 + 2e-2 * want.abs()).all()), label
        row = {"q8": label, "max_abs_err": err.max().item()}
        for turn, (name, fn) in enumerate(
                (("bf16", bf16), ("int8", int8), ("int8", int8),
                 ("bf16", bf16))):
            row[f"{name} call_ms {turn}"] = call_ms(fn, 50)
            row[f"{name} device_ms {turn}"] = device_ms(fn)
            row[f"{name} graph_ms {turn}"] = graph_ms(fn)
        print(json.dumps(row))


def h2o_ring_pages(g):
    """Two rows of h2o's ring pages: q [2, 32, 80] over a 256-page bf16
    pool of 32-position pages through 128-entry tables, kv_len 4,096."""
    B, H, G, dh, ps, W = 2, 32, 8, 80, 32, 128
    q = torch.randn(B, H, dh, generator=g, device="cuda").bfloat16()
    kp, vp = (torch.randn(B * W, ps, G, dh, generator=g, device="cuda"
                          ).bfloat16() for _ in range(2))
    table = torch.randperm(B * W, generator=g, device="cuda").view(
        B, W).to(torch.int32)
    return q, kp, vp, torch.full((B,), W * ps, dtype=torch.int32,
                                 device="cuda"), table


def ptxas_lines(name):
    """(kernel, registers, spill line) of each entry function in the
    `-Xptxas -v` log that build.build_all kept for `name`."""
    log = (build.BUILD_DIR / f"{name}.log").read_text().splitlines()
    out, fn = [], None
    for ln in log:
        if "Compiling entry function" in ln:
            fn, spill = ln.split("'")[1], ""
        elif fn and "spill" in ln:
            spill = ln.split(":")[-1].strip()
        elif fn and "Used" in ln:
            out.append((fn, ln.split("Used ")[1].split(",")[0], spill))
            fn = None
    return out


def print_ptxas(names):
    for name in names:
        for fn, regs, spill in ptxas_lines(name):
            print(json.dumps({"ptxas": name, "kernel": fn,
                              "registers": regs, "spill": spill}))


def zoo_probe(g):
    print_ptxas(("flash_prefill", "decode_attention",
                 "decode_attention_paged"))
    flash = [("recurrentgemma local window", 1, 512, 16, 512, 1, 256, 2048,
              True),
             ("whisper encoder", 2, 1500, 12, 1500, 12, 64, None, False),
             ("whisper cross", 2, 32, 12, 1500, 12, 64, None, False),
             ("qwen2-vl prefill", 2, 320, 12, 320, 2, 128, None, True)]
    for label, B, Sq, H, Sk, G, dh, win, causal in flash:
        q = torch.randn(B, Sq, H, dh, generator=g, device="cuda")
        k, v = (torch.randn(B, Sk, G, dh, generator=g, device="cuda")
                for _ in range(2))
        qp = torch.arange(Sq, device="cuda")[:, None]
        kp = torch.arange(Sk, device="cuda")[None, :]
        mask = (kp <= qp) | (not causal)
        if win:
            mask &= qp - kp < win
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            a = [t.to(dt) for t in (q, k, v)]
            kw = dict(causal=causal, window=win)
            got = ops.flash_prefill(*a, **kw)
            want = ref.flash_prefill(*a, **kw)
            err = (got.float() - want.float()).abs()
            assert bool((err <= tol + tol * want.float().abs()).all()), \
                (label, dt)
            qq = a[0].transpose(1, 2)
            kk, vv = (t.repeat_interleave(H // G, 2).transpose(1, 2)
                      for t in a[1:])
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qq, kk, vv, attn_mask=mask)
            call = lambda: ops.flash_prefill(*a, **kw)  # noqa: E731
            print(json.dumps({"flash_prefill": label, "dtype": str(dt),
                              "max_abs_err": err.max().item(),
                              "call_ms": call_ms(call),
                              "device_ms": device_ms(call),
                              "sdpa call_ms": call_ms(sdpa),
                              "sdpa device_ms": device_ms(sdpa)}))
    for label, B, H, S, G, dh, kv, ring in DECODE_SHAPES[-2:]:
        q, k, v, lens = decode_inputs(g, B, H, S, G, dh, kv, torch.float32)
        forced = hasattr(ops, "decode_attention_launch")
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            a = [t.to(dt) for t in (q, k, v)]
            got = ops.decode_attention(*a, lens, ring=ring)
            want = ref.decode_attention(*a, lens, ring=ring)
            err = (got.float() - want.float()).abs()
            assert bool((err <= tol + tol * want.float().abs()).all()), \
                (label, dt)
            sdpa = sdpa_decode(*a, kv, ring)
            call = lambda: ops.decode_attention(  # noqa: E731
                *a, lens, ring=ring)
            row = {"decode_attention": label, "dtype": str(dt),
                   "plan": ops.decode_split_plan(B, G, S, *(
                       [H // G] if forced else [])),
                   "stages": ops.decode_stages(H // G, dh,
                                               a[0].element_size()),
                   "max_abs_err": err.max().item(),
                   "call_ms": call_ms(call, 50),
                   "device_ms": device_ms(call),
                   "graph_ms": graph_ms(call),
                   "sdpa call_ms": call_ms(sdpa, 50),
                   "sdpa device_ms": device_ms(sdpa),
                   "sdpa graph_ms": graph_ms(sdpa)}
            if forced:
                row["route"] = ops.decode_route(dt, dh)
                # the other route at the same plan (bf16 only)
                if dt == torch.bfloat16:
                    other = "cuda" if row["route"] == "tc" else "tc"
                    oc = lambda: ops.decode_attention_launch(  # noqa: E731
                        *a, lens, route=other)
                    oerr = (oc().float() - want.float()).abs()
                    assert bool((oerr <= tol + tol * want.float().abs()
                                 ).all()), (label, other)
                    row[f"{other} route device_ms"] = device_ms(oc)
            print(json.dumps(row))


def prefill_inputs(g, B, Sq, H, Sk, G, dh):
    q = torch.randn(B, Sq, H, dh, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(B, Sk, G, dh, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    return q, k, v


def prefill_held(got, q, k, v, kw):
    """Max abs error of `got` against the plain version (2e-2 asserted),
    on the first and last 32 queries alone where Sq passes 4,096 (the
    plain scores of the whole shape would not fit)."""
    Sq = q.shape[1]
    parts = [(0, Sq)] if Sq <= 4096 else [(0, 32), (Sq - 32, Sq)]
    err = 0.0
    for lo, hi in parts:
        want = ref.flash_prefill(q[:, lo:hi], k, v, **dict(
            kw, q_offset=kw["q_offset"] + lo)).float()
        e = (got[:, lo:hi].float() - want).abs()
        assert bool((e <= 2e-2 + 2e-2 * want.abs()).all()), (lo, hi)
        err = max(err, e.max().item())
    return err


def prefill_sdpa(q, k, v, q_off, kv, causal, window=None):
    """SDPA on the same inputs, K/V expanded to H heads: is_causal where
    the mask is the plain causal one, else a boolean mask."""
    H, Sq, Sk, G = q.shape[2], q.shape[1], k.shape[1], k.shape[2]
    qq = q.transpose(1, 2)
    kk, vv = (t.repeat_interleave(H // G, 2).transpose(1, 2) for t in (k, v))
    if causal and q_off == 0 and kv == Sk == Sq and not window:
        return lambda: F.scaled_dot_product_attention(  # noqa: E731
            qq, kk, vv, is_causal=True)
    qp = q_off + torch.arange(Sq, device="cuda")[:, None]
    kp = torch.arange(Sk, device="cuda")[None, :]
    mask = ((kp <= qp) | (not causal)) & (kp < kv)
    if window:
        mask &= qp - kp < window
    return lambda: F.scaled_dot_product_attention(  # noqa: E731
        qq, kk, vv, attn_mask=mask)


def prefill_probe(g):
    """flash_prefill's routes at its bf16 path shapes (module doc)."""
    routed = hasattr(ops, "prefill_route")
    print_ptxas(("flash_prefill",) + (("flash_prefill_sm90",) if routed
                                      else ()))
    if not routed:
        for label, B, Sq, H, Sk, G, dh, q_off, kv, causal, win in \
                PREFILL_SHAPES:
            q, k, v = prefill_inputs(g, B, Sq, H, Sk, G, dh)
            kw = dict(causal=causal, q_offset=q_off, kv_len=kv, window=win)
            wrap = lambda: ops.flash_prefill(q, k, v, **kw)  # noqa: E731
            sdpa = prefill_sdpa(q, k, v, q_off, kv, causal, win)
            n = 5 if Sq > 4096 else 20
            print(json.dumps({"flash_prefill": label, "src": "wrapper",
                              "max_abs_err": prefill_held(wrap(), q, k, v,
                                                          kw),
                              "wrapper device_ms": device_ms(wrap, n),
                              "sdpa device_ms": device_ms(sdpa, n),
                              "wrapper call_ms": call_ms(wrap, n)}))
        return
    for dh in ops.PREFILL_WGMMA_DH:
        for plan in ops.PREFILL_PLANS[dh]:
            print(json.dumps({"wgmma plan": ops.prefill_plan(dh, plan=plan),
                              "dh": dh}))
    q, k, v = prefill_inputs(g, *PREFILL_SHAPES[0][1:7])
    enc = build.entry("flash_prefill_wgmma_maps")
    for iters in (1, 1000):
        t0 = time.perf_counter()
        err = enc(q.data_ptr(), k.data_ptr(), v.data_ptr(), 2, 32768, 32768,
                  14, 2, 64, 128, 128, iters)
        us = (time.perf_counter() - t0) / iters * 1e6
        assert err == 0, err
    print(json.dumps({"wgmma maps": "three tensor maps encoded on the host",
                      "us_per_call": us}))
    for label, B, Sq, H, Sk, G, dh, q_off, kv, causal, win in \
            PREFILL_SHAPES:
        q, k, v = prefill_inputs(g, B, Sq, H, Sk, G, dh)
        kw = dict(causal=causal, q_offset=q_off, kv_len=kv, window=win)
        n = 5 if Sq > 8192 else 20
        wgmma = dh in ops.PREFILL_WGMMA_DH
        calls = {route: lambda route=route: ops.flash_prefill_launch(
            q, k, v, route=route, **kw)
            for route in ("tc", "wgmma") if route == "tc" or wgmma}
        b_ms, b_by = kcost.flash_prefill(q, k, v, **kw).bound_ms()
        row = {"flash_prefill": label, "route": ops.prefill_route(q.dtype,
                                                                  dh),
               "bound_ms": b_ms, "bound_by": b_by}
        if wgmma:
            row["plan"] = ops.prefill_plan(dh, Sq, Sk, B * H)
        for route, fn in calls.items():
            row[f"{route} max_abs_err"] = prefill_held(fn(), q, k, v, kw)
        calls["sdpa"] = prefill_sdpa(q, k, v, q_off, kv, causal, win)
        for turn, name in enumerate(("tc", "wgmma", "sdpa", "sdpa", "wgmma",
                                     "tc")):
            if name in calls:
                row[f"{name} device_ms {turn}"] = device_ms(calls[name], n)
        for name, fn in calls.items():
            row[f"{name} call_ms"] = call_ms(fn, n)
            dev = [v_ for k_, v_ in row.items()
                   if k_.startswith(f"{name} device_ms ")]
            if sum(dev):
                row[f"{name} bound share"] = b_ms / (sum(dev) / len(dev))
        print(json.dumps(row))
        if not wgmma:
            continue
        for plan in ops.PREFILL_PLANS[dh]:
            fn = lambda plan=plan: ops.flash_prefill_launch(  # noqa: E731
                q, k, v, route="wgmma", plan=plan, **kw)
            print(json.dumps({"flash_prefill": label, "wgmma plan": plan,
                              "max_abs_err": prefill_held(fn(), q, k, v, kw),
                              "device_ms": device_ms(fn, n)}))


# flash_prefill_paged's path shapes: (label, H, G, dh, ps, W, P, offset,
# ring_len, window)
# flash_prefill_paged's path shapes: (label, H, G, dh, ps, W, P, offset,
# ring_len, window); with --q8 over int8 pools (the qwen int8 chunk, h2o's
# int8 last ring chunk)
CHUNK_SHAPES = [("main path chunk", 14, 2, 64, 32, 11, 44, 64, 0, None),
                ("main path chunk, history 0", 14, 2, 64, 32, 11, 44, 0, 0,
                 None),
                ("h2o last ring chunk", 32, 8, 80, 32, 128, 256, 4576, 4096,
                 4096),
                ("moe chunk", 16, 8, 64, 32, 11, 44, 64, 0, None),
                ("nemotron chunk", 48, 8, 128, 32, 11, 44, 64, 0, None)]


def chunk_inputs(g, H, G, dh, ps, W, P, q8, dtype=torch.bfloat16):
    """q [1, 32, H, dh], the chunk's k, v [32, G, dh] (fake-quantized with
    `q8`), the pools [P, ps, G, dh] (int8 with their scales, as a dict of
    keyword arguments), a random W-entry row."""
    from repro_torch.models import layers as L

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)
    q, k, v = rnd(1, 32, H, dh), rnd(32, G, dh), rnd(32, G, dh)
    kp, vp = rnd(P, ps, G, dh), rnd(P, ps, G, dh)
    scales = {}
    if q8:
        k = L.dequantize_kv(*L.quantize_kv(k), dtype)
        v = L.dequantize_kv(*L.quantize_kv(v), dtype)
        (kp, ks), (vp, vs) = L.quantize_kv(kp), L.quantize_kv(vp)
        scales = {"k_scale": ks, "v_scale": vs}
    row = torch.randperm(P, generator=g, device="cuda")[:W].to(torch.int32)
    return q, k, v, kp, vp, row, scales


def gathered(q, k, v, kp, vp, row, scales, offset, lo, ps, ring):
    """The K/V buffers of the chunk's way before flash_prefill_paged: the
    history [lo, offset) gathered through the row (int8: dequantized to
    q's dtype), then the chunk."""
    gi = ref.history_rows(row, lo, offset, ps, ring)
    out = []
    for t, c, s in ((kp, k, scales.get("k_scale")),
                    (vp, v, scales.get("v_scale"))):
        h = t.reshape((-1,) + t.shape[2:])[gi]
        if s is not None:
            h = (h.float() * s.reshape(-1, s.shape[-1])[gi][..., None]
                 ).to(q.dtype)
        out.append(torch.cat([h, c])[None])
    return out


def chunk_held(got, want, what):
    """A chunk's bf16 output held against the plain one (`want`, f32) at
    rtol 2e-2 and atol 2e-2 times its largest value, capped at 2e-2 (an
    output over thousands of keys is a few hundredths); its max abs
    error."""
    err = (got.float() - want).abs()
    atol = 2e-2 * min(1.0, want.abs().max().item())
    assert bool((err <= atol + 2e-2 * want.abs()).all()), what
    return err.max().item()


def maps_host_us(q, k, v, kp, vp, sc, ps, n=2000):
    """Host microseconds of the wgmma route's tensor maps for one call
    (the C entry flash_prefill_paged_wgmma_maps: the pool's and the
    chunk's K and V maps encoded n times)."""
    G, dh = k.shape[1], k.shape[2]
    fn = build.entry("flash_prefill_paged_wgmma_maps")
    args = (k.data_ptr(), v.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            int(bool(sc)), kp.shape[0], ps, G, dh, q.shape[1])
    assert fn(*args, 1) == 0
    t0 = time.perf_counter()
    assert fn(*args, n) == 0
    return (time.perf_counter() - t0) / n * 1e6


def chunk_anatomy(g, q8):
    """Where the main path's chunk (CHUNK_SHAPES[0]) spends its device
    time against flash_prefill on the gathered buffer, in turns (listed
    order, then reversed): the call on both bf16 routes (the plan's one
    split, 8 blocks); the wgmma route at forced two splits of one key tile
    each (16 blocks and the merge) and through an identity row (contiguous
    pages); then flash_prefill on the gathered buffer on its wgmma route
    (the wrapper's, 14 blocks) and its tc route; and the same at a history
    of 0 (offset 0: no table row read; flash_prefill on the chunk's own
    K/V). Each held against the plain version first."""
    label, H, G, dh, ps, W, P, offset, ring_len, window = CHUNK_SHAPES[0]
    q, k, v, kp, vp, row, sc = chunk_inputs(g, H, G, dh, ps, W, P, q8)
    ident = torch.arange(W, dtype=torch.int32, device="cuda")
    C = q.shape[1]
    for off in (offset, 0):
        kw = dict(offset=off, lo=0, page_size=ps, ring_len=ring_len,
                  window=window, **sc)
        want = ref.flash_prefill_paged(q, k, v, kp, vp, row, **kw).float()
        kb, vb = gathered(q, k, v, kp, vp, row, sc, off, 0, ps, W * ps)
        pkw = dict(causal=True, window=window, q_offset=off, kv_len=off + C)
        fns = {
            "wgmma": lambda kw=kw: ops.flash_prefill_paged_launch(
                q, k, v, kp, vp, row, route="wgmma", **kw),
            "tc": lambda kw=kw: ops.flash_prefill_paged_launch(
                q, k, v, kp, vp, row, route="tc", **kw),
            "flash_prefill wgmma": lambda kb=kb, vb=vb, pkw=pkw:
                ops.flash_prefill_launch(q, kb, vb, route="wgmma", **pkw),
            "flash_prefill tc": lambda kb=kb, vb=vb, pkw=pkw:
                ops.flash_prefill_launch(q, kb, vb, route="tc", **pkw)}
        if off:
            fns["wgmma 2 splits"] = lambda kw=kw: \
                ops.flash_prefill_paged_launch(q, k, v, kp, vp, row,
                                               splits=2, route="wgmma", **kw)
            fns["wgmma identity row"] = lambda kw=kw: \
                ops.flash_prefill_paged_launch(q, k, v, kp, vp, ident,
                                               route="wgmma", **kw)
            want_i = ref.flash_prefill_paged(q, k, v, kp, vp, ident,
                                             **kw).float()
        out = {"chunk anatomy": f"{label}{' int8' if q8 else ''}, offset "
               f"{off}", "plan": ops.prefill_paged_plan(
                   C, off, G, H // G, dh, window)._asdict()}
        for name, fn in fns.items():
            out[f"{name} max_abs_err"] = chunk_held(
                fn(), want_i if name == "wgmma identity row" else want,
                (off, name))
        order = list(fns) + list(fns)[::-1]
        for turn, name in enumerate(order):
            out[f"{name} device_ms {turn}"] = device_ms(fns[name], 50)
        print(json.dumps(out))


# knob settings of the wgmma route's source (csrc/
# flash_prefill_paged_sm90.cu); the first is the committed one
CHUNK_KNOBS = [dict(kBoxRows=64, kStages=3, kAhead=2), dict(kBoxRows=8),
               dict(kStages=2), dict(kAhead=4)]


def chunk_knobs(g, q8):
    """The wgmma route rebuilt at each CHUNK_KNOBS setting (`build_variants`:
    the tallest TMA box, the ring's stages, the tiles of row entries
    fetched ahead), each held against the plain version and timed at
    CHUNK_SHAPES in turns (the settings in order, then reversed)."""
    variants = build_variants("flash_prefill_paged_sm90",
                              "flash_prefill_paged_wgmma", CHUNK_KNOBS)
    real = build.ENTRY["flash_prefill_paged_wgmma"]
    try:
        for label, H, G, dh, ps, W, P, offset, ring_len, window in \
                CHUNK_SHAPES:
            q, k, v, kp, vp, row, sc = chunk_inputs(g, H, G, dh, ps, W, P,
                                                    q8)
            ring = ring_len or W * ps
            lo = max(0, offset - ring) // 64 * 64
            kw = dict(offset=offset, lo=lo, page_size=ps, ring_len=ring_len,
                      window=window, **sc)
            want = ref.flash_prefill_paged(q, k, v, kp, vp, row,
                                           **kw).float()
            out = {"chunk knobs": label + (" int8" if q8 else "")}

            def call():
                return ops.flash_prefill_paged_launch(
                    q, k, v, kp, vp, row, route="wgmma", **kw)
            order = list(range(len(variants))) + \
                list(range(len(variants)))[::-1]
            for turn, i in enumerate(order):
                knobs, fn = variants[i]
                build.ENTRY["flash_prefill_paged_wgmma"] = fn
                chunk_held(call(), want, (label, knobs))
                out[f"{json.dumps(knobs)} device_ms {turn}"] = device_ms(
                    call, 50)
            print(json.dumps(out))
    finally:
        build.ENTRY["flash_prefill_paged_wgmma"] = real


def chunk_probe(g, q8, parent):
    """flash_prefill_paged at CHUNK_SHAPES on both bf16 routes in turns
    with the parent's wrapper (module doc), the maps' host cost, then its
    f32 route bit for bit and both bf16 routes at forced splits."""
    for label, H, G, dh, ps, W, P, offset, ring_len, window in CHUNK_SHAPES:
        q, k, v, kp, vp, row, sc = chunk_inputs(g, H, G, dh, ps, W, P, q8)
        ring = ring_len or W * ps
        C = q.shape[1]
        tile = ops.prefill_paged_key_tile(q.dtype, dh)
        lo = max(0, offset - ring) // tile * tile
        kw = dict(offset=offset, lo=lo, page_size=ps, ring_len=ring_len,
                  window=window, **sc)
        want = ref.flash_prefill_paged(q, k, v, kp, vp, row, **kw).float()
        fns = {r: lambda kw=kw, r=r: ops.flash_prefill_paged_launch(
            q, k, v, kp, vp, row, route=r, **kw) for r in ("wgmma", "tc")}
        plan = ops.prefill_paged_plan(C, offset - lo, G, H // G, dh, window)
        b_ms, b_by = kcost.flash_prefill_paged(q, k, v, kp, vp, row,
                                               **kw).bound_ms()
        out = {"flash_prefill_paged": label + (" int8" if q8 else ""),
               "route": ops.prefill_paged_route(q.dtype, dh),
               "plan": plan._asdict(), "bound_ms": b_ms, "bound_by": b_by,
               "maps host_us": maps_host_us(q, k, v, kp, vp, sc, ps)}
        order = ("tc", "wgmma", "wgmma", "tc")
        if parent:
            fns["parent"] = lambda kw=kw: parent[1].flash_prefill_paged(
                q, k, v, kp, vp, row, **kw)
            order = ("parent",) + order + ("parent",)
        out["max_abs_want"] = want.abs().max().item()
        for name, fn in fns.items():
            out[f"{name} max_abs_err"] = chunk_held(fn(), want, (label, name))
        for turn, name in enumerate(order):
            out[f"{name} device_ms {turn}"] = device_ms(fns[name], 50)
            out[f"{name} call_ms {turn}"] = call_ms(fns[name], 50)
        for name in fns:
            dev = [out[f"{name} device_ms {t}"] for t, n in enumerate(order)
                   if n == name]
            out[f"{name} bound share"] = b_ms / (sum(dev) / len(dev))
        kb, vb = gathered(q, k, v, kp, vp, row, sc, offset, lo, ps, ring)
        Sk = kb.shape[1]
        qpos = offset - lo + torch.arange(C, device="cuda")[:, None]
        kpos = torch.arange(Sk, device="cuda")[None, :]
        mask = kpos <= qpos
        if window:
            mask = mask & (qpos - kpos < window)

        def library():
            kb_, vb_ = gathered(q, k, v, kp, vp, row, sc, offset, lo, ps,
                                ring)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kb_.repeat_interleave(H // G, 2
                                                         ).transpose(1, 2),
                vb_.repeat_interleave(H // G, 2).transpose(1, 2),
                attn_mask=mask)
        out["gather + cat + sdpa device_ms"] = device_ms(library)
        out["gather + cat + sdpa call_ms"] = call_ms(library)
        out["plain call_ms"] = call_ms(lambda: ref.flash_prefill_paged(
            q, k, v, kp, vp, row, **kw), 5)
        # the f32 route: bit-equal to f32 flash_prefill on the buffer
        a32 = chunk_inputs(g, H, G, dh, ps, W, P, q8, torch.float32)
        tile = ops.prefill_paged_key_tile(torch.float32, dh)
        lo32 = max(0, offset - ring) // tile * tile
        kw32 = dict(kw, lo=lo32, **a32[-1])
        got32 = ops.flash_prefill_paged(*a32[:6], **kw32)
        kb32, vb32 = gathered(*a32, offset, lo32, ps, ring)
        assert torch.equal(got32, ops.flash_prefill(
            a32[0], kb32, vb32, causal=True, window=window,
            q_offset=offset - lo32, kv_len=offset + C - lo32)), label
        out["f32 bit-equal to flash_prefill on the buffer"] = True
        print(json.dumps(out))
        for n in sorted({1, 2, 4, 8, 16, plan.splits}
                        & set(range(1, plan.tiles + 1))):
            res = {"flash_prefill_paged": label + (" int8" if q8 else ""),
                   "splits": n}
            for r in ("wgmma", "tc"):
                def call(n=n, r=r):
                    return ops.flash_prefill_paged_launch(
                        q, k, v, kp, vp, row, splits=n, route=r, **kw)
                res[f"{r} max_abs_err"] = chunk_held(call(), want,
                                                     (label, r, n))
                res[f"{r} device_ms"] = device_ms(call, 50)
            print(json.dumps(res))


# qwen2-72b's share of tp 4 on chip_smoke's tp_share path: 16 query
# heads over 2 kv heads of dh 128, a prefill of 2 x 512 tokens and
# decode steps over its 520-slot cache (bf16 and int8)
TP_SHARE = dict(B=2, S=512, H=16, G=2, dh=128, kv=520)


def tp_probe(g):
    """flash_prefill, decode_attention and decode_attention_q8 at the
    tp-4 share's shapes (TP_SHARE), random bf16 inputs: each held
    against its plain version (2e-2), then timed in turns with its
    library call (kernel, library, library, kernel: call ms and profiler
    device ms), beside its bound (`kernels/cost.py`)."""
    from repro_torch.models import layers as L
    B, S, H, G, dh, kv = (TP_SHARE[k] for k in
                          ("B", "S", "H", "G", "dh", "kv"))
    q, k, v = prefill_inputs(g, B, S, H, S, G, dh)
    kw = dict(causal=True, window=None, q_offset=0, kv_len=None)
    qd, kd, vd, lens = decode_inputs(g, B, H, kv, G, dh, kv)
    a8 = (*L.quantize_kv(kd), *L.quantize_kv(vd), lens)

    def q8_library():
        kk, vv = (L.dequantize_kv(*a8[i:i + 2], qd.dtype) for i in (0, 2))
        return sdpa_decode(qd, kk, vv, kv, False)()
    rows = [
        ("flash_prefill", lambda: ops.flash_prefill(q, k, v),
         lambda: prefill_held(ops.flash_prefill(q, k, v), q, k, v, kw),
         prefill_sdpa(q, k, v, 0, S, True),
         kcost.flash_prefill(q, k, v), f"q {[B, S, H, dh]}, k "
         f"{[B, S, G, dh]}, causal"),
        ("decode_attention", lambda: ops.decode_attention(qd, kd, vd, lens),
         lambda: (ops.decode_attention(qd, kd, vd, lens).float()
                  - ref.decode_attention(qd, kd, vd, lens).float()
                  ).abs().max().item(),
         sdpa_decode(qd, kd, vd, kv, False),
         kcost.decode_attention(qd, kd, vd, lens, False),
         f"q {[B, H, dh]}, k {[B, kv, G, dh]}, kv_len {kv}"),
        ("decode_attention_q8", lambda: ops.decode_attention_q8(qd, *a8),
         lambda: (ops.decode_attention_q8(qd, *a8).float()
                  - ref.decode_attention_q8(qd, *a8).float()
                  ).abs().max().item(),
         q8_library, kcost.decode_attention_q8(qd, *a8),
         f"q {[B, H, dh]}, int8 k {[B, kv, G, dh]}, kv_len {kv}")]
    for name, fn, held, lib, c, shape in rows:
        err = held()
        assert err <= 2e-2, (name, err)
        bound, by = c.bound_ms()
        row = {"tp_share": name, "shape": shape, "max_abs_err": err,
               "bound_ms": bound, "bound_by": by}
        for turn, (who, f) in enumerate((("kernel", fn), ("library", lib),
                                         ("library", lib),
                                         ("kernel", fn))):
            row[f"{who} call_ms {turn}"] = call_ms(f)
            row[f"{who} device_ms {turn}"] = device_ms(f)
        print(json.dumps(row))


def main() -> int:
    global build, ops, ref, kcost
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--prefill", action="store_true")
    only.add_argument("--decode", action="store_true")
    only.add_argument("--zoo", action="store_true")
    only.add_argument("--tp", action="store_true")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--q8", action="store_true")
    ap.add_argument("--chunk", action="store_true")
    args = ap.parse_args()
    if (args.paged or args.q8 or args.chunk) and (args.prefill or args.decode
                                                  or args.zoo or args.tp):
        ap.error("--paged, --chunk and --q8 go with each other only")
    if args.chunk and args.paged:
        ap.error("--chunk and --paged: one at a time")
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    paged = args.paged or args.q8 or args.chunk
    parent = None
    if paged and Path(args.src).resolve() != (ROOT / "src").resolve():
        parent = load_tree(args.src)
        print(json.dumps({"parent": args.src}))
    sys.path.insert(0, str(ROOT / "src") if paged else args.src)
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cost as kcost
    print(json.dumps({"src": str(ROOT / "src") if paged else args.src}))
    build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    if args.chunk:
        print_ptxas(("flash_prefill_paged_sm90", "flash_prefill_paged"))
        chunk_probe(g, args.q8, parent)
        chunk_anatomy(g, args.q8)
        chunk_knobs(g, args.q8)
        return 0
    if paged:
        print_ptxas(("decode_attention_paged", "decode_attention"))
        if args.paged:
            paged_probe(g, False, parent)
            if parent:
                shared_body_turns(g, parent)
        if args.q8:
            paged_probe(g, True, parent)
            q8_probe(g)
        return 0
    if args.zoo:
        zoo_probe(g)
        return 0
    if args.tp:
        tp_probe(g)
        return 0
    if args.prefill:
        prefill_probe(g)
        return 0
    if not args.decode:
        flash_probe(build_variants("flash_prefill", "flash_prefill_bf16",
                                   KNOBS), g)
    decode_probe(g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
