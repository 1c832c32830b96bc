#!/usr/bin/env python3
"""Tile-shape probe of the port's three attention kernels on one GPU:
`python3 tools/attention_probe.py [--paged | --decode] [--src DIR]`
(`--paged` runs only the decode_attention_paged rows, `--decode` only
the decode_attention rows; `--src` names the `src` directory whose
`repro_torch` is imported, so that a parent tree unpacked with git
archive can be timed in the same call).

flash_prefill: builds `csrc/flash_prefill.cu` once per setting of its
tensor-core route's knobs (kMT 16-row m-tiles per warp, kBK keys per
tile, kStages ring depth) into `build/attention_probe/`, holds each
build against `ref.flash_prefill` (bf16, 2e-2) and times it at the
h2o-danube-1.8b wave shape (q [B, 4608, 32, 80], k/v [B, 4608, 8, 80],
window 4096; B 1 and 2) and at the main path's prefill chunk, beside
SDPA on the same inputs. decode_attention: the built kernel at h2o's
ring (q [B, 32, 80], k/v [B, 4096, 8, 80], kv_len 4609) and at the qwen2.5
wave's decode (q [16, 14, 64], k/v [16, 280, 2, 64], kv_len 136) for
several split counts (an argument of the kernel), beside the wrapper
(the plan) and SDPA.
decode_attention_paged: the wrapper (the committed split plan) and the
kernel at forced split counts, each built with kTile 32, 64 (committed)
and 128 positions a ring stage (1, 2 and 4 pages of 32), held against
`ref.decode_attention_paged` (bf16, 2e-2) at chip_smoke's main-path
shape (q [4, 14, 64] over a 72-page pool, 18-entry tables, kv_len 150-240)
and at its long-cache shape (4 rows at kv_len 4,096 through 130-entry
tables), beside SDPA on the gathered K/V.

Times: CUDA events over back-to-back calls (`call_ms`, host launch
included) and torch.profiler's device time per call (`device_ms`, the
split and merge launches summed). Prints the card and one JSON line per
measurement; exits 2 without a GPU.
"""
import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "attention_probe"
build = ops = ref = None      # repro_torch.kernels of --src, set by main()
# knob settings of flash_prefill's tensor-core route; the first is the
# committed one
KNOBS = [dict(kMT=1, kBK=64, kStages=2), dict(kMT=2, kBK=64, kStages=2),
         dict(kMT=1, kBK=128, kStages=2), dict(kMT=1, kBK=32, kStages=2),
         dict(kMT=1, kBK=64, kStages=3)]
SPLITS = (1, 8, 17, 32)
# kTile settings of decode_attention_paged.cu; the first is the committed
PAGED_TILES = (64, 32, 128)


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


def stream():
    return torch.cuda.current_stream().cuda_stream


def flash_probe(variants, g):
    shapes = [("h2o wave B1", 1, 4608, 32, 4608, 8, 80, 4096, 0, 4608),
              ("h2o wave B2", 2, 4608, 32, 4608, 8, 80, 4096, 0, 4608),
              ("main-path chunk", 1, 32, 14, 352, 2, 64, 0, 64, 96)]
    for label, B, Sq, H, Sk, G, dh, win, q_off, kv in shapes:
        q = torch.randn(B, Sq, H, dh, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, Sk, G, dh, generator=g, device="cuda"
                            ).bfloat16() for _ in range(2))
        want = ref.flash_prefill(q, k, v, window=win or None,
                                 q_offset=q_off, kv_len=kv)
        qp = q_off + torch.arange(Sq, device="cuda")[:, None]
        kp = torch.arange(Sk, device="cuda")[None, :]
        mask = (kp <= qp) & (kp < kv)
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
                         H, G, dh, 1, win, q_off, kv, 1.0 / math.sqrt(dh),
                         out.data_ptr(), stream())
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


def decode_probe(g):
    fn = build.entry("decode_attention_bf16")
    shapes = [("h2o ring B1", 1, 32, 4096, 8, 80, 4609, True, SPLITS),
              ("h2o ring B2", 2, 32, 4096, 8, 80, 4609, True, SPLITS),
              ("qwen wave", 16, 14, 280, 2, 64, 136, False, (1, 2, 4))]
    for label, B, H, S, G, dh, kv, ring, splits_list in shapes:
        q = torch.randn(B, H, dh, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, S, G, dh, generator=g, device="cuda"
                            ).bfloat16() for _ in range(2))
        lens = torch.full((B,), kv, dtype=torch.int32, device="cuda")
        want = ref.decode_attention(q, k, v, lens, ring=ring)
        kk, vv = (t.repeat_interleave(H // G, 2).transpose(1, 2)
                  for t in (k, v))
        mask = (torch.arange(S, device="cuda") < kv)[None, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None], kk, vv, attn_mask=mask)
        wrap = lambda: ops.decode_attention(  # noqa: E731
            q, k, v, lens, ring=ring)
        print(json.dumps({"decode_attention": label,
                          "plan": ops.decode_split_plan(B, G, S),
                          "sdpa call_ms": call_ms(sdpa, 50),
                          "sdpa device_ms": device_ms(sdpa),
                          "wrapper call_ms": call_ms(wrap, 50),
                          "wrapper device_ms": device_ms(wrap)}))
        smem = ops.decode_smem_bytes(H // G, dh, 2)
        for splits in splits_list:
            out = torch.empty_like(q)
            part = torch.empty(B * G * splits * (H // G) * (dh + 2),
                               device="cuda")

            def call():
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         lens.data_ptr(), B, S, H, G, dh, 1.0 / math.sqrt(dh),
                         splits, smem, part.data_ptr(), out.data_ptr(),
                         stream())
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
            call()
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs()
            assert bool((err <= 2e-2 + 2e-2 * want.float().abs()).all()), \
                splits
            print(json.dumps({"decode_attention": label,
                              "splits": splits,
                              "max_abs_err": err.max().item(),
                              "call_ms": call_ms(call, 50),
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


def paged_probe(variants, g):
    shapes = [("main path", paged_inputs(g, 18, 72, [180, 210, 150, 240]),
               (1, 2, 4, 9, 18)),
              ("long cache", paged_inputs(g, 130, 520, [4096] * 4),
               (1, 9, 18, 33, 65, 130))]
    for label, (q, kp, vp, lens, table), splits_list in shapes:
        B, H, dh = q.shape
        P, ps, G, _ = kp.shape
        W = table.shape[1]
        want = ref.decode_attention_paged(q, kp, vp, lens, table)
        j = torch.arange(W * ps, device="cuda")
        idx = table.long()[:, j // ps] * ps + (j % ps)
        kk, vv = (t.reshape(P * ps, G, dh)[idx].repeat_interleave(H // G, 2)
                  .transpose(1, 2) for t in (kp, vp))
        mask = (j[None, :] < lens[:, None])[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None], kk, vv, attn_mask=mask)
        wrap = lambda: ops.decode_attention_paged(  # noqa: E731
            q, kp, vp, lens, table)
        print(json.dumps({"decode_attention_paged": label,
                          "plan": ops.decode_paged_split_plan(B, G, W, ps),
                          "sdpa call_ms": call_ms(sdpa, 50),
                          "sdpa device_ms": device_ms(sdpa),
                          "wrapper call_ms": call_ms(wrap, 50),
                          "wrapper device_ms": device_ms(wrap)}))
        for knobs, fn in variants:
            for splits in splits_list:
                out = torch.empty_like(q)
                part = torch.empty(B * G * splits * (H // G) * (dh + 2),
                                   device="cuda")

                def call():
                    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                             lens.data_ptr(), table.data_ptr(), B, H, G, dh,
                             ps, W, splits, part.data_ptr(), out.data_ptr(),
                             stream())
                    if err:
                        raise RuntimeError(f"launch failed: cudaError {err}")
                call()
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs()
                assert bool((err <= 2e-2 + 2e-2 * want.float().abs()).all()), \
                    (label, knobs, splits)
                print(json.dumps({"decode_attention_paged": label,
                                  "knobs": knobs, "splits": splits,
                                  "max_abs_err": err.max().item(),
                                  "call_ms": call_ms(call, 50),
                                  "device_ms": device_ms(call)}))


def main() -> int:
    global build, ops, ref
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--paged", action="store_true")
    only.add_argument("--decode", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build, ops, ref
    print(json.dumps({"src": args.src}))
    build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    if not (args.paged or args.decode):
        flash_probe(build_variants("flash_prefill", "flash_prefill_bf16",
                                   KNOBS), g)
    if not args.paged:
        decode_probe(g)
    if not args.decode:
        paged_probe(build_variants("decode_attention_paged",
                                   "decode_attention_paged_bf16",
                                   [dict(kTile=t) for t in PAGED_TILES]), g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
