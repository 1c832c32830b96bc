#!/usr/bin/env python3
"""Tile-shape probe of the port's two attention kernels on one GPU:
`python3 tools/attention_probe.py`.

flash_prefill: builds `csrc/flash_prefill.cu` once per setting of its
tensor-core route's knobs (kMT 16-row m-tiles per warp, kBK keys per
tile, kStages ring depth) into `build/attention_probe/`, holds each
build against `ref.flash_prefill` (bf16, 2e-2) and times it at the
h2o-danube-1.8b wave shape (q [B, 4608, 32, 80], k/v [B, 4608, 8, 80],
window 4096; B 1 and 2) and at the main path's prefill chunk, beside
SDPA on the same inputs. decode_attention: the built kernel at h2o's
ring (q [B, 32, 80], k/v [B, 4096, 8, 80], kv_len 4609) for several
split counts (an argument of the kernel), beside SDPA.

Times: CUDA events over back-to-back calls (`call_ms`, host launch
included) and torch.profiler's device time per call (`device_ms`, the
split and merge launches summed). Prints the card and one JSON line per
measurement; exits 2 without a GPU.
"""
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, ops, ref  # noqa: E402

OUT = ROOT / "build" / "attention_probe"
# knob settings of flash_prefill's tensor-core route; the first is the
# committed one
KNOBS = [dict(kMT=1, kBK=64, kStages=2), dict(kMT=2, kBK=64, kStages=2),
         dict(kMT=1, kBK=128, kStages=2), dict(kMT=1, kBK=32, kStages=2),
         dict(kMT=1, kBK=64, kStages=3)]
SPLITS = (1, 8, 17, 32)


def variant_source(src, knobs):
    for name, value in knobs.items():
        line = next(ln for ln in src.splitlines()
                    if ln.startswith(f"constexpr int {name} = "))
        src = src.replace(line, f"constexpr int {name} = {value};")
    return src


def build_variants():
    """Compile every knob setting in parallel; returns [(knobs, fn)]."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "flash_prefill.cu").read_text()
    procs = []
    for i, knobs in enumerate(KNOBS):
        cu, so = OUT / f"flash_prefill_{i}.cu", OUT / f"flash_prefill_{i}.so"
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
        print(json.dumps({"flash_prefill build": knobs, "registers": regs,
                          "spill lines": spills}))
        fn = ctypes.CDLL(str(so)).flash_prefill_bf16
        fn.argtypes = build.SIGNATURES["flash_prefill"]["flash_prefill_bf16"]
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
    for B in (1, 2):
        H, S, G, dh = 32, 4096, 8, 80
        q = torch.randn(B, H, dh, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(B, S, G, dh, generator=g, device="cuda"
                            ).bfloat16() for _ in range(2))
        lens = torch.full((B,), 4609, dtype=torch.int32, device="cuda")
        want = ref.decode_attention(q, k, v, lens, ring=True)
        kk, vv = (t.repeat_interleave(H // G, 2).transpose(1, 2)
                  for t in (k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None], kk, vv)
        print(json.dumps({"decode_attention": f"h2o ring B{B}",
                          "plan": ops.decode_split_plan(B, G, S),
                          "sdpa call_ms": call_ms(sdpa, 50),
                          "sdpa device_ms": device_ms(sdpa),
                          "wrapper call_ms": call_ms(
                              lambda: ops.decode_attention(q, k, v, lens,
                                                           ring=True), 50)}))
        smem = ops.decode_smem_bytes(H // G, dh, 2)
        for splits in SPLITS:
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
            print(json.dumps({"decode_attention": f"h2o ring B{B}",
                              "splits": splits,
                              "max_abs_err": err.max().item(),
                              "call_ms": call_ms(call, 50),
                              "device_ms": device_ms(call)}))


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    flash_probe(build_variants(), g)
    decode_probe(g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
