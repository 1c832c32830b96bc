#!/usr/bin/env python3
"""TTFT probe of the port's continuous and wave engines on one GPU:
`python3 tools/serve_probe.py [--arch ARCH] [--kv-quant] [--wave]
[--src DIR] [--rounds N]`.

`--arch qwen25_0_5b` (the default): full-width qwen2.5-0.5B in bf16
(random weights from seed 0) on `ContinuousEngine` at the main path's
settings (`serving/slm.py`: 4 slots, 32-position pages, 32-token prefill
chunks, max_len 280), 16 prompts of random tokens with lengths drawn
from a seed in [97, 256] (the main path's prompts run 100-256 tokens).
`--arch h2o_danube_1_8b`: full-width h2o-danube-1.8b in bf16 (random
weights from seed 1) at chip_smoke's h2o continuous settings: 2 slots,
2 prompts of 4,608 random tokens, max_len 4,624, so each slot's
4,096-position ring of 32-position pages wraps, and each prompt is 144
chunks of 32. `--kv-quant` gives the model an int8 KV pool (the same
weights). max_new 16, greedy. One warm-up round, then `--rounds` rounds
of the same requests, each printing TTFT p50 and max (each request's
`prefill_s`), the round's wall seconds and the mean ms of one
`prefill_chunk_paged` call (synchronized, the model's whole chunk: every
layer). `--src` names the `src` directory whose `repro_torch` is
imported (default: this checkout's), so that two trees, such as a
parent commit unpacked with `git archive`, can be timed in turns on one
card. Prints the card (`nvidia-smi` name and power limit), then one JSON
line a round; exits 2 without a GPU.

`--wave` runs the wave engine instead (`Engine.generate(continuous=
False)`, chip_smoke's h2o and families paths): one wave of the arch's
prompts, whose prefill is one `flash_prefill` a layer; each round prints
the wave's prefill seconds (through the first token's logits) and its
flash_prefill launches by route. `--arch recurrentgemma_9b` (wave only):
full-width recurrentgemma-9b in bf16 (random weights from seed 3), 2
prompts of 512 random tokens, chip_smoke's families path.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# (weights' seed, slots, max_len, prompt lengths from rng(0)) by arch
SETTINGS = {
    "qwen25_0_5b": (0, 4, 280,
                    lambda rng: rng.integers(97, 257, 16)),
    "h2o_danube_1_8b": (1, 2, 4608 + 16, lambda rng: [4608, 4608]),
    "recurrentgemma_9b": (3, None, 512 + 16, lambda rng: [512, 512]),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--arch", default="qwen25_0_5b", choices=list(SETTINGS))
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--wave", action="store_true")
    args = ap.parse_args()
    if SETTINGS[args.arch][1] is None and not args.wave:
        ap.error(f"--arch {args.arch} runs on waves only (--wave)")
    if not torch.cuda.is_available():
        print("serve_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.dense import DenseLM
    from repro_torch.serving.engine import ContinuousEngine
    build.build_all()
    seed, slots, max_len, lengths = SETTINGS[args.arch]
    cfg = dataclasses.replace(get_config(args.arch), kv_quant=args.kv_quant)
    if args.wave:
        return wave_rounds(args, cfg, seed, max_len, lengths)
    lm = DenseLM(cfg, device="cuda", seed=seed)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(4, cfg.vocab_size, n).astype(np.int32)
               for n in lengths(rng)]
    chunk_s = []
    chunk = lm.prefill_chunk_paged

    def timed_chunk(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = chunk(*a, **k)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        return out
    lm.prefill_chunk_paged = timed_chunk
    eng = ContinuousEngine(lm, slots=slots, max_len=max_len, eos_id=-1,
                           prefill_chunk=32, page_size=32)
    for r in range(args.rounds + 1):
        chunk_s.clear()
        t0 = time.perf_counter()
        res = eng.generate(prompts, max_new=16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ttft = sorted(x.prefill_s for x in res)
        if r:
            print(json.dumps({
                "src": args.src, "arch": args.arch,
                "kv_quant": args.kv_quant, "round": r,
                "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
                "wall_s": wall, "chunks": len(chunk_s),
                "chunk_ms_mean": sum(chunk_s) / len(chunk_s) * 1e3,
                "tokens": sum(len(x.tokens) for x in res)}))
    return 0


def wave_rounds(args, cfg, seed, max_len, lengths):
    """`--wave`: one warm-up round, then `--rounds` rounds of one wave."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    lm = build_model(cfg, device="cuda", seed=seed)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(4, cfg.vocab_size, n).astype(np.int32)
               for n in lengths(rng)]
    eng = Engine(lm, max_len=max_len, eos_id=-1)
    routes = getattr(ops.flash_prefill, "routes", None)
    for r in range(args.rounds + 1):
        if routes is not None:
            for k in routes:
                routes[k] = 0
        t0 = time.perf_counter()
        res = eng.generate(prompts, max_new=16, continuous=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if r:
            print(json.dumps({
                "src": args.src, "arch": args.arch, "wave": True,
                "kv_quant": args.kv_quant, "round": r,
                "prefill_s": res[0].prefill_s, "wall_s": wall,
                "flash_prefill_routes": dict(routes or {}),
                "tokens": sum(len(x.tokens) for x in res)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
