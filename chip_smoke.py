#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: `python3 chip_smoke.py`.

Phases, any failure exits non-zero (nothing is caught):

1. Print the card (`nvidia-smi` name and power limit) and build the CUDA
   kernels from `src/repro_torch/kernels/csrc/` (timed).
2. The main path: MobileRAG over a 16,384-document synthetic SQuAD-style
   corpus (HashEmbedder at the gte-small width 384: NC = 256 clusters,
   a [256, CAP, 384] EcoVector pack and a [16384, 10, 384] window pack)
   with full-width qwen2.5-0.5B in bf16 (24 layers, random weights from a
   seed), `answer_batch(16 questions, generate=True, max_new=16)` through
   4 slots. Every kernel launch counter is zeroed just before the
   pipeline is built and read just after the answers return; each kernel
   must have launched. The port has no retrieval or SCR fallback: a
   fault raises, so zero fallbacks is the run reaching its end.
3. Each kernel against its plain PyTorch version on the main path's own
   inputs and shapes, plus one edge case each, with kernel, plain and
   library-call times (CUDA events) and the bound of the work:
   ids exact except at ties within the value tolerance, ecoscan and
   scr_select values 2e-5, kmeans_assign 1e-4 (relative), decode
   attention 1e-5 in f32 and 2e-2 in bf16. TF32 is off for every
   float32 matmul and convolution (the plain versions run in full f32).
4. The same pipeline on a small corpus with the float32 reduced model,
   on the GPU (kernels) and on the CPU (plain versions): the same doc
   ids, prompts and greedy tokens.
5. A torch.profiler window over steady decode steps (device busy and
   idle share, the kernels that take the device time) and over each
   kernel wrapper alone (device time per call).

The line before the last is the kernel summary as JSON; the last line is
`{"ok": true, "device": {...}}`.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import make_qa_corpus  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.serving.embedder import HashEmbedder  # noqa: E402
from repro_torch.serving.rag import MobileRAG  # noqa: E402
from repro_torch.serving.trace import TraceSink  # noqa: E402

HBM_BYTES_S = 3.35e12          # H100 SXM HBM3
F32_FLOPS_S = 67e12            # f32 outside the tensor cores
BF16_FLOPS_S = 989e12          # bf16 tensor cores, dense
# device and scale of the main path
DEV = "cuda"
N_DOCS = 16384
GEN_CONFIG = get_config("qwen25_0_5b")
REPLACES = {
    "kmeans_assign": "src/repro/kernels/kmeans_assign.py:37",
    "ecoscan": "src/repro/kernels/ecoscan.py:163",
    "scr_select": "src/repro/kernels/scr_select.py:115",
    "decode_attention_paged": "src/repro/kernels/decode_attention.py:135",
}


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call (CUDA events around `iters` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def close(name, got, want, rtol, atol):
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    if not bool((err <= lim).all()):
        raise AssertionError(f"{name}: max error {err.max().item():.3g} "
                             f"beyond rtol {rtol} / atol {atol}")
    return err.max().item()


def same_or_tied(name, got_ids, want_ids, value_of, rtol, atol):
    """Ids equal, except where the two picks' plain values tie within the
    value tolerance (float sum order decides such ties)."""
    diff = got_ids != want_ids
    if diff.any():
        vg, vw = value_of(got_ids)[diff], value_of(want_ids)[diff]
        if not bool(((vg - vw).abs() <= atol + rtol * vw.abs()).all()):
            raise AssertionError(f"{name}: {int(diff.sum())} ids differ "
                                 "beyond a tie")
    return int(diff.sum())


# ------------------------------------------------------------- kernels


def check_kmeans(x, cent):
    N, d = x.shape
    NC = cent.shape[0]
    a, dist = ops.kmeans_assign(x, cent)
    pa, pdist = ref.kmeans_assign(x, cent)
    d2 = ((x * x).sum(1)[:, None] - 2.0 * x @ cent.T
          + (cent * cent).sum(1)[None, :])
    ties = same_or_tied("kmeans_assign", a, pa,
                        lambda ids: d2.gather(1, ids.long()[:, None])[:, 0],
                        1e-4, 1e-4)
    err = close("kmeans_assign", dist, pdist, 1e-4, 1e-4)
    # edge: ragged row count, few centroids, exact ties (duplicate rows)
    g = torch.Generator(device=DEV).manual_seed(1)
    xe = torch.randn(100, 16, generator=g, device=DEV)
    ce = torch.cat([xe[:4], xe[:1]])                # centroid 4 == centroid 0
    ae, de = ops.kmeans_assign(xe, ce)
    pe, pde = ref.kmeans_assign(xe, ce)
    d2e = ((xe * xe).sum(1)[:, None] - 2.0 * xe @ ce.T
           + (ce * ce).sum(1)[None, :])
    same_or_tied("kmeans_assign edge", ae, pe,
                 lambda ids: d2e.gather(1, ids.long()[:, None])[:, 0],
                 1e-4, 1e-4)
    assert int(ae[0]) == 0, "kmeans_assign: tie must go to the lower id"
    close("kmeans_assign edge", de, pde, 1e-4, 1e-4)
    b_ms, b_by = bound((N * d + NC * d) * 4 + N * 8,
                       2.0 * N * NC * d + 2.0 * (N + NC) * d, F32_FLOPS_S)
    return dict(
        err=err, ties=ties,
        ms=time_ms(lambda: ops.kmeans_assign(x, cent)),
        plain_ms=time_ms(lambda: ref.kmeans_assign(x, cent)),
        library_ms=time_ms(lambda: torch.cdist(x, cent).argmin(1)),
        bound_ms=b_ms, bound_by=b_by)


def _slot_dist(q, data):
    """slots [B, k] -> the plain distance of each slot's row to its query
    (NEG for -1)."""
    flat = data.reshape(-1, data.shape[-1])

    def value_of(slots):
        rows = flat[slots.long().clamp(min=0)]             # [B, k, d]
        v = ((rows * rows).sum(-1) - 2.0 * (rows * q[:, None]).sum(-1)
             + (q * q).sum(-1)[:, None])
        return torch.where(slots >= 0, v, torch.full_like(v, ref.NEG))
    return value_of


def check_ecoscan(q, data, lens, probes, k):
    B, d = q.shape
    dist, ids = ops.ecoscan(q, data, lens, probes, k)
    pdist, pids = ref.ecoscan(q, data, lens, probes, k)
    ties = same_or_tied("ecoscan", ids, pids, _slot_dist(q, data), 2e-5,
                        2e-5)
    err = close("ecoscan", dist, pdist, 2e-5, 2e-5)
    # edge: duplicate probe, padded probe, masked cluster, k > candidates
    g = torch.Generator(device=DEV).manual_seed(2)
    de = torch.randn(6, 16, 32, generator=g, device=DEV)
    le = torch.tensor([16, 0, 3, 16, 5, 9], dtype=torch.int32, device=DEV)
    pe = torch.tensor([[1, 1, -1, 2], [5, 3, 4, 0]], dtype=torch.int32,
                      device=DEV)
    bm = torch.tensor([0, 2, 5, -1, 4, 1], dtype=torch.int32, device=DEV)
    qe = torch.randn(2, 32, generator=g, device=DEV)
    for kk in (3, 40):
        a = ops.ecoscan(qe, de, le, pe, kk, block_map=bm)
        p = ref.ecoscan(qe, de, le, pe, kk, block_map=bm)
        same_or_tied("ecoscan edge", a[1], p[1], _slot_dist(qe, de), 2e-5,
                     2e-5)
        close("ecoscan edge", a[0], p[0], 2e-5, 2e-5)
    blk = torch.unique(probes[probes >= 0].long())
    rows = int(lens[blk].sum())
    cand = int(lens[probes.clamp(min=0).long()][probes >= 0].sum())
    b_ms, b_by = bound(rows * d * 4 + B * d * 4 + probes.numel() * 4
                       + B * k * 8, 2.0 * d * (cand + rows), F32_FLOPS_S)

    def library():
        g_ = data[probes.long()].reshape(B, -1, d)
        return torch.topk(torch.cdist(q[:, None], g_)[:, 0], k,
                          largest=False)
    return dict(
        err=err, ties=ties,
        ms=time_ms(lambda: ops.ecoscan(q, data, lens, probes, k)),
        plain_ms=time_ms(lambda: ref.ecoscan(q, data, lens, probes, k)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def _win_score(q, data, ids):
    """wins [B, K] -> the plain score of each picked window (-NEG for
    -1)."""
    def value_of(wins):
        rows = data[ids.clamp(min=0).long(), wins.clamp(min=0).long()]
        v = (rows * q[:, None]).sum(-1)
        return torch.where(wins >= 0, v, torch.full_like(v, -ref.NEG))
    return value_of


def check_scr_select(q, data, lens, ids):
    B, d = q.shape
    ND, CAPW, _ = data.shape
    K = ids.shape[1]
    s, w = ops.scr_select(q, data, lens, ids)
    ps_, pw = ref.scr_select(q, data, lens, ids)

    ties = same_or_tied("scr_select", w, pw, _win_score(q, data, ids),
                        2e-5, 2e-5)
    err = close("scr_select", s, ps_, 2e-5, 2e-5)
    # edge: padded slots, a windowless doc, an exact first-max tie
    de = data[:4].clone()
    de[2, 1] = de[2, 0]
    le = torch.tensor([3, 0, 8, 1], dtype=torch.int32, device=DEV)
    ie = torch.tensor([[0, 1, -1], [2, 3, 1]], dtype=torch.int32,
                      device=DEV)
    qe = (de[2, 0] / de[2, 0].norm()).expand(2, d).contiguous()
    a, p = ops.scr_select(qe, de, le, ie), ref.scr_select(qe, de, le, ie)
    same_or_tied("scr_select edge", a[1], p[1], _win_score(qe, de, ie),
                 2e-5, 2e-5)
    assert int(a[1][1, 0]) == 0, "scr_select: tie must go to the first max"
    close("scr_select edge", a[0], p[0], 2e-5, 2e-5)
    valid = ids >= 0
    n_win = int(lens[ids.clamp(min=0).long()][valid].sum())
    uniq = torch.unique(ids[valid].long())
    b_ms, b_by = bound(int(lens[uniq].sum()) * d * 4 + B * d * 4
                       + ids.numel() * 4 + B * K * 8, 2.0 * d * n_win,
                       F32_FLOPS_S)

    def library():
        g_ = data[ids.clamp(min=0).long()].reshape(B, K * CAPW, d)
        return torch.bmm(g_, q[:, :, None]).reshape(B, K, CAPW).max(-1)
    return dict(
        err=err, ties=ties,
        ms=time_ms(lambda: ops.scr_select(q, data, lens, ids)),
        plain_ms=time_ms(lambda: ref.scr_select(q, data, lens, ids)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


def check_decode(q, kp, vp, kv_len, table):
    B, H, dh = q.shape
    P, ps, G, _ = kp.shape
    W = table.shape[1]
    out = ops.decode_attention_paged(q, kp, vp, kv_len, table)
    pout = ref.decode_attention_paged(q, kp, vp, kv_len, table)
    err = close("decode_attention_paged bf16", out, pout, 2e-2, 2e-2)
    a32 = [t.float() for t in (q, kp, vp)]
    close("decode_attention_paged f32",
          ops.decode_attention_paged(*a32, kv_len, table),
          ref.decode_attention_paged(*a32, kv_len, table), 1e-5, 1e-5)
    # edge: reduced grouping (Hg = 2), kv_len 0 / 1 / page end / full
    g = torch.Generator(device=DEV).manual_seed(3)
    qe = torch.randn(4, 4, 32, generator=g, device=DEV)
    ke = torch.randn(8, 16, 2, 32, generator=g, device=DEV)
    ve = torch.randn(8, 16, 2, 32, generator=g, device=DEV)
    le = torch.tensor([0, 1, 16, 64], dtype=torch.int32, device=DEV)
    te = torch.tensor([[3, 1, 0, 0], [2, 5, 7, 1], [4, 4, 6, 0],
                       [7, 6, 5, 4]], dtype=torch.int32, device=DEV)
    close("decode_attention_paged edge",
          ops.decode_attention_paged(qe, ke, ve, le, te),
          ref.decode_attention_paged(qe, ke, ve, le, te), 1e-5, 1e-5)
    kv = int(kv_len.clamp(min=0).sum())
    esz = q.element_size()
    b_ms, b_by = bound(2 * kv * G * dh * esz + 2 * B * H * dh * esz
                       + B * (W + 1) * 4, 4.0 * kv * H * dh, BF16_FLOPS_S)
    j = torch.arange(W * ps, device=DEV)
    mask = (j[None, :] < kv_len[:, None])[:, None, None, :]

    def library():
        idx = table.long()[:, j // ps] * ps + (j % ps)
        kk = kp.reshape(P * ps, G, dh)[idx].repeat_interleave(H // G, 2)
        vv = vp.reshape(P * ps, G, dh)[idx].repeat_interleave(H // G, 2)
        return F.scaled_dot_product_attention(
            q[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2),
            attn_mask=mask)
    return dict(
        err=err, ties=0,
        ms=time_ms(lambda: ops.decode_attention_paged(q, kp, vp, kv_len,
                                                      table), iters=50),
        plain_ms=time_ms(lambda: ref.decode_attention_paged(
            q, kp, vp, kv_len, table)),
        library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by)


# ------------------------------------------------------------- profile


def _device_events(prof):
    """(name, device µs) of every kernel the profiler saw on the GPU."""
    out = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.key, e.self_device_time_total, e.count))
    return out


def profile_phase(slm, prompts, kernel_calls):
    """torch.profiler over steady decode steps of the main path's engine
    (4 slots decoding) and over each kernel wrapper alone: device busy
    share of a step, the kernels that take its device time, and each
    port kernel's device time per call (without the host launch cost
    that the CUDA-event loop of phase 3 includes)."""
    from torch.profiler import ProfilerActivity, profile
    eng = slm.engine
    for p in prompts:
        eng.submit(p, 40)
    started = set()
    while len(started) < len(prompts) and eng.pending:
        started |= {ev.rid for ev in eng.step() if ev.kind == "token"}
    torch.cuda.synchronize()
    n = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    while eng.pending:
        eng.step()
    dev = _device_events(prof)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    busy = sum(t for _, t, _ in dev) / n / 1e3             # ms per step
    top = sorted(dev, key=lambda e: -e[1])[:6]
    per_kernel = {}
    for name, call in kernel_calls.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as kp:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        t = sum(t for _, t, _ in _device_events(kp))
        per_kernel[name] = t / 20 / 1e3 if t else None
    return {
        "decode_step_wall_ms": wall * 1e3,
        "decode_step_device_ms": busy if busy else None,
        "device_idle_share": (1 - busy / (wall * 1e3)) if busy else None,
        "top_device_kernels": [
            {"name": k[:60], "ms_per_step": t / n / 1e3, "calls": c}
            for k, t, c in top],
        "top_host_ops": [
            {"name": e.key[:60], "ms_per_step": e.self_cpu_time_total / n / 1e3,
             "calls": e.count} for e in host[:8]],
        "kernel_device_ms": per_kernel,
    }


# ------------------------------------------------------------- phases


def word_corpus(n_docs, seed):
    """Random-word documents: no two SCR windows share a bag of words,
    so the small-input comparison has no ties decided by rounding."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    return [" ".join(" ".join(rng.choice(vocab, 7)).capitalize() + "."
                     for _ in range(12)) for _ in range(n_docs)]


def small_input_agreement():
    """The pipeline on the GPU against its plain versions on the CPU:
    float32 reduced model, same random weights, same corpus."""
    docs = word_corpus(200, seed=11)
    queries = [docs[i].split(". ")[2 + i % 5] for i in range(3, 200, 33)]
    cfg = get_config("qwen25_0_5b").reduced(dtype="float32")
    gpu = MobileRAG(docs, HashEmbedder(dim=64), top_k=3, gen_config=cfg,
                    seed=5, device=DEV)
    on_gpu = gpu.answer_batch(queries, generate=True, max_new=8)
    weights = {n: p.detach().cpu() for n, p in
               gpu.slm.model.named_parameters()}
    cpu = MobileRAG(docs, HashEmbedder(dim=64), top_k=3, gen_config=cfg,
                    gen_params=weights, device="cpu")
    on_cpu = cpu.answer_batch(queries, generate=True, max_new=8)
    for a, b in zip(on_gpu, on_cpu):
        assert a.doc_ids == b.doc_ids, (a.doc_ids, b.doc_ids)
        assert a.prompt == b.prompt
        assert a.gen_tokens == b.gen_tokens, (a.gen_tokens, b.gen_tokens)
    return len(queries)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    build_s = build.build_all()
    print(f"kernel build: {build_s:.2f} s nvcc "
          f"({time.perf_counter() - t0:.2f} s with loading)")

    # ---- main path
    corpus = make_qa_corpus(n_docs=N_DOCS, n_questions=16,
                            sentences_per_doc=12, seed=0)
    questions = [e.question for e in corpus.examples]
    embed = HashEmbedder(dim=384)
    sink = TraceSink()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pipe = MobileRAG(corpus.docs, embed, top_k=3, gen_config=GEN_CONFIG,
                     seed=0, trace=sink, device=DEV)
    slm = pipe.slm
    torch.cuda.synchronize()
    build_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    answers = pipe.answer_batch(questions, generate=True, max_new=16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    missing = [n for n, c in launches.items() if c == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    vocab = slm.cfg.vocab_padded
    for a in answers:
        assert a is not None, "a request did not complete"
        assert 1 <= len(a.gen_tokens) <= 16
        assert all(0 <= t < vocab for t in a.gen_tokens)
        assert len(a.doc_ids) == 3 and a.prompt.startswith("Context:")
    data, lens, _, cap = pipe.index.device_pack()
    wdata, wlens = pipe.window_index.pack()
    steps = sink.durations("engine", "decode_step")
    active = [r.attrs["active"] for r in sink.query(comp="engine",
                                                    name="decode_step")
              if r.ph == "B"]
    ttft = sorted(a.ttft_measured_s for a in answers)
    main = {
        "docs": len(corpus.docs), "questions": len(questions),
        "clusters": int(data.shape[0]), "cap": int(cap),
        "ecovector_pack_mb": data.nbytes / 2**20,
        "window_pack": list(wdata.shape), "window_pack_mb": wdata.nbytes / 2**20,
        "build_s": build_wall, "index_build_s": pipe.build_s,
        "window_build_s": pipe.scr_build_s, "answer_wall_s": wall,
        "ttft_p50_s": ttft[len(ttft) // 2],
        "decode_tok_s": sum(active) / sum(steps),
        "decode_steps": len(steps),
        "tokens": sum(len(a.gen_tokens) for a in answers),
        "prefix_hits": slm.engine.prefix_hits,
    }
    print("main path:", json.dumps(main))
    print("launches on the main path:", json.dumps(launches))

    # ---- kernels against their plain versions, on the main path's inputs
    dev = DEV
    x = torch.tensor(embed(corpus.docs), device=dev)
    cent = torch.tensor(pipe.index.centroids, device=dev)
    qv = torch.tensor(embed(questions[:4]), device=dev)
    d_t, l_t, c_t = pipe.index.device_arrays()
    probes = ref.route_topk(qv, c_t, pipe.n_probe)
    w_t, wl_t = pipe.window_index.device_arrays()
    ids = torch.tensor([a.doc_ids for a in answers[:4]], dtype=torch.int32,
                       device=dev)
    pool = slm.engine.cache
    ps = slm.engine.page_size
    P, W = pool["k"].shape[1], slm.engine.table_width
    g = torch.Generator(device=dev).manual_seed(4)
    q_dec = (torch.randn(4, slm.cfg.num_heads, slm.cfg.resolved_head_dim,
                         generator=g, device=dev)).to(torch.bfloat16)
    table = torch.stack([torch.randperm(P, generator=g, device=dev)[:W]
                         for _ in range(4)]).to(torch.int32)
    plens = [len(slm.encode_prompt(a.prompt)) + len(a.gen_tokens)
             for a in answers[:4]]
    kv_len = torch.tensor(plens, dtype=torch.int32, device=dev)
    results = {
        "kmeans_assign": check_kmeans(x, cent),
        "ecoscan": check_ecoscan(qv, d_t, l_t, probes, pipe.top_k),
        "scr_select": check_scr_select(qv, w_t, wl_t, ids),
        "decode_attention_paged": check_decode(
            q_dec, pool["k"][0], pool["v"][0], kv_len, table),
    }
    calls = {
        "kmeans_assign": lambda: ops.kmeans_assign(x, cent),
        "ecoscan": lambda: ops.ecoscan(qv, d_t, l_t, probes, pipe.top_k),
        "scr_select": lambda: ops.scr_select(qv, w_t, wl_t, ids),
        "decode_attention_paged": lambda: ops.decode_attention_paged(
            q_dec, pool["k"][0], pool["v"][0], kv_len, table),
    }
    prof = profile_phase(slm, [slm.encode_prompt(a.prompt)
                               for a in answers[:4]], calls)
    print("profile:", json.dumps(prof))
    n_small = small_input_agreement()
    print(f"small input: {n_small} queries agree GPU vs CPU "
          "(doc ids, prompts, greedy tokens)")
    for name, r in results.items():
        print(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err "
              f"{r['err']:.3g}, ties {r['ties']}")
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"]} for name, r in results.items()]
    assert all(math.isfinite(k["ms"]) for k in kernels)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
