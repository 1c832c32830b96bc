"""Serving entry point: a RAG pipeline on the request-centric API (the
port of `repro.launch.serve`; the same flags and output lines, plus
`--device`).

  # batched: answer_batch(generate=True) through the RagSession
  python -m repro_torch.launch.serve --pipeline mobile --questions 16

  # streaming: Poisson arrivals into a live session, latency a request
  python -m repro_torch.launch.serve --stream --arrival-qps 4

  # multi-replica: SlotScheduler over N continuous engines
  python -m repro_torch.launch.serve --replicas 2

  # serving under fire: deadlines a request + deterministic chaos
  python -m repro_torch.launch.serve --replicas 3 --chaos --deadline-s 30

  # on the CPU (plain versions of the kernels, the reduced generator)
  python -m repro_torch.launch.serve --device cpu --questions 4

Wires: synthetic corpus -> HashEmbedder -> the pipeline's index (and, for
MobileRAG, SCR) -> RagSession (continuous-batching decode on the paged
engine; retrieval and SCR of the next queries overlap decode of the
previous ones). The generator is qwen2.5-0.5B with random weights from
`--seed`: at full width on the card, reduced (the reference's
`ReducedSLM` config) on the CPU. `--deadline-s` bounds the latency of a
request (expired requests are shed, their slots freed); `--max-pending`
bounds the session's admission (overload degrades, then sheds);
`--chaos` wraps each replica in a seeded FaultPlan and reports goodput
= completed within the deadline / submitted.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_qa_corpus
from repro_torch.serving.embedder import HashEmbedder
from repro_torch.serving.faults import FaultPlan, wrap_replicas
from repro_torch.serving.rag import PIPELINES, accuracy
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.trace import TraceSink


def _percentiles(xs):
    if not xs:
        return 0.0, 0.0
    return (float(np.percentile(xs, 50)), float(np.percentile(xs, 95)))


def run_batch(pipe, corpus, args) -> None:
    questions = [e.question for e in corpus.examples[: args.questions]]
    t0 = time.perf_counter()
    answers = pipe.answer_batch(questions, generate=True,
                                max_new=args.max_new)
    wall = time.perf_counter() - t0
    acc = accuracy(pipe, corpus.examples, max_q=args.questions)
    toks = [a.prompt_tokens for a in answers]
    print(f"[serve] {len(answers)} answers in {wall:.2f}s | "
          f"answer-in-context acc={acc:.2f} | "
          f"prompt tokens mean={np.mean(toks):.0f} | "
          f"measured TTFT={np.mean([a.ttft_measured_s for a in answers]):.3f}s | "
          f"model TTFT={np.mean([a.ttft_model_s for a in answers]):.2f}s | "
          f"model energy={np.mean([a.energy_model_j for a in answers]):.2f}J")
    for a in answers[:3]:
        print(f"  docs={a.doc_ids} gen={a.gen_tokens[:8]}")


def run_stream(pipe, corpus, args) -> None:
    """Poisson arrivals into a live RagSession: queries reach the session
    at their arrival times while it keeps stepping, so retrieval and SCR
    of late arrivals overlap decode of early ones."""
    rng = np.random.default_rng(args.seed)
    n = args.questions
    arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_qps, size=n))
    sink = TraceSink() if args.trace_export else None
    sess = pipe.session(max_new=args.max_new, slots=args.slots,
                        greedy=not args.sample, seed=args.seed,
                        max_pending=args.max_pending,
                        deadline_s=args.deadline_s,
                        trace=sink, slo_s=args.slo_s)
    t0 = time.perf_counter()
    submitted = 0
    latencies = []
    trace = []
    while submitted < n or sess.pending:
        now = time.perf_counter() - t0
        while submitted < n and arrivals[submitted] <= now:
            rid = sess.submit(corpus.examples[submitted].question)
            trace.append((now, rid, "submitted"))
            submitted += 1
        if not sess.pending:
            time.sleep(min(arrivals[submitted] - now, 0.05))
            continue
        for ev in sess.step():
            if ev.kind in ("retrieved", "done", "shed", "failed"):
                trace.append((time.perf_counter() - t0, ev.req_id, ev.kind))
            if ev.kind == "done":
                latencies.append(sess.requests[ev.req_id].latency_s)
    wall = time.perf_counter() - t0
    p50, p95 = _percentiles(latencies)
    eng = sess.engine
    c = sess.counters
    print(f"[serve --stream] {n} requests at ~{args.arrival_qps:.1f} qps "
          f"in {wall:.2f}s | latency p50={p50:.3f}s p95={p95:.3f}s | "
          f"slot util={eng.utilisation():.2f} "
          f"({eng.steps} decode steps x {eng.slots} slots) | "
          f"prefix hits={eng.prefix_hits} "
          f"tokens reused={eng.prefix_tokens_reused} | "
          f"done={c.completed} "
          f"shed={c.shed_deadline + c.shed_overload + c.shed_oversize} "
          f"degraded={c.degraded} failed={c.failed}")
    if args.slo_s is not None:
        print(f"[serve --slo-s {args.slo_s}] "
              f"slo_shed={c.shed_slo} slo_degraded={c.degraded_slo}")
    if sess.trace is not None and args.trace_export:
        m = sess.trace.export_jsonl(args.trace_export)
        print(f"[serve --trace-export] {m} records -> "
              f"{args.trace_export} (check: python tools/trace_check.py "
              f"{args.trace_export})")
    for t, rid, kind in trace[: 3 * 3]:
        print(f"  t={t:6.3f}s req={rid} {kind}")


def run_replicas(pipe, corpus, args) -> None:
    """SlotScheduler over N continuous-engine replicas (slot admission,
    stall hedging a slot, failover). With `--chaos` each replica is
    wrapped in its seeded FaultPlan sub-schedule and the line reports
    goodput (completed within the deadline / submitted)."""
    slm = pipe.slm
    engines = [slm.continuous(args.slots)]
    for _ in range(1, args.replicas):
        engines.append(engines[0].clone())
    sink = None
    if args.trace_export:
        sink = TraceSink()
        for e in engines:
            e.trace = sink
    if args.chaos:
        engines = wrap_replicas(engines, FaultPlan.quick(args.seed))
    sched = SlotScheduler(engines, max_queue=args.max_queue,
                          deadline_s=args.deadline_s,
                          stall_s=2.0 if args.chaos else 30.0,
                          probe_cooldown_s=0.25, trace=sink)
    questions = [e.question for e in corpus.examples[: args.questions]]
    answers = pipe.answer_batch(questions)          # retrieval + SCR
    t0 = time.perf_counter()
    for a in answers:
        sched.submit(slm.encode_prompt(a.prompt, bucket=False),
                     args.max_new)
    completions = sched.run()
    wall = time.perf_counter() - t0
    p50, p95 = _percentiles([c.latency_s for c in completions])
    cnt = sched.counters
    deadline = args.deadline_s or float("inf")
    good = sum(1 for c in completions if c.latency_s <= deadline)
    print(f"[serve --replicas {args.replicas}] {len(completions)} "
          f"completions in {wall:.2f}s | p50={p50:.3f}s p95={p95:.3f}s | "
          f"goodput={good}/{cnt.submitted} | shed={len(sched.shed)} "
          f"degraded={cnt.degraded} hedges={cnt.hedges} "
          f"drains={cnt.drains} recoveries={cnt.recoveries} | "
          f"served per replica={[s.served for s in sched.state]}")
    for c in completions[:3]:
        print(f"  rid={c.rid} replica={c.replica} hedged={c.hedged} "
              f"tokens={c.tokens[:8]}")
    if sink is not None:
        m = sink.export_jsonl(args.trace_export)
        print(f"[serve --trace-export] {m} records -> "
              f"{args.trace_export} (check: python tools/trace_check.py "
              f"{args.trace_export})")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipeline", default="mobile",
                    choices=list(PIPELINES.keys()))
    ap.add_argument("--questions", type=int, default=8)
    ap.add_argument("--docs", type=int, default=150)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--stream", action="store_true",
                    help="Poisson arrival process into a live RagSession")
    ap.add_argument("--sample", action="store_true",
                    help="sampled decode (a PRNG stream a request; draws "
                         "are independent of co-residents) instead of "
                         "greedy — --stream path")
    ap.add_argument("--arrival-qps", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="deadline of a request; expired requests are "
                         "shed with their engine slot freed")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="session admission bound (--stream): overload "
                         "degrades past half, sheds at the bound")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="scheduler queue bound (--replicas): "
                         "degrade-then-shed overflow policy")
    ap.add_argument("--chaos", action="store_true",
                    help="wrap each replica in a seeded FaultPlan "
                         "(crashes/stalls/slow steps) — --replicas path")
    ap.add_argument("--slo-s", type=float, default=None,
                    help="latency SLO of a request (--stream): the "
                         "session degrades retrieve_chunk/n_probe/"
                         "max_new from observed p95 stage costs before "
                         "it sheds")
    ap.add_argument("--trace-export", default=None, metavar="PATH",
                    help="record the run into a TraceSink and export "
                         "JSONL for tools/trace_check.py "
                         "(--stream / --replicas paths)")
    ap.add_argument("--page-size", type=int, default=32,
                    help="KV pool page granularity (positions a page); "
                         "smaller pages share longer prompt prefixes, "
                         "larger ones cut table/gather overhead")
    ap.add_argument("--device-budget", type=float, default=None,
                    help="device-memory budget of the retrieval index: "
                         "bytes, or a fraction in (0, 1] of the "
                         "all-resident pack. Builds a tiered hot/cold "
                         "EcoVector and forces device retrieval so the "
                         "tiers are exercised")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, full-width generator) or "
                         "cpu (plain versions, the reduced generator)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    gen_config = get_config("qwen25_0_5b")
    if dev.type != "cuda":
        gen_config = gen_config.reduced()
    corpus = make_qa_corpus(n_docs=args.docs, n_questions=args.questions,
                            seed=args.seed)
    emb = HashEmbedder(dim=128)
    pipe_kw = {}
    if args.device_budget is not None:
        pipe_kw = {"device_budget_bytes": args.device_budget,
                   "device_retrieval": True}
    pipe = PIPELINES[args.pipeline](corpus.docs, emb, top_k=3,
                                    gen_config=gen_config, seed=args.seed,
                                    device=dev, **pipe_kw)
    # the generator is built on first use, so its page size can still be
    # set here
    pipe.page_size = args.page_size
    print(f"[serve] pipeline={pipe.name} docs={len(corpus.docs)} "
          f"index_build={pipe.build_s:.2f}s")

    if args.stream:
        run_stream(pipe, corpus, args)
    elif args.replicas > 1:
        run_replicas(pipe, corpus, args)
    else:
        run_batch(pipe, corpus, args)

    if args.device_budget is not None:
        idx, s = pipe.index, pipe.index.stats
        hits = s.tier_hot_hits + s.tier_cold_hits
        print(f"[serve --device-budget] hot={len(idx.hot_clusters())} "
              f"cold={len(idx.cold_clusters())} clusters | "
              f"resident={idx.device_resident_bytes()}B "
              f"budget={idx.device_budget_bytes}B "
              f"(all-resident {idx.all_resident_bytes()}B) | "
              f"hot-hit-rate={s.tier_hot_hits / max(hits, 1):.2f} | "
              f"promotions={s.promotions} demotions={s.demotions}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
