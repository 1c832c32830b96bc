"""Serving under fire on the CPU, the port against the JAX package: the
fault plans (`FaultPlan` schedules, equal for seeds 0-5), the
`RagSession` ladders (the chaos pipeline of tests/test_faults.py, the
admission bound, a poisoned query, a 0 s deadline, SLO shedding and the
forced degrade that lowers `n_probe` through the `.inner` chain and
restores it) and `MobileRAG`'s two fallbacks (retrieval, warm and cold;
SCR, batched and legacy). The same terminal partition, events, counters,
doc ids, prompts and greedy tokens on float32 reduced qwen2.5-0.5B with
weights carried across by `params_from_reference`, over the reference's
QA corpora (60 and 50 documents).

Those corpora repeat filler sentences, so a few SCR windows score one
ulp apart and each package's f32 sum order picks one (`ROADMAP.md`, F5).
Where two answers' prompts differ, the test asserts that a tie explains
it: the same documents, best-window scores within 2e-5, and an order
that differs only between documents whose scores tie. Tokens are then
compared only where the prompts are equal.

The port's one deliberate difference is held too: a `KernelError` raised
by a kernel wrapper propagates out of `answer_batch` and
`RagSession.step` and moves no counter. Session traces pass
`tools/trace_check.py`."""
import dataclasses
import importlib.util
import pathlib
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.synthetic import make_qa_corpus as j_make_qa_corpus
from repro.data.tokenizer import HashTokenizer as JHashTokenizer
from repro.models import model as jmodel
from repro.serving.embedder import HashEmbedder as JHashEmbedder
from repro.serving.engine import Engine as JEngine
from repro.serving.faults import ChaosPipeline as JChaosPipeline
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.rag import MobileRAG as JMobileRAG
from repro.serving.session import RagSession as JRagSession
from repro.serving.slm import ReducedSLM
from repro.serving.trace import SLOPlan as JSLOPlan
from repro.serving.trace import TraceSink as JTraceSink
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.data.synthetic import make_qa_corpus
from repro_torch.kernels import build, ops
from repro_torch.serving.embedder import HashEmbedder
from repro_torch.serving.faults import ChaosPipeline, FaultPlan, InjectedFault
from repro_torch.serving.rag import MobileRAG
from repro_torch.serving.session import RagSession
from repro_torch.serving.slm import SLM
from repro_torch.serving.trace import SLOPlan, TraceSink

_TC = pathlib.Path(__file__).resolve().parent.parent / "tools" \
    / "trace_check.py"
_spec = importlib.util.spec_from_file_location("trace_check", _TC)
trace_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_check)

RATES = {"replica_crash": 0.1, "slot_stall": 0.1, "slow_step": 0.1,
         "retrieval_error": 0.1}
SCORE_TOL = 2e-5


# ------------------------------------------------------------ FaultPlan


@pytest.mark.parametrize("seed", range(6))
def test_fault_plan_schedules_match_reference(seed):
    """Every replica's schedule (crashes, stall starts, slow steps) and
    the pipeline's retrieval errors are the reference's, and a replayed
    plan fires the same faults at the same steps."""
    for rates, horizon, stall, slow in ((RATES, 300, 40, 0.01),
                                        ({"replica_crash": 0.3}, 50, 3, 0.0),
                                        (None, 200, 40, 0.01)):
        plan = FaultPlan(seed, horizon=horizon, rates=rates, stall_steps=stall,
                         slow_s=slow)
        jplan = JFaultPlan(seed, horizon=horizon, rates=rates,
                           stall_steps=stall, slow_s=slow)
        for r in range(3):
            a, b = plan.replica(r), jplan.replica(r)
            assert (a.crashes, a.stalls, a.slows, a.stall_steps, a.slow_s) \
                == (b.crashes, b.stalls, b.slows, b.stall_steps, b.slow_s)
            assert [a.at(t) for t in range(horizon + stall)] == \
                [b.at(t) for t in range(horizon + stall)]
        assert plan.retrieval_errors() == jplan.retrieval_errors()
    q, jq = FaultPlan.quick(seed), JFaultPlan.quick(seed)
    assert q.replica(1).crashes == jq.replica(1).crashes
    assert q.retrieval_errors() == jq.retrieval_errors()
    with pytest.raises(ValueError):
        FaultPlan(seed, rates={"bogus_kind": 1.0})


def test_chaos_pipeline_raises_by_call_index():
    plan = FaultPlan(seed=3, horizon=40, rates={"retrieval_error": 0.3})
    inner = type("Stub", (), {"answer_batch": lambda self, qs, **kw: list(qs),
                              "name": "stub"})()
    cp = ChaosPipeline(inner, plan)
    errs = plan.retrieval_errors()
    assert errs == JFaultPlan(seed=3, horizon=40,
                              rates={"retrieval_error": 0.3}
                              ).retrieval_errors()
    for i in range(40):
        if i in errs:
            with pytest.raises(InjectedFault):
                cp.answer_batch(["q"])
        else:
            assert cp.answer_batch(["q"]) == ["q"]
    assert cp.injected == len(errs) and cp.name == "stub"


# ------------------------------------------------------- pipelines


@pytest.fixture(scope="module")
def slms():
    """The reference's sLM (float32 reduced qwen2.5-0.5B) and the port's
    on the same weights, each shared by every pipeline of its package."""
    jcfg = j_get_config("qwen25_0_5b").reduced(dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jslm = ReducedSLM()
    jslm._engine = JEngine(jcfg, jparams,
                           max_len=jslm.max_prompt + jslm.max_new,
                           page_size=jslm.page_size)
    jslm._tok = JHashTokenizer(jcfg.vocab_size)
    cfg = get_config("qwen25_0_5b").reduced(dtype="float32")
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    return SLM(cfg, params=params, device="cpu"), jslm, cfg, params


@pytest.fixture(scope="module")
def corpus60():
    c = make_qa_corpus(n_docs=60, n_questions=24, seed=0)
    assert c.docs == j_make_qa_corpus("squad", n_docs=60, n_questions=24,
                                      seed=0).docs
    return c


@pytest.fixture(scope="module")
def corpus50():
    c = make_qa_corpus(n_docs=50, n_questions=16, seed=0)
    assert c.docs == j_make_qa_corpus("squad", n_docs=50, n_questions=16,
                                      seed=0).docs
    return c


class PoisonEmbedder:
    """Raises on any text with the poison marker: a scripted embedder
    failure that hits exactly one query (tests/test_faults.py)."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, texts):
        if any("POISON" in t for t in texts):
            raise RuntimeError("embedder down for this query")
        return self.inner(texts)


def _pair(slms, docs, poison=False, **kw):
    """(port pipeline, reference pipeline) over `docs`, device retrieval
    on both, each on its package's shared sLM."""
    slm, jslm, _, _ = slms
    emb, jemb = HashEmbedder(dim=96), JHashEmbedder(dim=96)
    if poison:
        emb, jemb = PoisonEmbedder(emb), PoisonEmbedder(jemb)
    pipe = MobileRAG(docs, emb, top_k=3, device="cpu", **kw)
    pipe._slm = slm
    jpipe = JMobileRAG(docs, jemb, top_k=3, device_retrieval=True, **kw)
    jpipe._slm_engine = jslm
    return pipe, jpipe


def same_answer(a, b):
    """True when the port's answer `a` has the reference's `b`'s doc ids
    and prompt. Otherwise asserts that near-tied SCR windows explain the
    difference (F5) and returns False."""
    if a.prompt == b.prompt:
        assert a.doc_ids == b.doc_ids
        return True
    assert a.scr is not None and b.scr is not None, (a.prompt, b.prompt)
    assert set(a.doc_ids) == set(b.doc_ids), (a.doc_ids, b.doc_ids)
    sa = dict(zip(a.doc_ids, a.scr.scores))
    sb = dict(zip(b.doc_ids, b.scr.scores))
    for d in sa:
        assert abs(sa[d] - sb[d]) <= SCORE_TOL, (d, sa[d], sb[d])
    pos = {d: i for i, d in enumerate(b.doc_ids)}
    for i, x in enumerate(a.doc_ids):
        for y in a.doc_ids[i + 1:]:
            if pos[x] > pos[y]:
                assert abs(sa[x] - sa[y]) <= 2 * SCORE_TOL, (x, y)
    return False


def same_answers(got, want):
    """Every pair equal or tied (`same_answer`); greedy tokens equal
    wherever the prompts are. Returns how many pairs were equal."""
    n = 0
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None and same_answer(a, b):
            assert a.gen_tokens == b.gen_tokens
            n += 1
    return n


def _drain(sess, max_steps=2000):
    events = []
    for _ in range(max_steps):
        if not (sess.pending or sess._events_out):
            return events
        events.extend(sess.step())
    raise AssertionError(f"session not drained in {max_steps} steps")


def _by_request(events):
    out = {}
    for ev in events:
        out.setdefault(ev.req_id, []).append(ev)
    return out


def same_events(sess, jsess, events, jevents):
    """The same states, counters and per-request event streams (kinds and
    payloads; the payloads of a tied request's answer excepted)."""
    assert dataclasses.asdict(sess.counters) == \
        dataclasses.asdict(jsess.counters)
    assert {r: q.state for r, q in sess.requests.items()} == \
        {r: q.state for r, q in jsess.requests.items()}
    assert {r: q.max_new for r, q in sess.requests.items()} == \
        {r: q.max_new for r, q in jsess.requests.items()}
    got, want = _by_request(events), _by_request(jevents)
    assert got.keys() == want.keys()
    for rid in got:
        req, jreq = sess.requests[rid], jsess.requests[rid]
        exact = req.answer is None or same_answer(req.answer, jreq.answer)
        kinds = [e.kind for e in got[rid]]
        jkinds = [e.kind for e in want[rid]]
        if not exact:
            assert kinds[-1] == jkinds[-1]
            continue
        assert kinds == jkinds, rid
        for e, je in zip(got[rid], want[rid]):
            if e.kind == "done":
                assert e.payload.gen_tokens == je.payload.gen_tokens
                assert e.payload.prompt == je.payload.prompt
            else:
                assert e.payload == je.payload, (rid, e.kind)


def test_answers_match_reference_up_to_ties(slms, corpus60, corpus50):
    """Both corpora, fused retrieval and SCR: the same doc ids and
    prompts, ties explained (F5), and no fallback counted."""
    for c in (corpus60, corpus50):
        pipe, jpipe = _pair(slms, c.docs)
        qs = [e.question for e in c.examples]
        n = same_answers(pipe.answer_batch(qs), jpipe.answer_batch(qs))
        assert n >= len(qs) - 3
        assert pipe.retrieval_fallbacks == pipe.scr_fallbacks == 0


def test_chaos_session_matches_reference(slms, corpus60, tmp_path):
    """tests/test_faults.py's chaos pipeline: seed 3 fails calls 0 and 2,
    so the fused chunk fails, the isolated retries run, and query 1 ends
    "failed" alone. The same partition, events and counters on both, and
    the port's trace passes the checker with the chaos records in it."""
    pipe, jpipe = _pair(slms, corpus60.docs)
    plan = FaultPlan(seed=3, horizon=12, rates={"retrieval_error": 0.5})
    sink = TraceSink()
    cp = ChaosPipeline(pipe, plan, trace=sink)
    jcp = JChaosPipeline(jpipe, JFaultPlan(seed=3, horizon=12,
                                           rates={"retrieval_error": 0.5}),
                         trace=JTraceSink())
    sess = RagSession(cp, max_new=4, slots=2, retrieve_chunk=4, trace=sink)
    jsess = JRagSession(jcp, max_new=4, slots=2, retrieve_chunk=4,
                        trace=jcp.trace)
    qs = [e.question for e in corpus60.examples[:4]]
    for s in (sess, jsess):
        for q in qs:
            s.submit(q)
    events, jevents = _drain(sess), _drain(jsess)
    assert cp.injected == jcp.injected == 2
    assert sess.counters.failed == 1 and sess.counters.completed == 3
    assert sess.requests[1].state == "failed"
    same_events(sess, jsess, events, jevents)
    path = tmp_path / "chaos_session.jsonl"
    sink.export_jsonl(path)
    assert trace_check.main([str(path)]) == 0
    recs = trace_check.load_jsonl(path)
    assert trace_check.check_records(recs, complete=True) == []
    assert [r["attrs"]["kind"] for r in recs if r["comp"] == "chaos"] == \
        ["retrieval_error"] * 2
    terms = {r["rid"]: r["name"] for r in recs if r["comp"] == "session"
             and r["name"] in ("done", "failed", "shed")}
    assert terms == {0: "done", 1: "failed", 2: "done", 3: "done"}


def test_overload_degrades_then_sheds_like_reference(slms, corpus60):
    pipe, jpipe = _pair(slms, corpus60.docs)
    qs = [e.question for e in corpus60.examples[:6]]
    runs = []
    for p in (pipe, jpipe):
        s = p.session(max_new=4, slots=2, retrieve_chunk=2, max_pending=4)
        for q in qs:
            s.submit(q)
        assert s.overloaded
        runs.append((s, _drain(s)))
    (sess, events), (jsess, jevents) = runs
    assert sess.counters.degraded == 2 and sess.counters.shed_overload == 2
    assert sess.requests[2].max_new == 2
    assert [e.payload for e in events if e.kind == "shed"] == \
        ["overload"] * 2
    same_events(sess, jsess, events, jevents)


def test_poisoned_query_fails_alone_like_reference(slms, corpus60):
    pipe, jpipe = _pair(slms, corpus60.docs, poison=True)
    qs = [e.question for e in corpus60.examples[3:6]] + ["POISON query?"]
    runs = []
    for p in (pipe, jpipe):
        s = p.session(max_new=4, slots=2, retrieve_chunk=4)
        for q in qs:
            s.submit(q)
        runs.append((s, _drain(s)))
    (sess, events), (jsess, jevents) = runs
    failed = [e for e in events if e.kind == "failed"]
    assert [e.req_id for e in failed] == [3]
    assert failed[0].payload == "RuntimeError('embedder down for this query')"
    assert sess.counters.failed == 1 and sess.counters.completed == 3
    assert sess.counters.retrieval_retries == 4
    same_events(sess, jsess, events, jevents)
    assert pipe.retrieval_fallbacks == pipe.scr_fallbacks == 0


def test_zero_deadline_sheds_everything_like_reference(slms, corpus50):
    pipe, jpipe = _pair(slms, corpus50.docs)
    qs = [e.question for e in corpus50.examples[:5]]
    runs = []
    for p in (pipe, jpipe):
        s = p.session(max_new=4, slots=2, deadline_s=0.0)
        rids = [s.submit(q) for q in qs]
        runs.append((s, _drain(s)))
        assert [s.requests[r].state for r in rids] == ["shed"] * len(qs)
    (sess, events), (jsess, jevents) = runs
    assert sess.counters.shed_deadline == len(qs)
    assert sess.engine.pending == 0
    same_events(sess, jsess, events, jevents)


def test_deadline_cancels_decoding_and_frees_the_slot(slms, corpus50):
    """A request whose deadline passes mid-decode is shed ("deadline"),
    its slot freed through `engine.cancel`, and the slot serves the next
    request (tests/test_faults.py)."""
    pipe, _ = _pair(slms, corpus50.docs)
    sess = pipe.session(max_new=20, slots=2)
    rid = sess.submit(corpus50.examples[0].question, deadline_s=30.0)
    sess.step()
    assert sess.requests[rid].state == "decoding"
    sess.requests[rid].expires_s = time.perf_counter()
    cancelled = sess.engine.cancelled
    events = sess.step()
    assert [(e.req_id, e.payload) for e in events if e.kind == "shed"] == \
        [(rid, "deadline")]
    assert sess.counters.shed_deadline == 1
    assert sess.engine.pending == 0
    assert sess.engine.cancelled == cancelled + 1
    out = sess.run([corpus50.examples[1].question])
    assert out[0] is not None and out[0].gen_tokens
    st = sess.engine.page_stats()
    assert st.mapped_refs == st.retained


def test_slo_sheds_after_learning_costs_like_reference(slms, corpus50):
    """SLO admission admits the first chunk blind, learns the stage
    costs from its spans, then sheds requests whose budget cannot cover
    the floor configuration; the trace stays checker-clean."""
    pipe, jpipe = _pair(slms, corpus50.docs)
    qs = [e.question for e in corpus50.examples[:4]]
    runs = []
    for p, sink in ((pipe, TraceSink()), (jpipe, JTraceSink())):
        s = p.session(max_new=4, slots=2, retrieve_chunk=2, trace=sink,
                      slo_s=1e-6)
        first = [s.submit(q) for q in qs[:2]]
        events = _drain(s)
        assert all(s.requests[r].state == "done" for r in first)
        later = [s.submit(q) for q in qs[2:]]
        events += _drain(s)
        assert all(s.requests[r].state == "shed" for r in later)
        runs.append((s, events, sink))
    (sess, events, sink), (jsess, jevents, _) = runs
    assert sess.counters.shed_slo == 2
    same_events(sess, jsess, events, jevents)
    assert trace_check.check_records(sink.records()) == []
    assert {r.attrs["reason"] for r in sink.records()
            if r.comp == "session" and r.name == "shed"} == {"slo"}


def test_slo_degrade_lowers_n_probe_through_wrappers(slms, corpus50,
                                                     monkeypatch):
    """A forced degrade plan lowers the probe width of the pipeline that
    owns `n_probe` (found by walking the wrappers' `.inner` chain) for
    that chunk, and restores it after, in both packages."""
    pipe, jpipe = _pair(slms, corpus50.docs)
    seen = {"port": [], "ref": []}
    for key, p in (("port", pipe), ("ref", jpipe)):
        orig = type(p)._retrieve_batch

        def spy(self, qvs, k, _orig=orig, _key=key):
            seen[_key].append(self.n_probe)
            return _orig(self, qvs, k)
        monkeypatch.setattr(type(p), "_retrieve_batch", spy)
    runs = []
    for p, sess_cls, plan_cls, sink_cls, cp_cls, fp_cls in (
            (pipe, RagSession, SLOPlan, TraceSink, ChaosPipeline, FaultPlan),
            (jpipe, JRagSession, JSLOPlan, JTraceSink, JChaosPipeline,
             JFaultPlan)):
        wrapped = cp_cls(cp_cls(p, fp_cls(seed=0)), fp_cls(seed=1))
        s = sess_cls(wrapped, max_new=4, slots=2, retrieve_chunk=2,
                     trace=sink_cls(), slo_s=30.0)
        a0 = s.run([corpus50.examples[0].question])
        monkeypatch.setattr(
            s._slo, "plan", lambda budget, mx, ch, np_, _cls=plan_cls, **kw:
            _cls("degrade", mx, ch, 2, 0.0))
        a1 = s.run([corpus50.examples[1].question])
        assert p.n_probe == 4 and "n_probe" not in vars(wrapped)
        runs.append((s, a0 + a1))
    (sess, got), (jsess, want) = runs
    assert seen["port"] == seen["ref"] == [4, 2]
    assert sess.counters.degraded_slo == jsess.counters.degraded_slo == 1
    same_answers(got, want)


# ----------------------------------------------------------- fallbacks


def _boom(*a, **kw):
    raise RuntimeError("stage down")


def test_retrieval_fallback_matches_reference(slms, corpus60, monkeypatch):
    """An index fault serves the last good batch's ids, cycled (warm), or
    the corpus head (cold), counted once a batch; SCR then condenses
    those documents, as in the reference."""
    qs = [e.question for e in corpus60.examples[:5]]
    pipe, jpipe = _pair(slms, corpus60.docs)
    cold, jcold = _pair(slms, corpus60.docs)
    good = pipe.answer_batch(qs[:2])
    jgood = jpipe.answer_batch(qs[:2])
    same_answers(good, jgood)
    for p in (pipe, jpipe, cold, jcold):
        monkeypatch.setattr(p.index, "search_device_batched", _boom)
    warm = pipe.answer_batch(qs)
    jwarm = jpipe.answer_batch(qs)
    assert pipe.retrieval_fallbacks == jpipe.retrieval_fallbacks == 1
    assert [set(a.doc_ids) for a in warm] == \
        [set(good[i % 2].doc_ids) for i in range(len(qs))]
    same_answers(warm, jwarm)
    head = cold.answer_batch(qs)
    jhead = jcold.answer_batch(qs)
    assert cold.retrieval_fallbacks == jcold.retrieval_fallbacks == 1
    assert all(set(a.doc_ids) == {0, 1, 2} for a in head)
    same_answers(head, jhead)
    assert pipe.scr_fallbacks == cold.scr_fallbacks == 0


def test_scr_fallback_full_docs_match_reference(slms, corpus60,
                                                monkeypatch):
    """An SCR fault serves each query its full retrieved documents, the
    reference's prompt byte for byte: one count a batch on the window
    index's path, one a query on the legacy per-query path."""
    qs = [e.question for e in corpus60.examples[:4]]
    pipe, jpipe = _pair(slms, corpus60.docs)
    monkeypatch.setattr("repro_torch.serving.rag.apply_scr_batch", _boom)
    monkeypatch.setattr("repro.serving.rag.apply_scr_batch", _boom)
    got, want = pipe.answer_batch(qs), jpipe.answer_batch(qs)
    assert pipe.scr_fallbacks == jpipe.scr_fallbacks == 1
    for a, b in zip(got, want):
        assert a.scr is None and a.prompt.startswith("Context:\n[Doc ")
        assert (a.prompt, a.doc_ids, a.prompt_tokens) == \
            (b.prompt, b.doc_ids, b.prompt_tokens)
    lpipe, ljpipe = _pair(slms, corpus60.docs, use_window_index=False)
    monkeypatch.setattr("repro_torch.serving.rag.apply_scr", _boom)
    monkeypatch.setattr("repro.serving.rag.apply_scr", _boom)
    got, want = lpipe.answer_batch(qs), ljpipe.answer_batch(qs)
    assert lpipe.scr_fallbacks == ljpipe.scr_fallbacks == len(qs)
    assert [(a.prompt, a.doc_ids) for a in got] == \
        [(b.prompt, b.doc_ids) for b in want]
    # decoding the fallback prompts gives the reference's tokens
    gen = pipe.answer_batch(qs[:2], generate=True, max_new=4)
    jgen = jpipe.answer_batch(qs[:2], generate=True, max_new=4)
    assert [a.gen_tokens for a in gen] == [b.gen_tokens for b in jgen]
    assert pipe.scr_fallbacks == jpipe.scr_fallbacks == 2


# ------------------------------------------------------- kernel faults


def _kernel_fault(*a, **kw):
    raise ops.KernelError("injected kernel fault")


@pytest.fixture
def fresh(slms, corpus50):
    """A port pipeline on its own sLM (a kernel fault leaves an engine
    mid-step)."""
    _, _, cfg, params = slms
    pipe = MobileRAG(corpus50.docs, HashEmbedder(dim=96), top_k=3,
                     device="cpu", gen_config=cfg, gen_params=dict(params))
    return pipe, [e.question for e in corpus50.examples[:4]]


@pytest.mark.parametrize("wrapper", ["ecoscan", "scr_select"])
def test_kernel_fault_propagates_from_answer_batch(fresh, monkeypatch,
                                                   wrapper):
    pipe, qs = fresh
    pipe.answer_batch(qs[:1])
    monkeypatch.setattr(ops, wrapper, _kernel_fault)
    with pytest.raises(ops.KernelError):
        pipe.answer_batch(qs)
    assert pipe.retrieval_fallbacks == pipe.scr_fallbacks == 0


def test_kernel_fault_propagates_from_legacy_scr(slms, corpus50,
                                                 monkeypatch):
    _, _, cfg, params = slms
    pipe = MobileRAG(corpus50.docs, HashEmbedder(dim=96), top_k=3,
                     device="cpu", use_window_index=False, gen_config=cfg,
                     gen_params=dict(params))
    monkeypatch.setattr(ops, "scr_score", _kernel_fault)
    with pytest.raises(ops.KernelError):
        pipe.answer_batch([corpus50.examples[0].question])
    assert pipe.scr_fallbacks == 0


@pytest.mark.parametrize("wrapper", ["ecoscan", "scr_select",
                                     "flash_prefill_paged"])
def test_kernel_fault_propagates_from_session_step(fresh, monkeypatch,
                                                   wrapper):
    """The fused chunk and the isolated retry both re-raise a kernel
    fault (the prompt chunks' attention is flash_prefill_paged): `step()`
    raises and no counter moves (no retry, no failure, no fallback)."""
    pipe, qs = fresh
    sess = pipe.session(max_new=4, slots=2)
    for q in qs:
        sess.submit(q)
    before = dataclasses.asdict(sess.counters)
    monkeypatch.setattr(ops, wrapper, _kernel_fault)
    with pytest.raises(ops.KernelError):
        sess.step()
    assert dataclasses.asdict(sess.counters) == before
    assert pipe.retrieval_fallbacks == pipe.scr_fallbacks == 0


def test_kernel_fault_in_a_chaos_retry_propagates(fresh, monkeypatch):
    """Under chaos the fused chunk fails by injection; the isolated
    retry then meets a kernel fault, which propagates instead of
    failing the query."""
    pipe, qs = fresh
    cp = ChaosPipeline(pipe, FaultPlan(seed=3, horizon=12,
                                       rates={"retrieval_error": 0.5}))
    sess = RagSession(cp, max_new=4, slots=2, retrieve_chunk=4)
    for q in qs:
        sess.submit(q)
    monkeypatch.setattr(ops, "ecoscan", _kernel_fault)
    with pytest.raises(ops.KernelError):
        sess.step()
    assert cp.injected == 1
    assert sess.counters.failed == 0 and sess.counters.completed == 0


def test_is_kernel_fault():
    assert ops.KernelError is build.KernelError
    assert issubclass(ops.KernelError, RuntimeError)
    assert ops.is_kernel_fault(ops.KernelError("x"))
    assert ops.is_kernel_fault(RuntimeError("CUDA error: an illegal memory "
                                            "access was encountered"))
    if hasattr(torch, "AcceleratorError"):
        assert ops.is_kernel_fault(torch.AcceleratorError("device fault"))
    assert not ops.is_kernel_fault(RuntimeError("index down"))
    assert not ops.is_kernel_fault(InjectedFault("retrieval error @ call 0"))
    assert not ops.is_kernel_fault(ValueError("CUDA error"))
    with pytest.raises(ops.KernelError, match="launch failed"):
        ops._raise_on(700, "ecoscan")
    ops._raise_on(0, "ecoscan")


def test_build_faults_are_kernel_errors(monkeypatch):
    """No nvcc, as on a machine without the CUDA toolkit: the build
    raises `KernelError`."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(ops.KernelError, match="nvcc not found"):
        build._nvcc()
