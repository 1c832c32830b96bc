"""The port's trace layer against the JAX package on the CPU: the sink's
JSONL export and queries (`durations(window=)`, `percentile`), the SLO
controller (the same `SLOPlan` over a grid of budgets, token, chunk and
probe counts, both sinks fed the same records under a fake clock), and
`ContinuousEngine.cancel` on the reference's workloads
(tests/test_trace.py), with cancels before the first step and mid-flight:
the same record stream (comp, name, rid, ph) and non-timing attributes,
the same tokens for every request not cancelled, the same `cancelled`
count and final `page_stats`, on float32 reduced qwen2.5-0.5B with
weights carried across by `params_from_reference`. Every port export
passes `tools/trace_check.py`, the stdlib-only checker."""
import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import model as jmodel
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro.serving.trace import SLOController as JSLOController
from repro.serving.trace import TraceSink as JTraceSink
from repro.serving.trace import load_jsonl as j_load_jsonl
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.models.dense import DenseLM
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.trace import (SLOController, TraceRecord, TraceSink,
                                       load_jsonl)

_TC = pathlib.Path(__file__).resolve().parent.parent / "tools" \
    / "trace_check.py"
_spec = importlib.util.spec_from_file_location("trace_check", _TC)
trace_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_check)

# record attributes that hold wall time
_TIMING = {"prefill_s", "decode_s", "est_s"}


def _fed(sink_cls, spans):
    """A sink of `sink_cls` fed `spans` [(comp, name, dur, rid, attrs)]
    under a fake clock."""
    clock = {"t": 0.0}
    sink = sink_cls(clock=lambda: clock["t"])
    for comp, name, dur, rid, attrs in spans:
        sink.emit(comp, name, rid, ph="B", **attrs)
        clock["t"] += dur
        sink.emit(comp, name, rid, ph="E")
        sink.emit("session", "queued", rid)
    return sink


def _random_spans(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            out.append(("session", "retrieve", float(rng.uniform(0.01, 0.2)),
                        -1, {"n": int(rng.integers(1, 5))}))
        elif kind == 1:
            out.append(("engine", "prefill_chunk",
                        float(rng.uniform(0.001, 0.05)), i, {}))
        else:
            out.append(("engine", "decode_step",
                        float(rng.uniform(0.001, 0.03)), -1, {}))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_durations_and_percentile_match_reference(seed):
    spans = _random_spans(seed)
    sink, jsink = _fed(TraceSink, spans), _fed(JTraceSink, spans)
    for comp, name in (("session", "retrieve"), ("engine", "prefill_chunk"),
                       ("engine", "decode_step"), ("engine", "none")):
        for window in (None, 1, 5, 64):
            assert sink.durations(comp, name, window=window) == \
                jsink.durations(comp, name, window=window)
        for q in (0.0, 50.0, 95.0, 100.0):
            for window in (3, 256):
                assert sink.percentile(comp, name, q, window=window,
                                       default=-1.0) == \
                    jsink.percentile(comp, name, q, window=window,
                                     default=-1.0)


def test_slo_controller_plans_match_reference():
    """The same stage costs and `SLOPlan` field for field over a grid of
    budgets, max_new, retrieve chunks and probe counts (`est_s` at
    1e-12), on the reference's seeded sink and on random histories."""
    seeded = [("session", "retrieve", 0.10, -1, {"n": 2}),
              ("engine", "prefill_chunk", 0.02, 0, {}),
              ("engine", "decode_step", 0.01, -1, {})]
    histories = [seeded, _random_spans(3), _random_spans(4, n=7), []]
    n_plans = 0
    for spans in histories:
        for window in (2, 128):
            c = SLOController(_fed(TraceSink, spans), window=window)
            jc = JSLOController(_fed(JTraceSink, spans), window=window)
            assert c.stage_costs() == jc.stage_costs()
            for budget in (None, 1e-9, 0.05, 0.101, 0.15, 0.19, 0.5, 1.0,
                           30.0):
                for max_new in (1, 4, 16):
                    for chunk in (1, 2, 4):
                        for n_probe in (1, 4, 8):
                            p = c.plan(budget, max_new, chunk, n_probe)
                            jp = jc.plan(budget, max_new, chunk, n_probe)
                            assert (p.action, p.max_new, p.retrieve_chunk,
                                    p.n_probe) == (jp.action, jp.max_new,
                                                   jp.retrieve_chunk,
                                                   jp.n_probe)
                            assert (p.est_s is None) == (jp.est_s is None)
                            if p.est_s is not None:
                                assert abs(p.est_s - jp.est_s) <= 1e-12
                            n_plans += 1
            for max_new in (1, 10):
                e, je = c.estimate(max_new), jc.estimate(max_new)
                assert (e is None) == (je is None)
                if e is not None:
                    assert abs(e - je) <= 1e-12
    c = SLOController(_fed(TraceSink, seeded))
    assert [c.plan(b, 16, 4, 4).action for b in (1.0, 0.15, 0.05)] == \
        ["admit", "degrade", "shed"]
    assert n_plans == len(histories) * 2 * 9 * 27


def test_sink_clamps_evicts_and_round_trips(tmp_path):
    """Timestamps clamped monotone, ring eviction counted, and a JSONL
    export that reads back to the same records with either package's
    loader."""
    ticks = iter([5.0, 4.0, 4.5, 6.0])
    sink = TraceSink(clock=lambda: next(ticks))
    for i in range(4):
        sink.emit("bench", "tick", i)
    assert [r.ts for r in sink.records()] == [5.0, 5.0, 5.0, 6.0]
    ring = TraceSink(capacity=4)
    for i in range(7):
        ring.emit("engine", "token", i)
    assert len(ring) == 4 and ring.evicted == 3
    assert [r.rid for r in ring.records()] == [3, 4, 5, 6]
    sink = TraceSink()
    sink.emit("engine", "queued", 0, src="e0", prompt_len=8)
    with sink.span("engine", "prefill_chunk", 0, src="e0", n=4):
        pass
    path = tmp_path / "t.jsonl"
    assert sink.export_jsonl(path) == 3
    want = [r.to_dict() for r in sink.records()]
    assert [r.to_dict() for r in load_jsonl(path)] == want
    assert [r.to_dict() for r in j_load_jsonl(path)] == want
    assert TraceRecord.from_dict(want[0]).attrs["prompt_len"] == 8


# ----------------------------------------------------- engine cancel


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("qwen25_0_5b").reduced(dtype="float32")
    cfg = get_config("qwen25_0_5b").reduced(dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    lm = DenseLM(cfg, device="cpu", params=params_from_reference(
        jax.tree.map(np.asarray, jparams), "cpu"))
    return jcfg, jparams, lm


def _run_workload(ce, sink, lens, cancel_at, late, seed):
    """The reference's workload (tests/test_trace.py `_run_workload`):
    ragged prompts, every other one sampled, `cancel_at` cancelled before
    the first step; then `late` (step, index) cancels mid-flight. Returns
    (rids, tokens of each finished rid)."""
    rng = np.random.default_rng(seed)
    rids = [ce.submit(rng.integers(4, 500, n).astype(np.int32),
                      max_new=2 + i % 3, greedy=bool(i % 2), seed=seed)
            for i, n in enumerate(lens)]
    for i in cancel_at:
        ce.cancel(rids[i % len(rids)])
    late = dict(late)
    done = {}
    steps = 0
    while ce.pending:
        if steps in late:
            ce.cancel(rids[late[steps] % len(rids)])
        for ev in ce.step():
            if ev.kind == "done":
                done[ev.rid] = list(ev.result.tokens)
        steps += 1
        assert steps < 10_000
    return rids, done


def _stream(sink):
    return [(r.comp, r.name, r.rid, r.ph,
             {k: v for k, v in r.attrs.items() if k not in _TIMING})
            for r in sink.records()]


# the reference's deterministic workloads (tests/test_trace.py), each
# with mid-flight cancels: during a prefill chunk, while decoding, and
# of a request still queued
_WORKLOADS = [
    ((16, 40, 9, 33, 24), (1, 3), ((1, 4), (3, 0)), 0),
    ((8, 21, 34, 47), (0,), ((2, 3),), 1),
    ((60, 5, 5, 60, 30), (2, 4), ((0, 3), (4, 0)), 2),
    ((12,), (), (), 3),
]


@pytest.mark.parametrize("lens, cancel_at, late, seed", _WORKLOADS)
def test_cancel_workload_matches_reference(models, tmp_path, lens,
                                           cancel_at, late, seed):
    jcfg, jparams, lm = models
    sink, jsink = TraceSink(), JTraceSink()
    ce = ContinuousEngine(lm, slots=2, max_len=96, trace=sink)
    jce = JContinuousEngine(jcfg, jparams, slots=2, max_len=96, trace=jsink)
    rids, done = _run_workload(ce, sink, lens, cancel_at, late, seed)
    jrids, jdone = _run_workload(jce, jsink, lens, cancel_at, late, seed)
    assert rids == jrids
    assert done == jdone
    assert ce.cancelled == jce.cancelled == len(rids) - len(done)
    assert ce.shed == jce.shed == 0
    assert dataclasses.astuple(ce.page_stats()) == \
        dataclasses.astuple(jce.page_stats())
    assert ce.steps == jce.steps
    assert ce.active_slot_steps == jce.active_slot_steps
    assert ce.utilisation() == jce.utilisation()
    assert ce.free_slots() == ce.slots and ce.available_slots() == ce.slots
    assert _stream(sink) == _stream(jsink)
    assert all(d > 0 for d in sink.durations("engine", "prefill_chunk"))
    path = tmp_path / "cancel.jsonl"
    assert sink.export_jsonl(path) == len(sink)
    assert trace_check.main([str(path)]) == 0
    last = trace_check.last_page_stats(trace_check.load_jsonl(path))
    st = ce.page_stats()
    assert (last["mapped_refs"], last["retained"], last["inflight"]) == \
        (st.mapped_refs, st.retained, 0)


def test_cancel_each_state_frees_slot_and_pages(models):
    """A request cancelled while queued, admitted (before its first
    chunk), mid-prefill and decoding: its slot and pages are freed at
    once, the next step admits into them and uploads a fresh page
    table, and no event comes for it again; then the prefix cache drops
    to an empty pool (the reference's tests/test_faults.py contract)."""
    _, _, lm = models
    ce = ContinuousEngine(lm, slots=2, max_len=128)
    ce.warmup()
    assert ce.steps == ce.active_slot_steps == 0
    p = np.arange(4, 84, dtype=np.int32)            # three prefill chunks
    r1 = ce.submit(p, max_new=50)
    r2 = ce.submit(p[:16] + 1, max_new=3)
    r3 = ce.submit(p + 2, max_new=3)                 # queued
    assert ce.available_slots() == -1
    assert ce.cancel(r3) and not ce.cancel(r3)
    ce.step()                                        # admit r1, r2
    assert ce.free_slots() == 0
    tbl = ce._table_dev()
    assert ce.cancel(r1)                             # mid-prefill
    assert ce.free_slots() == 1 and ce._tbl_dev is None
    assert not ce._tbl[0].any()
    r4 = ce.submit(p + 3, max_new=40)
    seen = set()
    for _ in range(4):
        for ev in ce.step():
            seen.add(ev.rid)
    assert ce._table_dev() is not tbl
    assert ce.cancel(r4)                             # decoding by now
    for _ in range(200):
        if not ce.pending:
            break
        for ev in ce.step():
            seen.add(ev.rid)
    assert seen.isdisjoint({r1, r3}) and r2 in seen
    assert ce.cancelled == 3 and ce.pending == 0
    st = ce.page_stats()
    assert st.mapped_refs == st.retained
    assert ce.drop_prefix_cache() > 0
    st = ce.page_stats()
    assert st.free == st.total and st.mapped_refs == 0


def test_clone_shares_weights_with_its_own_pool(models):
    _, _, lm = models
    ce = ContinuousEngine(lm, slots=2, max_len=96, trace=TraceSink())
    twin = ce.clone(slots=3)
    assert twin.model is ce.model and twin.trace is ce.trace
    assert twin.slots == 3 and twin.trace_src != ce.trace_src
    assert all(twin.cache[n].data_ptr() != ce.cache[n].data_ptr()
               for n in ce.cache)
    assert dataclasses.astuple(twin.page_stats())[0] == 3 * ce.table_width
    prompt = np.arange(4, 30, dtype=np.int32)
    a = ce.generate([prompt], max_new=5)
    b = twin.generate([prompt], max_new=5)
    assert a[0].tokens == b[0].tokens
