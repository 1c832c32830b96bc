"""The port's replica schedulers on the CPU. `HealthTracker` against the
JAX package's under an injected clock; `SlotScheduler` over three clones
of the float32 reduced qwen2.5-0.5B continuous engine, under `FaultPlan`
crashes and stalls, against the reference's on the same weights (carried
across by `params_from_reference`): with hedging off (`stall_s=1e9`),
probes due at once (`probe_cooldown_s=0`) and no deadlines the run is
deterministic, so the completions (rid, tokens, replica), the shed list,
the counters and the injected faults must be equal. The reference's
scheduler tests (tests/test_faults.py) on the port: the queue bound,
re-hedging, drain and probation, a deadline expiring on a real engine,
the chaos soak (every request in exactly one terminal state, a drained
replica recovered, no page held, a trace that passes
`tools/trace_check.py`) and the legacy wave `Scheduler`.

The port's one deliberate difference: a kernel fault (`KernelError`, a
CUDA error) raised in a replica's step, a probe's placement, a cancel or
a wave dispatch propagates out of `run()` and moves no counter, where
any other exception strikes the replica as in the reference."""
import dataclasses
import importlib.util
import pathlib
import time
from collections import deque
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.dist.fault import HealthConfig as JHealthConfig
from repro.dist.fault import HealthTracker as JHealthTracker
from repro.models import model as jmodel
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.faults import wrap_replicas as j_wrap_replicas
from repro.serving.scheduler import SlotScheduler as JSlotScheduler
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.dist.fault import HealthConfig, HealthTracker
from repro_torch.kernels import ops
from repro_torch.models.dense import DenseLM
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.faults import FaultPlan, wrap_replicas
from repro_torch.serving.scheduler import Scheduler, SlotScheduler
from repro_torch.serving.trace import TraceSink

_TC = pathlib.Path(__file__).resolve().parent.parent / "tools" \
    / "trace_check.py"
_spec = importlib.util.spec_from_file_location("trace_check", _TC)
trace_check = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(trace_check)


class FakeEngine:
    """Engine-like (submit/step/available_slots/cancel) with scripted
    behaviour (tests/test_faults.py): one token per request a step,
    `fail_steps` raise `fail_with`, `stalled` returns no events,
    `step_delay` slows real time down."""

    def __init__(self, slots=2, step_delay=0.0):
        self.slots_n = slots
        self.step_delay = step_delay
        self.fail_steps = set()
        self.fail_with = RuntimeError
        self.stalled = False
        self.step_idx = 0
        self.queue = deque()
        self.running = {}
        self._next = 0

    def submit(self, prompt, max_new=32, **kw):
        rid = self._next
        self._next += 1
        self.queue.append((rid, max_new))
        return rid

    def available_slots(self):
        return self.slots_n - len(self.running) - len(self.queue)

    def cancel(self, rid):
        if rid in self.running:
            del self.running[rid]
            return True
        n = len(self.queue)
        self.queue = deque(x for x in self.queue if x[0] != rid)
        return len(self.queue) != n

    def step(self):
        i = self.step_idx
        self.step_idx += 1
        if self.step_delay:
            time.sleep(self.step_delay)
        if i in self.fail_steps:
            raise self.fail_with(f"scripted step failure @ {i}")
        if self.stalled:
            return []
        events = []
        while self.queue and len(self.running) < self.slots_n:
            rid, mx = self.queue.popleft()
            self.running[rid] = [mx, []]
        for rid in list(self.running):
            mx, toks = self.running[rid]
            toks.append(7)
            if len(toks) >= mx:
                del self.running[rid]
                events.append(SimpleNamespace(
                    rid=rid, kind="done",
                    result=SimpleNamespace(tokens=list(toks))))
            else:
                events.append(SimpleNamespace(rid=rid, kind="token",
                                              token=7))
        return events


# -------------------------------------------------------- HealthTracker


def _tracker_state(t):
    return (t.state, t.strikes, t.probes, t.drains, t.recoveries, t.healthy,
            t.exhausted, t.probe_due())


@pytest.mark.parametrize("cfg", [
    dict(max_strikes=2, cooldown_s=1.0, cooldown_backoff=2.0, max_probes=2),
    dict(max_strikes=1, cooldown_s=0.1, max_probes=1),
    dict(max_strikes=3, strike_decay=2, cooldown_s=0.5, cooldown_max_s=1.5,
         max_probes=None),
])
def test_health_tracker_matches_reference(cfg):
    """A scripted sequence of failures, successes, probes and clock
    moves: the same state, strikes, probes, drains and recoveries after
    every step."""
    clock = {"t": 0.0}
    t = HealthTracker(HealthConfig(**cfg), clock=lambda: clock["t"])
    jt = JHealthTracker(JHealthConfig(**cfg), clock=lambda: clock["t"])
    script = ["fail", "ok", "fail", "fail", "fail", "tick", "probe", "fail",
              "tick", "tick", "probe", "ok", "ok", "fail", "fail", "fail",
              "tick", "probe", "fail", "tick", "tick", "tick", "probe", "fail",
              "tick", "tick", "tick", "tick", "probe", "ok"]
    for op in script:
        outs = []
        for tr in (t, jt):
            if op == "fail":
                outs.append(tr.record_failure())
            elif op == "ok":
                outs.append(tr.record_success())
            elif op == "probe" and tr.probe_due():
                tr.begin_probe()
        if op == "tick":
            clock["t"] += 0.6
        assert len(set(outs)) <= 1, op
        assert _tracker_state(t) == _tracker_state(jt), op
    assert t.drains >= 2


# --------------------------------------------- SlotScheduler, fake engines


def test_queue_bound_degrades_then_sheds():
    for sched_cls in (SlotScheduler, JSlotScheduler):
        s = sched_cls([FakeEngine(slots=1)], max_queue=2, overflow="degrade")
        rids = [s.submit(np.arange(4), max_new=8) for _ in range(6)]
        assert s.counters.degraded == 2 and s.counters.shed_queue == 2
        assert [sh.reason for sh in s.shed] == ["queue_full"] * 2
        done = s.run()
        toks = {c.rid: c.tokens for c in done}
        assert set(toks) == set(rids[:4])
        assert len(toks[rids[0]]) == 8 and len(toks[rids[2]]) == 4
        r = sched_cls([FakeEngine(slots=1)], max_queue=1, overflow="reject")
        for _ in range(3):
            r.submit(np.arange(4), max_new=2)
        assert r.counters.shed_queue == 2 and r.counters.degraded == 0


def test_rehedge_after_repeated_stall():
    stall0, stall1 = FakeEngine(slots=4), FakeEngine(slots=3)
    stall0.stalled = stall1.stalled = True
    s = SlotScheduler([stall0, stall1, FakeEngine(slots=2)], stall_s=0.03,
                      max_hedges=2, max_strikes=5)
    rid = s.submit(np.arange(6), max_new=2)
    done = s.run()
    assert [c.rid for c in done] == [rid]
    assert done[0].hedged and done[0].replica == 2
    assert s.counters.hedges == 2 and s.counters.strikes >= 2


def test_drain_requeue_probation_recovery():
    flaky = FakeEngine(slots=2)
    flaky.fail_steps = {0, 1}
    good = FakeEngine(slots=1, step_delay=0.004)
    s = SlotScheduler([flaky, good], max_strikes=2, probe_cooldown_s=0.03,
                      stall_s=10.0)
    rids = [s.submit(np.arange(5), max_new=3) for _ in range(8)]
    done = s.run()
    assert {c.rid for c in done} == set(rids) and not s.shed
    h = s.state[0]
    assert h.tracker.drains == 1 and s.counters.drains == 1
    assert s.counters.probes >= 1 and s.counters.recoveries == 1
    assert h.healthy and h.served >= 1 and s.counters.strikes >= 2


# ------------------------------------------------------- kernel faults


def test_kernel_fault_in_a_step_propagates():
    """A plain exception strikes the replica (as the reference does); a
    kernel fault propagates and moves no counter."""
    for exc, absorbed in ((RuntimeError, True), (ops.KernelError, False),
                          (lambda m: RuntimeError("CUDA error: " + m), False)):
        bad = FakeEngine(slots=2)
        bad.fail_steps, bad.fail_with = {0}, exc
        s = SlotScheduler([bad, FakeEngine(slots=2)], stall_s=10.0)
        for _ in range(4):
            s.submit(np.arange(5), max_new=3)
        before = dataclasses.asdict(s.counters)
        if absorbed:
            assert len(s.run()) == 4 and s.counters.strikes == 1
        else:
            with pytest.raises(RuntimeError) as info:
                s.run()
            assert ops.is_kernel_fault(info.value)
            assert dataclasses.asdict(s.counters) == before


def test_kernel_fault_in_a_probe_or_cancel_propagates():
    class FailingSubmit(FakeEngine):
        def submit(self, prompt, max_new=32, **kw):
            if self.armed:
                raise ops.KernelError("submit")
            return super().submit(prompt, max_new, **kw)

    eng = FailingSubmit(slots=2)
    eng.armed, eng.fail_steps = False, {0, 1}
    s = SlotScheduler([eng, FakeEngine(slots=1, step_delay=0.004)],
                      max_strikes=2, probe_cooldown_s=0.0, stall_s=10.0)
    for _ in range(6):
        s.submit(np.arange(5), max_new=3)
    s._admit()
    for _ in range(2):                   # two failed steps drain replica 0
        with pytest.raises(RuntimeError):
            eng.step()
        s._strike(0)
        s._requeue_placements(0)
    assert s.counters.drains == 1
    eng.armed = True
    with pytest.raises(ops.KernelError):
        s._probe()
    assert s.counters.strikes == 2 and s.counters.drains == 1

    class FailingCancel(FakeEngine):
        def cancel(self, rid):
            raise ops.KernelError("cancel")
    s = SlotScheduler([FailingCancel(slots=2)], deadline_s=0.0)
    s.submit(np.arange(5), max_new=3)
    s._admit()
    with pytest.raises(ops.KernelError):
        s.run()
    s = SlotScheduler([FakeEngine(slots=2)], deadline_s=0.0)
    s.engines[0].cancel = lambda rid: (_ for _ in ()).throw(
        RuntimeError("cancel"))
    s.submit(np.arange(5), max_new=3)
    s._admit()
    assert s.run() == [] and s.counters.shed_deadline == 1


def test_kernel_fault_in_a_wave_dispatch_propagates():
    def broken(prompts, max_new):
        raise ops.KernelError("wave")

    def fine(prompts, max_new):
        return [[1] for _ in prompts]
    s = Scheduler([broken, fine], max_wave=4)
    s.submit(np.arange(5))
    with pytest.raises(ops.KernelError):
        s.run()
    assert s.state[0].strikes == 0 and s.state[0].healthy


# ------------------------------------------------------- legacy waves


def test_legacy_scheduler_cold_start_exempt_from_deadline():
    calls = []

    def cold_then_fast(prompts, max_new):
        calls.append(len(prompts))
        if len(calls) == 1:
            time.sleep(0.08)
        return [[1, 2] for _ in prompts]

    s = Scheduler([cold_then_fast], max_wave=4, deadline_s=0.02)
    for _ in range(2):
        s.submit(np.arange(5))
    done = s.run()
    assert len(done) == 2 and not any(c.hedged for c in done)
    assert s.state[0].strikes == 0 and s.state[0].healthy
    assert s.state[0].warmed

    def always_slow(prompts, max_new):
        time.sleep(0.05)
        return [[1] for _ in prompts]

    def fast(prompts, max_new):
        return [[1] for _ in prompts]

    s2 = Scheduler([always_slow, fast], max_wave=4, deadline_s=0.02,
                   max_strikes=1)
    for n in (5, 6, 7):
        s2.submit(np.arange(n))
    done2 = s2.run()
    assert len(done2) == 3
    assert not s2.state[0].healthy and s2.state[0].strikes == 1
    assert any(c.hedged and c.replica == 1 for c in done2)


# ---------------------------------------------- real engines (reduced)


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("qwen25_0_5b").reduced(dtype="float32")
    cfg = get_config("qwen25_0_5b").reduced(dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    lm = DenseLM(cfg, device="cpu", params=params_from_reference(
        jax.tree.map(np.asarray, jparams), "cpu"))
    return jcfg, jparams, lm


@pytest.fixture(scope="module")
def base_engine(models):
    ce = ContinuousEngine(models[2], slots=2, max_len=128)
    ce.warmup()
    return ce


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(4, 500, size=int(rng.integers(8, 40))
                          ).astype(np.int32), int(rng.integers(2, 6)))
            for _ in range(n)]


def test_slot_scheduler_under_faults_matches_reference(models):
    """Crashes (a crash cancels the replica's in-flight requests) and
    stalls over three replicas: the same completions, shed list,
    counters and injected faults as the reference's scheduler."""
    jcfg, jparams, lm = models
    kw = dict(horizon=40, rates={"replica_crash": 0.1, "slot_stall": 0.05},
              stall_steps=6, slow_s=0.0)
    base = ContinuousEngine(lm, slots=2, max_len=128)
    jbase = JContinuousEngine(jcfg, jparams, slots=2, max_len=128)
    runs = []
    for engines, wrap, plan, sched_cls in (
            ([base.clone() for _ in range(3)], wrap_replicas,
             FaultPlan(2, **kw), SlotScheduler),
            ([jbase.clone() for _ in range(3)], j_wrap_replicas,
             JFaultPlan(2, **kw), JSlotScheduler)):
        wrapped = wrap(engines, plan)
        s = sched_cls(wrapped, stall_s=1e9, probe_cooldown_s=0.0,
                      max_strikes=2, max_hedges=3, max_probes=None)
        for prompt, max_new in _requests(7, 16):
            s.submit(prompt, max_new)
        done = s.run()
        runs.append((s, done, wrapped))
    (s, done, wrapped), (js, jdone, jwrapped) = runs
    assert [(c.rid, c.tokens, c.replica, c.hedged) for c in done] == \
        [(c.rid, c.tokens, c.replica, c.hedged) for c in jdone]
    assert [(sh.rid, sh.reason) for sh in s.shed] == \
        [(sh.rid, sh.reason) for sh in js.shed]
    assert dataclasses.asdict(s.counters) == dataclasses.asdict(js.counters)
    assert [w.injected for w in wrapped] == [w.injected for w in jwrapped]
    assert s.counters.drains >= 1 and s.counters.completed == 16
    assert sum(w.injected["replica_crash"] for w in wrapped) >= 1
    for w, jw in zip(wrapped, jwrapped):
        assert (w.inner.cancelled, w.step_idx) == \
            (jw.inner.cancelled, jw.step_idx)
        assert dataclasses.astuple(w.inner.page_stats()) == \
            dataclasses.astuple(jw.inner.page_stats())
    assert [h.served for h in s.state] == [h.served for h in js.state]


def test_kernel_fault_in_an_engine_step_propagates(base_engine, monkeypatch):
    """A kernel wrapper that raises `KernelError` inside a replica's
    step: `run()` raises it, no replica is struck."""
    engines = [base_engine.clone() for _ in range(2)]
    s = SlotScheduler(wrap_replicas(engines, FaultPlan(0)), max_probes=1,
                      probe_cooldown_s=0.0)
    for prompt, max_new in _requests(3, 4):
        s.submit(prompt, max_new)
    before = dataclasses.asdict(s.counters)
    monkeypatch.setattr(ops, "decode_attention_paged",
                        lambda *a, **k: (_ for _ in ()).throw(
                            ops.KernelError("decode_attention_paged")))
    with pytest.raises(ops.KernelError):
        s.run()
    assert dataclasses.asdict(s.counters) == before
    assert all(h.healthy and h.strikes == 0 for h in s.state)


def test_deadline_expiry_sheds_and_frees_slot(base_engine):
    engine = base_engine.clone()
    engine.warmup()
    sched = SlotScheduler([engine])
    p = np.arange(4, 24, dtype=np.int32)
    r_dead = sched.submit(p, max_new=64, deadline_s=0.03)
    r_ok = sched.submit(p + 1, max_new=3)
    sched._admit()
    assert engine.pending == 2
    time.sleep(0.05)
    done = sched.run()
    assert [c.rid for c in done] == [r_ok]
    assert [(sh.rid, sh.reason) for sh in sched.shed] == \
        [(r_dead, "deadline")]
    assert sched.counters.shed_deadline == 1
    assert engine.pending == 0 and engine.free_slots() == engine.slots
    assert engine.cancelled >= 1


def test_chaos_soak_terminal_partition_and_recovery(base_engine, tmp_path):
    """tests/test_faults.py's soak on three port replicas: seeded crashes,
    stalls and slow steps over 32 requests (every eighth with a 2 ms
    deadline). Every request ends in exactly one terminal state; no
    page stays mapped; a drained replica recovers in the calm tail; the
    shared trace passes the checker with every fault in it."""
    sink = TraceSink()
    engines = [base_engine.clone() for _ in range(3)]
    for e in engines:
        e.warmup()
        e.trace = sink
    plan = FaultPlan(seed=0, horizon=80,
                     rates={"replica_crash": 0.06, "slot_stall": 0.03,
                            "slow_step": 0.05},
                     stall_steps=30, slow_s=0.002)
    wrapped = wrap_replicas(engines, plan)
    sched = SlotScheduler(wrapped, stall_s=0.5, probe_cooldown_s=0.05,
                          max_strikes=2, max_hedges=3, max_probes=None,
                          deadline_s=30.0, trace=sink)
    rng = np.random.default_rng(1)
    rids = []
    for i in range(32):
        prompt = rng.integers(4, 500,
                              size=int(rng.integers(8, 40))).astype(np.int32)
        rids.append(sched.submit(prompt, int(rng.integers(2, 6)),
                                 deadline_s=0.002 if i % 8 == 7 else 30.0))
    done = sched.run()
    done_rids = [c.rid for c in done]
    shed_rids = [sh.rid for sh in sched.shed]
    assert len(set(done_rids)) == len(done_rids)
    assert len(set(shed_rids)) == len(shed_rids)
    assert set(done_rids).isdisjoint(shed_rids)
    assert set(done_rids) | set(shed_rids) == set(rids)
    c = sched.counters
    assert c.completed + c.shed_deadline + c.shed_queue == len(rids)
    assert sum(w.injected["replica_crash"] for w in wrapped) >= 1
    assert c.drains >= 1
    for w in wrapped:
        assert w.inner.pending == 0
        st = w.inner.page_stats()
        assert st.mapped_refs == st.retained, st
    extra = []
    for _ in range(20):
        if sched.counters.recoveries >= 1:
            break
        batch = [sched.submit(rng.integers(4, 500, size=12).astype(np.int32),
                              3) for _ in range(4)]
        extra.extend(batch)
        assert {c2.rid for c2 in sched.run()} == set(batch)
        time.sleep(0.05)
    assert sched.counters.recoveries >= 1 and sched.counters.probes >= 1
    for w in wrapped:
        w.inner.drop_prefix_cache()
        st = w.inner.page_stats()
        assert st.free == st.total and st.mapped_refs == 0, st
        assert 0 < w.inner.utilisation() <= 1
    path = tmp_path / "chaos_soak.jsonl"
    assert sink.export_jsonl(path) == len(sink)
    recs = trace_check.load_jsonl(path)
    assert trace_check.check_records(recs, complete=True) == []
    injected = [r for r in recs if r["comp"] == "chaos"]
    assert len(injected) == sum(sum(w.injected.values()) for w in wrapped)
    if any(r["attrs"]["kind"] == "replica_crash"
           and r["attrs"]["inflight"] > 0 for r in injected):
        assert any(r["comp"] == "engine" and r["name"] == "cancelled"
                   for r in recs)
    assert {r["rid"] for r in recs if r["comp"] == "sched"
            and r["name"] in ("done", "shed") and r["rid"] >= 0} == \
        set(rids) | set(extra)
    names = [r["name"] for r in recs if r["comp"] == "sched"
             and r["rid"] < 0]
    assert "drain" in names and "recover" in names
