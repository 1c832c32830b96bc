"""Deterministic fault injection for the serving stack (the port's copy
of `repro.serving.faults`: the same schedules from the same seeds).

A `FaultPlan` is a SEEDED schedule of faults, indexed by STEP COUNT —
never wall clock — so the same (seed, horizon, rates) always injects the
same faults at the same points in a run, on any host speed (DESIGN.md
§11). The plan derives an independent per-replica sub-schedule from
`default_rng([seed, replica_index])`, so adding replicas never perturbs
existing ones.

Fault kinds:

  replica_crash    `step()` raises `InjectedFault` AND the wrapped
                   engine's in-flight requests are cancelled — a crash
                   loses engine state, exactly what a real process death
                   does; the scheduler must re-queue and recover.
  slot_stall       `step()` returns no events for `stall_steps`
                   consecutive steps (the engine stops producing tokens),
                   which is what the scheduler's stall hedging watches.
  slow_step        `step()` sleeps `slow_s` before running — latency
                   pressure without failure.
  retrieval_error  the Nth `answer_batch` call on a wrapped pipeline
                   raises — exercises the RagSession retry/failed path.

`ChaosEngine` wraps any engine-like (submit/step/available_slots/cancel)
and injects the replica-side kinds; `ChaosPipeline` wraps a RAG pipeline
and injects retrieval errors by call index. Both delegate everything else
untouched, so they drop into `SlotScheduler` / `RagSession` unchanged —
the harness behind the chaos soak test and `bench_serving --chaos`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


class InjectedFault(RuntimeError):
    """Raised by injected replica crashes / retrieval errors so tests can
    tell scripted chaos apart from real bugs."""


DEFAULT_RATES = {
    "replica_crash": 0.0,
    "slot_stall": 0.0,
    "slow_step": 0.0,
    "retrieval_error": 0.0,
}


@dataclass
class ReplicaFaults:
    """One replica's materialised schedule: step index -> fault kind
    (plus the stall window bookkeeping)."""
    crashes: frozenset
    stalls: frozenset                 # steps that BEGIN a stall window
    slows: frozenset
    stall_steps: int
    slow_s: float
    _stall_until: int = field(default=-1, compare=False)

    def at(self, step: int) -> Optional[str]:
        """The fault active at `step` (crash wins over stall over slow)."""
        if step in self.crashes:
            return "replica_crash"
        if step in self.stalls:
            self._stall_until = max(self._stall_until,
                                    step + self.stall_steps)
        if step < self._stall_until:
            return "slot_stall"
        if step in self.slows:
            return "slow_step"
        return None


class FaultPlan:
    """Seeded, step-indexed fault schedule over N replicas + a pipeline.

    `rates` maps fault kind -> per-step probability inside `[0, horizon)`;
    past the horizon the chaos tapers to nothing, so every run has a calm
    tail in which stragglers finish and drained replicas pass probation.
    The schedule for replica r depends only on (seed, r): replaying the
    same plan reproduces the same faults at the same step indices.
    """

    def __init__(self, seed: int = 0, *, horizon: int = 200,
                 rates: Optional[Dict[str, float]] = None,
                 stall_steps: int = 40, slow_s: float = 0.01):
        self.seed = seed
        self.horizon = horizon
        self.rates = dict(DEFAULT_RATES)
        if rates:
            unknown = set(rates) - set(DEFAULT_RATES)
            if unknown:
                raise ValueError(f"unknown fault kinds: {sorted(unknown)}")
            self.rates.update(rates)
        self.stall_steps = stall_steps
        self.slow_s = slow_s

    @classmethod
    def quick(cls, seed: int = 0) -> "FaultPlan":
        """The CI soak mix: crashes, stalls and slow steps frequent
        enough that a 3-replica run sees drains AND recoveries inside a
        short horizon."""
        return cls(seed, horizon=60,
                   rates={"replica_crash": 0.05, "slot_stall": 0.02,
                          "slow_step": 0.05, "retrieval_error": 0.15},
                   stall_steps=25, slow_s=0.005)

    def _steps(self, rng: np.random.Generator, kind: str) -> frozenset:
        hits = rng.random(self.horizon) < self.rates[kind]
        return frozenset(np.flatnonzero(hits).tolist())

    def replica(self, ridx: int) -> ReplicaFaults:
        """Materialise replica `ridx`'s independent sub-schedule."""
        rng = np.random.default_rng([self.seed, ridx])
        return ReplicaFaults(self._steps(rng, "replica_crash"),
                             self._steps(rng, "slot_stall"),
                             self._steps(rng, "slow_step"),
                             self.stall_steps, self.slow_s)

    def retrieval_errors(self) -> frozenset:
        """Call indices (0-based, per wrapped pipeline) whose
        `answer_batch` raises."""
        rng = np.random.default_rng([self.seed, 10_000])
        return self._steps(rng, "retrieval_error")


class ChaosEngine:
    """Engine-like wrapper injecting one replica's scheduled faults.

    Delegates every attribute to the wrapped engine; only `step()` is
    intercepted. The step counter is THIS wrapper's own — faults key on
    how often the scheduler drove this replica, which is deterministic
    under a deterministic scheduler."""

    def __init__(self, inner, plan: FaultPlan, ridx: int):
        self.inner = inner
        self.ridx = ridx
        self.faults = plan.replica(ridx)
        self.step_idx = 0
        self.injected: Dict[str, int] = {"replica_crash": 0,
                                         "slot_stall": 0, "slow_step": 0}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _emit_injected(self, kind: str) -> None:
        """One comp="chaos" instant per fired fault, into the wrapped
        engine's sink — so the trace checker can demand that every
        injected fault surfaces as a well-formed span chain."""
        sink = getattr(self.inner, "trace", None)
        if sink is not None:
            sink.emit("chaos", "injected",
                      src=getattr(self.inner, "trace_src", ""),
                      kind=kind, ridx=self.ridx, step=self.step_idx - 1,
                      inflight=len(getattr(self.inner, "_inflight", ())))

    def _crash(self) -> None:
        """A crash loses the engine's in-flight state: cancel everything
        (slots freed, requests forgotten) before raising — the scheduler
        must notice via the exception and re-queue its placements."""
        for rid in list(getattr(self.inner, "_inflight", {})):
            self.inner.cancel(rid)
        raise InjectedFault(
            f"replica {self.ridx} crash @ step {self.step_idx}")

    def step(self):
        fault = self.faults.at(self.step_idx)
        self.step_idx += 1
        if fault is not None:
            self.injected[fault] += 1
            self._emit_injected(fault)
        if fault == "replica_crash":
            self._crash()
        if fault == "slot_stall":
            return []                     # no progress: triggers hedging
        if fault == "slow_step":
            time.sleep(self.faults.slow_s)
        return self.inner.step()


class ChaosPipeline:
    """Pipeline wrapper injecting retrieval errors by `answer_batch`
    call index (step-indexed, deterministic). Everything else — including
    `slm` and `n_probe`, so RagSession construction works — delegates to
    the wrapped pipeline."""

    def __init__(self, inner, plan: FaultPlan,
                 trace: Optional[object] = None):
        self.inner = inner
        self.errors = plan.retrieval_errors()
        self.calls = 0
        self.injected = 0
        self.trace = trace            # optional shared TraceSink

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def answer_batch(self, queries, **kw):
        idx = self.calls
        self.calls += 1
        if idx in self.errors:
            self.injected += 1
            if self.trace is not None:
                self.trace.emit("chaos", "injected",
                                kind="retrieval_error", call=idx)
            raise InjectedFault(f"retrieval error @ call {idx}")
        return self.inner.answer_batch(queries, **kw)


def wrap_replicas(engines: List, plan: FaultPlan) -> List[ChaosEngine]:
    """Wrap each replica with its own deterministic sub-schedule."""
    return [ChaosEngine(e, plan, i) for i, e in enumerate(engines)]
