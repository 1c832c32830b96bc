"""Request schedulers (the port of `repro.serving.scheduler`).

`SlotScheduler` is the request-centric path: N `ContinuousEngine`
replicas, slot admission instead of wave formation (a queued request goes
to the replica with the most free slots; the engines themselves admit on
EOS), and hedging on per-slot stall — a request that stops producing
tokens for `stall_s` while its replica is being stepped is re-submitted to
another replica, first completion wins; the stall budget re-arms after
every hedge, up to `max_hedges` placements per request.

Failure handling is built on the shared `dist.fault.HealthTracker`
strike/drain/probation state machine (the serve-side analogue of the
training-side RestartManager): a replica whose `step()` raises is struck
and its in-flight requests re-queued (an exception leaves engine state
unknown); at `max_strikes` it drains; a drained replica re-enters service
by passing one canary request after a cooldown (exponential backoff per
failed probe), and strikes decay on success so transient errors don't
accumulate into a drain. Requests carry optional deadlines — an expired
request is cancelled (its engine slots freed via `ContinuousEngine.cancel`)
and reported in `shed`, never silently lost — and the queue can be bounded
with a reject-or-degrade overflow policy. Every shed / degrade / failover
decision increments a `SchedCounters` field.

`Scheduler` keeps the legacy wave surface (length-bucketed waves over
engine callables with whole-wave deadline hedging) for generators without
a slot-paged engine.

One deliberate difference from the reference: a kernel fault (a kernel
that does not build or launch, a CUDA error; `ops.is_kernel_fault`) is
never absorbed. Where the reference strikes a replica, drops a failed
cancel or probe, or re-dispatches a failed wave for any exception, a
kernel fault propagates out of `run()` instead: the replicas share one
device, so a fault there is no replica's failure to route around.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from repro_torch.dist.fault import HealthConfig, HealthTracker
from repro_torch.kernels.ops import is_kernel_fault
from repro_torch.serving.trace import TraceSink

_SCHED_SEQ = itertools.count()


@dataclass
class Request:
    """One queued wave-path request (legacy `Scheduler`)."""
    rid: int
    prompt: np.ndarray
    max_new: int = 32
    submitted_s: float = field(default_factory=time.perf_counter)


@dataclass
class Completion:
    """One finished request: decoded tokens, the replica that won (first
    completion wins under hedging) and the submit->done latency."""
    rid: int
    tokens: List[int]
    replica: int
    latency_s: float
    hedged: bool = False


@dataclass
class Shed:
    """One request the scheduler explicitly gave up on (deadline expiry,
    queue overflow, or an engine-side refusal such as an oversize
    prompt). Together with `Completion`s these partition every submitted
    rid: nothing is ever silently lost."""
    rid: int
    reason: str                     # "deadline" | "queue_full" | "oversize"
    latency_s: float


@dataclass
class SchedCounters:
    """Every admission/shed/degrade/failover decision, counted."""
    submitted: int = 0
    completed: int = 0
    shed_deadline: int = 0
    shed_queue: int = 0
    shed_engine: int = 0
    degraded: int = 0
    hedges: int = 0
    strikes: int = 0
    drains: int = 0
    probes: int = 0
    recoveries: int = 0


@dataclass
class ReplicaState:
    """Health bookkeeping for one legacy wave replica. `warmed` marks the
    first successful dispatch: its wall time includes the first call's
    compilation (kernel builds, warm-up), so it is excluded from the
    deadline check (a cold replica must not eat a spurious strike)."""
    healthy: bool = True
    strikes: int = 0
    served: int = 0
    warmed: bool = False


@dataclass
class ReplicaHealth:
    """SlotScheduler-side record for one replica: the shared
    HealthTracker state machine plus served-work and canary bookkeeping
    (`canary` is the scheduler rid probing this replica, if any)."""
    tracker: HealthTracker
    served: int = 0
    canary: Optional[int] = None

    @property
    def healthy(self) -> bool:
        return self.tracker.healthy

    @property
    def strikes(self) -> int:
        return self.tracker.strikes


@dataclass
class _SlotReq:
    """Scheduler-internal request state: per-replica placements (engine
    rids), progress timestamps for stall hedging, deadline, sampling
    mode. `hedges` is the ACTIVE hedge count — reset when the request is
    re-queued by a drain, so a rescued request can hedge again — while
    `ever_hedged` survives for the Completion report."""
    rid: int
    prompt: np.ndarray
    max_new: int
    submitted_s: float
    expires_s: Optional[float] = None
    # engine rid per replica currently decoding this request
    placements: Dict[int, int] = field(default_factory=dict)
    last_progress_s: float = 0.0
    hedges: int = 0
    last_hedge_s: float = 0.0
    ever_hedged: bool = False
    greedy: bool = True
    seed: int = 0


class SlotScheduler:
    """Slot-admission scheduling over ContinuousEngine replicas."""

    def __init__(self, engines: List, *, stall_s: float = 30.0,
                 max_strikes: int = 2, max_queue: Optional[int] = None,
                 overflow: str = "degrade", max_hedges: int = 2,
                 probe_cooldown_s: float = 0.25,
                 max_probes: Optional[int] = 8,
                 deadline_s: Optional[float] = None,
                 trace: Optional[TraceSink] = None):
        """engines: ContinuousEngine-likes (submit/step/available_slots,
        and ideally cancel). `stall_s`: per-slot stall budget — a placed
        request with no new token for this long (while its replica is
        stepped) is hedged to another replica, re-armed after each hedge
        up to `max_hedges`. `max_queue`: admission bound on the queue;
        `overflow="degrade"` halves an overflowing request's `max_new`
        (sheds outright past twice the bound), `overflow="reject"` sheds
        at the bound. `probe_cooldown_s`/`max_probes`: drained-replica
        probation (see dist.fault.HealthTracker). `deadline_s`: default
        per-request deadline (None = unbounded). `trace`: a shared
        TraceSink recording comp="sched" lifecycle + replica events
        (docs/OBSERVABILITY.md)."""
        assert overflow in ("degrade", "reject")
        self.engines = engines
        self.trace = trace
        self.trace_src = f"q{next(_SCHED_SEQ)}"
        hc = HealthConfig(max_strikes=max_strikes,
                          cooldown_s=probe_cooldown_s,
                          max_probes=max_probes)
        self.state = [ReplicaHealth(HealthTracker(hc)) for _ in engines]
        self.stall_s = stall_s
        self.max_queue = max_queue
        self.overflow = overflow
        self.max_hedges = max_hedges
        self.deadline_s = deadline_s
        self.queue: Deque[_SlotReq] = deque()
        self._live: Dict[int, _SlotReq] = {}
        self.shed: List[Shed] = []
        self.counters = SchedCounters()
        self._next_rid = 0

    def _emit(self, name: str, rid: int = -1, **attrs) -> None:
        if self.trace is not None:
            self.trace.emit("sched", name, rid, src=self.trace_src,
                            **attrs)

    def submit(self, prompt: np.ndarray, max_new: int = 32, *,
               greedy: bool = True, seed: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Queue one request; returns its scheduler rid. `deadline_s`
        (default: the scheduler-wide default) bounds submit->done wall
        time — an expired request is cancelled and reported in `shed`.
        When the queue is over `max_queue` the overflow policy applies:
        degrade (halved max_new; shed past 2x the bound) or reject.
        `greedy=False` samples on whichever replica hosts the request
        (per-request PRNG streams key on the ENGINE-assigned rid, so a
        hedged copy may draw a different — equally valid — sample; first
        completion still wins)."""
        rid = self._next_rid
        self._next_rid += 1
        self.counters.submitted += 1
        now = time.perf_counter()
        self._emit("queued", rid, max_new=max_new,
                   prompt_len=len(prompt))
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            if self.overflow == "degrade" \
                    and len(self.queue) < 2 * self.max_queue:
                max_new = max(1, max_new // 2)
                self.counters.degraded += 1
                self._emit("degraded", rid, max_new=max_new)
            else:
                self.counters.shed_queue += 1
                self.shed.append(Shed(rid, "queue_full", 0.0))
                self._emit("shed", rid, reason="queue_full")
                return rid
        if deadline_s is None:
            deadline_s = self.deadline_s
        req = _SlotReq(rid, np.asarray(prompt, np.int32), max_new, now,
                       None if deadline_s is None else now + deadline_s,
                       greedy=greedy, seed=seed)
        self.queue.append(req)
        self._live[rid] = req
        return rid

    def _healthy(self) -> List[int]:
        """Indices of replicas fully in service (probing excluded — they
        carry only their canary until it completes)."""
        return [i for i, s in enumerate(self.state) if s.healthy]

    def _cancel_placement(self, ridx: int, erid: int) -> None:
        """Best-effort engine-side cancel: frees the slot on engines that
        support it; a broken/legacy engine just keeps the stale rid
        (whose events no longer match any placement and are dropped). A
        kernel fault propagates."""
        eng = self.engines[ridx]
        if hasattr(eng, "cancel"):
            try:
                eng.cancel(erid)
            except Exception as e:
                if is_kernel_fault(e):
                    raise

    def _requeue_placements(self, ridx: int) -> None:
        """Pull every request placed on `ridx` back off it (cancelling
        engine-side state best-effort); requests left with no placement
        re-queue at the FRONT with a fresh hedging budget."""
        for req in list(self._live.values()):
            erid = req.placements.pop(ridx, None)
            if erid is None:
                continue
            self._cancel_placement(ridx, erid)
            self._emit("requeue", req.rid, replica=ridx)
            if not req.placements:
                req.hedges = 0
                self.queue.appendleft(req)

    def _strike(self, ridx: int) -> None:
        """One failure strike through the HealthTracker; a drain (at
        max_strikes, or any probe failure) re-queues in-flight work."""
        self.counters.strikes += 1
        self._emit("strike", replica=ridx,
                   strikes=self.state[ridx].strikes + 1)
        h = self.state[ridx]
        if h.tracker.record_failure():
            self.counters.drains += 1
            self._emit("drain", replica=ridx)
            h.canary = None
            self._requeue_placements(ridx)

    def _expire(self, now: float) -> None:
        """Shed every live request past its deadline: cancel its engine
        placements (slots freed), drop it from queue/live, and record the
        shed — expiry is a terminal state, never a silent loss."""
        for req in list(self._live.values()):
            if req.expires_s is None or now <= req.expires_s:
                continue
            for ridx, erid in req.placements.items():
                self._cancel_placement(ridx, erid)
            try:
                self.queue.remove(req)
            except ValueError:
                pass
            del self._live[req.rid]
            self.counters.shed_deadline += 1
            self.shed.append(Shed(req.rid, "deadline",
                                  now - req.submitted_s))
            self._emit("shed", req.rid, reason="deadline")

    def _place(self, req: _SlotReq, ridx: int) -> None:
        """Submit `req` to replica `ridx` and record the placement.
        Sampling kwargs are only forwarded for sampled requests so
        greedy scheduling keeps working against any engine-like with a
        plain `submit(prompt, max_new)` signature."""
        eng = self.engines[ridx]
        if req.greedy:
            erid = eng.submit(req.prompt, req.max_new)
        else:
            erid = eng.submit(req.prompt, req.max_new, greedy=False,
                              seed=req.seed)
        req.placements[ridx] = erid
        req.last_progress_s = time.perf_counter()
        self._emit("placed", req.rid, replica=ridx, erid=erid)

    def _probe(self) -> None:
        """Drained-replica probation: a replica whose cooldown elapsed
        gets ONE canary (the head of the queue) — completing it recovers
        the replica to full service; failing it (step raise, or the
        canary resolving elsewhere) backs the cooldown off."""
        for ridx, h in enumerate(self.state):
            t = h.tracker
            if t.state == HealthTracker.PROBING:
                if h.canary is not None and h.canary not in self._live:
                    # canary completed on another replica or expired:
                    # this probe proved nothing — drain again, back off
                    t.record_failure()
                    h.canary = None
                    self._requeue_placements(ridx)
                continue
            if not self.queue or not t.probe_due():
                continue
            if self.engines[ridx].available_slots() <= 0:
                continue
            t.begin_probe()
            self.counters.probes += 1
            self._emit("probe", replica=ridx)
            req = self.queue.popleft()
            h.canary = req.rid
            try:
                self._place(req, ridx)
            except Exception as e:
                if is_kernel_fault(e):        # the device's, not the probe's
                    raise
                self._strike(ridx)            # probe failed at submit
                req.hedges = 0
                self.queue.appendleft(req)

    def _admit(self) -> None:
        """Queued requests go to the healthy replica with most free slots
        (admission happens slot-by-slot as engines free them on EOS)."""
        while self.queue:
            healthy = [i for i in self._healthy()
                       if self.engines[i].available_slots() > 0]
            if not healthy:
                return
            ridx = max(healthy,
                       key=lambda i: self.engines[i].available_slots())
            self._place(self.queue.popleft(), ridx)

    def _hedge_stalled(self) -> None:
        """Re-place requests with no progress for `stall_s` on another
        replica (first completion wins); the stalled replicas are struck.
        The budget re-arms after every hedge, so a request whose hedge
        target ALSO stalls can hedge again, up to `max_hedges`."""
        now = time.perf_counter()
        for req in list(self._live.values()):
            if not req.placements or req.hedges >= self.max_hedges:
                continue
            if now - max(req.last_progress_s, req.last_hedge_s) \
                    <= self.stall_s:
                continue
            targets = [i for i in self._healthy()
                       if i not in req.placements]
            if not targets:
                continue
            stalled = list(req.placements)
            ridx = max(targets,
                       key=lambda i: self.engines[i].available_slots())
            req.hedges += 1
            req.ever_hedged = True
            req.last_hedge_s = now
            self.counters.hedges += 1
            self._emit("hedge", req.rid, replica=ridx,
                       stalled=list(stalled))
            self._place(req, ridx)
            for s in stalled:
                self._strike(s)

    def _on_done(self, ridx: int, req: _SlotReq, ev,
                 done: List[Completion]) -> None:
        """First completion wins: cancel the other placements (hedges),
        retire the request, credit the replica (strike decay; probation
        canaries recover their replica here)."""
        for oidx, oerid in req.placements.items():
            if oidx != ridx:
                self._cancel_placement(oidx, oerid)
        self._live.pop(req.rid, None)
        h = self.state[ridx]
        h.served += 1
        self.counters.completed += 1
        if h.tracker.record_success():
            self.counters.recoveries += 1
            self._emit("recover", replica=ridx)
        if h.canary == req.rid:
            h.canary = None
        self._emit("done", req.rid, replica=ridx,
                   n_tokens=len(ev.result.tokens),
                   hedged=req.ever_hedged)
        done.append(Completion(req.rid, list(ev.result.tokens), ridx,
                               time.perf_counter() - req.submitted_s,
                               req.ever_hedged))

    def _on_shed(self, ridx: int, req: _SlotReq, ev) -> None:
        """An engine refused this placement (e.g. oversize prompt: its
        pages can never fit the replica's table width). The refusal is
        deterministic across identical replicas, so when no hedged
        placement remains the request is terminally shed — re-queueing
        it would loop forever — and recorded, never silently lost."""
        req.placements.pop(ridx, None)
        if req.placements:
            return                    # a hedged copy may still finish
        self._live.pop(req.rid, None)
        h = self.state[ridx]
        if h.canary == req.rid:       # a shed canary proves liveness too
            h.canary = None
            if h.tracker.record_success():
                self.counters.recoveries += 1
                self._emit("recover", replica=ridx)
        self.counters.shed_engine += 1
        self.shed.append(Shed(req.rid, ev.reason or "engine",
                              time.perf_counter() - req.submitted_s))
        self._emit("shed", req.rid, reason=ev.reason or "engine")

    def _idle(self) -> None:
        """Nothing progressed this pass. Benign while prefill chunks are
        mid-flight or a probe cooldown is pending; fatal when no replica
        can ever serve again or a live request is unreachable."""
        trackers = [h.tracker for h in self.state]
        if all(t.state == HealthTracker.DRAINED for t in trackers):
            if all(t.exhausted for t in trackers):
                raise RuntimeError(
                    "all replicas unhealthy (probe budget exhausted)")
            time.sleep(0.002)                 # wait out a probe cooldown
        elif self._live and not self.queue \
                and not any(r.placements for r in self._live.values()):
            raise RuntimeError("requests stuck with no placement")

    def run(self) -> List[Completion]:
        """Drain the queue; returns completions in finish order. Every
        submitted request ends in exactly one terminal state: a
        Completion here, or an entry in `self.shed` (deadline expiry /
        queue overflow) — chaos may delay requests, never strand them.
        A replica whose step raises is struck, unless the exception is a
        kernel fault, which propagates."""
        done: List[Completion] = []
        while self._live:
            self._expire(time.perf_counter())
            if not self._live:
                break
            self._probe()
            self._admit()
            self._hedge_stalled()
            progressed = False
            for ridx, h in enumerate(self.state):
                if h.tracker.state == HealthTracker.DRAINED:
                    continue
                try:
                    events = self.engines[ridx].step()
                except Exception as e:
                    if is_kernel_fault(e):    # never a strike: propagates
                        raise
                    # an exception mid-step leaves engine state unknown:
                    # strike AND re-queue its placements either way
                    self._strike(ridx)
                    self._requeue_placements(ridx)
                    continue
                for ev in events:
                    req = next((r for r in self._live.values()
                                if r.placements.get(ridx) == ev.rid), None)
                    if req is None:
                        continue          # stale/hedged rid: dropped
                    progressed = True
                    req.last_progress_s = time.perf_counter()
                    if ev.kind == "done":
                        self._on_done(ridx, req, ev, done)
                    elif ev.kind == "shed":
                        self._on_shed(ridx, req, ev)
            if not progressed:
                self._idle()
        return done


class Scheduler:
    """Legacy wave scheduler: length-bucketed waves over engine
    callables with whole-wave deadline/failure hedging — kept for
    generators without a slot-paged engine (see SlotScheduler for the
    request-centric path)."""

    def __init__(self, replicas: List[Callable], *, max_wave: int = 8,
                 deadline_s: float = 60.0, max_strikes: int = 2):
        """replicas: callables (prompts, max_new) -> list of token lists.
        A replica that raises or exceeds the deadline gets a strike —
        except its FIRST successful dispatch, whose wall time includes
        compilation and is exempt from the deadline check. A kernel
        fault raised by a replica propagates out of `run()`."""
        self.replicas = replicas
        self.state = [ReplicaState() for _ in replicas]
        self.max_wave = max_wave
        self.deadline_s = deadline_s
        self.max_strikes = max_strikes
        self.queue: List[Request] = []
        self._next_rid = 0

    def submit(self, prompt: np.ndarray, max_new: int = 32) -> int:
        """Queue one request; returns its rid (wave path is greedy-only —
        it predates per-request PRNG streams)."""
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32), max_new))
        return rid

    def _healthy(self) -> List[int]:
        """Indices of replicas still accepting work."""
        return [i for i, s in enumerate(self.state) if s.healthy]

    def _form_wave(self) -> List[Request]:
        """Take up to max_wave equal-length requests (largest length
        bucket first) off the queue."""
        if not self.queue:
            return []
        # bucket by prompt length; take the largest bucket first
        buckets: Dict[int, List[Request]] = {}
        for r in self.queue:
            buckets.setdefault(len(r.prompt), []).append(r)
        length = max(buckets, key=lambda k: len(buckets[k]))
        wave = buckets[length][: self.max_wave]
        for r in wave:
            self.queue.remove(r)
        return wave

    def _dispatch(self, wave: List[Request], ridx: int,
                  hedged: bool) -> Optional[List[Completion]]:
        """Run one wave on replica `ridx`; None (plus a strike) on
        failure or deadline overrun — the caller re-dispatches. A cold
        replica's first successful dispatch pays compile time, so
        only WARMED replicas can overrun the deadline: strikes reflect
        real overruns, not first-call compilation."""
        t0 = time.perf_counter()
        st = self.state[ridx]
        try:
            outs = self.replicas[ridx]([r.prompt for r in wave],
                                       max(r.max_new for r in wave))
        except Exception as e:
            if is_kernel_fault(e):            # never a strike: propagates
                raise
            st.strikes += 1
            if st.strikes >= self.max_strikes:
                st.healthy = False
            return None
        dt = time.perf_counter() - t0
        if dt > self.deadline_s and st.warmed:
            st.strikes += 1
            if st.strikes >= self.max_strikes:
                st.healthy = False
            return None  # hedge: caller re-dispatches
        st.warmed = True
        st.served += len(wave)
        return [Completion(r.rid, list(o), ridx,
                           time.perf_counter() - r.submitted_s, hedged)
                for r, o in zip(wave, outs)]

    def run(self) -> List[Completion]:
        """Drain the queue wave by wave (round-robin over healthy
        replicas, re-dispatching failed/overdue waves)."""
        done: List[Completion] = []
        rr = 0
        while self.queue:
            wave = self._form_wave()
            if not wave:
                break
            healthy = self._healthy()
            if not healthy:
                raise RuntimeError("all replicas unhealthy")
            tried = []
            completed = None
            hedged = False
            for attempt in range(len(healthy)):
                ridx = healthy[(rr + attempt) % len(healthy)]
                if ridx in tried:
                    continue
                tried.append(ridx)
                completed = self._dispatch(wave, ridx, hedged)
                if completed is not None:
                    break
                hedged = True  # re-dispatch to the next replica
            rr += 1
            if completed is None:
                raise RuntimeError("wave failed on every healthy replica")
            done.extend(completed)
        return done
