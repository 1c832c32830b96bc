"""Request-centric RAG serving sessions (the port of
`repro.serving.session`).

A `RagSession` runs the full MobileRAG request lifecycle as an event
stream over a `ContinuousEngine`:

    submitted -> retrieved -> condensed -> token ... token -> done

`submit(query)` queues a request and returns its id; every `step()`
(1) retrieves + SCR-condenses up to `retrieve_chunk` queued queries in one
fused batch through the pipeline's `answer_batch`, hands the condensed
prompts to the engine, and (2) advances the engine one continuous-batching
step — so retrieval/SCR for query N+1 runs while query N's slots are still
decoding, instead of the whole batch blocking on the slowest member.
`stream(queries)` wraps submit+step into a generator of `RagEvent`s;
`run(queries)` drains to completed `RAGAnswer`s in submit order.

Robustness (the serve-under-fire contract): requests may carry a
`deadline_s` — an expired request is cancelled (its engine slot freed via
`ContinuousEngine.cancel`) and emits a terminal "shed" event; admission
can be bounded with `max_pending`, and under overload the session degrades
gracefully — smaller retrieval chunks and clamped `max_new` — before it
sheds; a retrieval/embedder exception inside a chunk is retried once
per-query in isolation, and a request that still fails emits a terminal
"failed" event instead of killing the stream. Every shed / degrade /
failure increments a `SessionCounters` field, so every submitted request
ends in exactly one terminal state: done, shed, or failed.

One deliberate difference from the reference: a kernel fault (a kernel
that does not build or launch, a CUDA error; `ops.is_kernel_fault`) is
never absorbed by the retry. It propagates out of `step()`, so a broken
device cannot pass for a failed query.

`greedy=False` samples every request from its own stream
`fold_in(PRNGKey(seed), engine rid)`; the engine rids follow the
reference's numbering (the warmup request first), so a session draws the
reference's tokens.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, Iterator, List, Optional

from repro_torch.kernels.ops import is_kernel_fault
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.trace import SLOController, TraceSink

# request lifecycle states; "done" / "shed" / "failed" are terminal
STATES = ("submitted", "retrieved", "condensed", "decoding",
          "done", "shed", "failed")

_SESSION_SEQ = itertools.count()


@dataclass
class RagRequest:
    """One query's lifecycle record inside a RagSession (state machine
    over `STATES`; `answer` carries the RAGAnswer once condensed and is
    completed in place when decode finishes). `expires_s` is the absolute
    deadline (None = unbounded); `retried` marks the one isolated
    retrieval retry a failing request is entitled to."""
    req_id: int
    query: str
    max_new: int
    state: str = "submitted"
    submitted_s: float = field(default_factory=time.perf_counter)
    expires_s: Optional[float] = None
    done_s: Optional[float] = None
    answer: Optional[object] = None       # RAGAnswer once condensed
    retried: bool = False

    @property
    def latency_s(self) -> Optional[float]:
        """submit -> done wall time (None while still in flight)."""
        return None if self.done_s is None else self.done_s - self.submitted_s


@dataclass
class RagEvent:
    """One request-visible state change. kind: "submitted" | "retrieved"
    (payload: doc id list) | "condensed" (payload: prompt token count) |
    "token" (payload: token id) | "done" (payload: completed RAGAnswer) |
    "shed" (payload: reason — deadline/overload/oversize; terminal) | "failed"
    (payload: repr of the stage error; terminal)."""
    req_id: int
    kind: str
    payload: object = None
    t: float = field(default_factory=time.perf_counter)


@dataclass
class SessionCounters:
    """Every shed/degrade/failure decision the session takes."""
    submitted: int = 0
    completed: int = 0
    shed_deadline: int = 0
    shed_overload: int = 0
    shed_oversize: int = 0
    shed_slo: int = 0
    degraded: int = 0
    degraded_slo: int = 0
    retrieval_retries: int = 0
    failed: int = 0


class RagSession:
    """Streaming session over one RAG pipeline + one ContinuousEngine."""

    def __init__(self, pipe, *, max_new: int = 16, slots: int = 4,
                 retrieve_chunk: int = 4, greedy: bool = True,
                 seed: int = 0, max_pending: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 trace: Optional[TraceSink] = None,
                 slo_s: Optional[float] = None):
        """`pipe`: a RAG pipeline with `slm`/`answer_batch`; `slots`
        picks the sLM's shared continuous engine of that many slots.
        `greedy=False` samples every request from its own
        fold_in(PRNGKey(seed), engine-rid) stream (ContinuousEngine
        semantics: draws are independent of co-resident requests).
        `max_pending` bounds admission: past HALF the bound the session
        degrades (halved retrieve_chunk and max_new); at the bound new
        submissions are shed. `deadline_s` is the default per-request
        deadline. `trace` attaches a shared TraceSink to the session AND
        its engine (comp="session"/"engine"); `slo_s` is the default SLO
        budget per request — with a sink attached, each request is planned
        through `SLOController` (degrade before shed) against the tighter
        of its deadline and its SLO budget. Raises ValueError when the
        pipeline's generation arch has no slot-paged KV path
        (`model.supports_paged`)."""
        self.pipe = pipe
        self.max_new = max_new
        self.retrieve_chunk = retrieve_chunk
        self.greedy = greedy
        self.seed = seed
        self.max_pending = max_pending
        self.deadline_s = deadline_s
        self.counters = SessionCounters()
        if slo_s is not None and trace is None:
            trace = TraceSink()     # SLO control needs a live window
        self.trace = trace
        self.slo_s = slo_s
        self.trace_src = f"s{next(_SESSION_SEQ)}"
        self._slo = SLOController(trace) if trace is not None else None
        slm = pipe.slm
        self.engine: ContinuousEngine = slm.continuous(slots)  # may raise
        if trace is not None:
            self.engine.trace = trace
        self._slm = slm
        self._n_probe0 = getattr(pipe, "n_probe", 4)
        self.requests: Dict[int, RagRequest] = {}
        self._queued: Deque[int] = deque()
        self._decoding: Dict[int, RagRequest] = {}   # engine rid -> request
        self._events_out: List[RagEvent] = []        # submit-time events
        self._next_id = 0
        if not self.engine.pending:
            # compile the chunk-prefill/decode executables off the measured
            # path so the first request's ttft reports execution, not jit
            self.engine.warmup()

    def _emit(self, name: str, rid: int = -1, **attrs) -> None:
        if self.trace is not None:
            self.trace.emit("session", name, rid, src=self.trace_src,
                            **attrs)

    # ------------------------------------------------------------- intake

    @property
    def overloaded(self) -> bool:
        """Past half the admission bound: the degradation ladder engages
        (smaller retrieval chunks, clamped max_new) BEFORE shedding."""
        return (self.max_pending is not None
                and self.pending >= max(1, self.max_pending // 2))

    def submit(self, query: str, max_new: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Queue one query; returns its request id. Retrieval/condense
        happens in a later `step()` (chunked, so it overlaps decode).
        At `max_pending` the request is shed immediately (terminal "shed"
        event on the next step); above half the bound it is admitted
        degraded (halved max_new)."""
        rid = self._next_id
        self._next_id += 1
        self.counters.submitted += 1
        max_new = max_new or self.max_new
        if deadline_s is None:
            deadline_s = self.deadline_s
        now = time.perf_counter()
        req = RagRequest(rid, query, max_new,
                         expires_s=(None if deadline_s is None
                                    else now + deadline_s))
        self.requests[rid] = req
        self._emit("queued", rid, max_new=req.max_new)
        if self.max_pending is not None and self.pending >= self.max_pending:
            req.state = "shed"
            self.counters.shed_overload += 1
            self._events_out.append(RagEvent(rid, "shed", "overload"))
            self._emit("shed", rid, reason="overload")
            return rid
        if self.overloaded:
            req.max_new = max(1, max_new // 2)
            self.counters.degraded += 1
        self._queued.append(rid)
        return rid

    @property
    def pending(self) -> int:
        """Requests not yet terminal (queued for retrieval or decoding)."""
        return len(self._queued) + len(self._decoding)

    # ----------------------------------------------------------- stepping

    def _shed(self, req: RagRequest, reason: str,
              events: List[RagEvent]) -> None:
        req.state = "shed"
        req.done_s = time.perf_counter()
        if reason == "slo":
            self.counters.shed_slo += 1
        else:
            self.counters.shed_deadline += 1
        events.append(RagEvent(req.req_id, "shed", reason))
        self._emit("shed", req.req_id, reason=reason)

    def _expire_step(self, events: List[RagEvent]) -> None:
        """Shed queued and decoding requests past their deadline; a
        decoding request's engine slot is freed via `cancel` so the next
        step can admit fresh work into it."""
        now = time.perf_counter()
        keep: Deque[int] = deque()
        for rid in self._queued:
            req = self.requests[rid]
            if req.expires_s is not None and now > req.expires_s:
                self._shed(req, "deadline", events)
            else:
                keep.append(rid)
        self._queued = keep
        for erid, req in list(self._decoding.items()):
            if req.expires_s is not None and now > req.expires_s:
                self.engine.cancel(erid)
                del self._decoding[erid]
                self._shed(req, "deadline", events)

    def _condense(self, reqs: List[RagRequest]) -> List[Optional[object]]:
        """One fused answer_batch over the chunk; on failure, each query
        is retried ONCE in isolation so a single poisoned query (embedder
        or index raising on it) cannot take the whole chunk down. Returns
        one answer per request, None where the retry failed too (the
        caller emits the terminal "failed" event). A kernel fault is
        re-raised, from the chunk or from a retry: it is not the query's
        failure."""
        try:
            return self.pipe.answer_batch([r.query for r in reqs])
        except Exception as e:
            if is_kernel_fault(e):
                raise
        answers: List[Optional[object]] = []
        for r in reqs:
            try:
                r.retried = True
                self.counters.retrieval_retries += 1
                answers.append(self.pipe.answer_batch([r.query])[0])
            except Exception as e:
                if is_kernel_fault(e):
                    raise
                answers.append(e)
        return answers

    def _budget_s(self, req: RagRequest, now: float) -> Optional[float]:
        """Seconds of budget left: the tighter of the request's deadline
        and its SLO target (None = unbounded)."""
        cands = []
        if req.expires_s is not None:
            cands.append(req.expires_s - now)
        if self.slo_s is not None:
            cands.append(req.submitted_s + self.slo_s - now)
        return min(cands) if cands else None

    def _set_n_probe(self, n: int) -> None:
        """Set the retrieval probe count on the real pipeline: chaos (and
        other) wrappers delegate reads via __getattr__ but a plain setattr
        would land on the wrapper, so walk the `.inner` chain down to the
        object that actually owns the attribute."""
        pipe = self.pipe
        while "n_probe" not in vars(pipe) and \
                getattr(pipe, "inner", None) is not None:
            pipe = pipe.inner
        pipe.n_probe = n

    def _plan_step(self, chunk: int, events: List[RagEvent]) -> tuple:
        """SLO-plan the head of the queue before retrieval: degrade
        (clamp max_new, shrink this chunk, fewer probes) before shedding.
        Returns (chunk, n_probe) for this retrieval round."""
        n_probe = self._n_probe0
        if self._slo is None:
            return chunk, n_probe
        now = time.perf_counter()
        keep: Deque[int] = deque()
        planned = 0
        while self._queued and planned < chunk:
            rid = self._queued.popleft()
            req = self.requests[rid]
            planned += 1
            plan = self._slo.plan(self._budget_s(req, now), req.max_new,
                                  chunk, n_probe)
            if plan.action == "shed":
                self._shed(req, "slo", events)
                continue
            if plan.action == "degrade":
                self.counters.degraded_slo += 1
                self._emit("degraded", rid, max_new=plan.max_new,
                           retrieve_chunk=plan.retrieve_chunk,
                           n_probe=plan.n_probe, est_s=plan.est_s)
                req.max_new = plan.max_new
                chunk = plan.retrieve_chunk
                n_probe = plan.n_probe
            keep.append(rid)
        keep.extend(self._queued)
        self._queued = keep
        return chunk, n_probe

    def _retrieve_step(self, events: List[RagEvent]) -> None:
        """Retrieve + condense the next chunk of queued queries (one fused
        answer_batch call) and admit their prompts to the engine. Under
        overload the chunk shrinks (degradation before shedding); a
        request whose retrieval fails twice emits "failed" and dies alone."""
        chunk = self.retrieve_chunk
        if self.overloaded:
            chunk = max(1, chunk // 2)
        chunk, n_probe = self._plan_step(chunk, events)
        take = [self._queued.popleft()
                for _ in range(min(chunk, len(self._queued)))]
        if not take:
            return
        reqs = [self.requests[r] for r in take]
        if n_probe != self._n_probe0:
            self._set_n_probe(n_probe)
        try:
            if self.trace is not None:
                with self.trace.span("session", "retrieve",
                                     src=self.trace_src, n=len(reqs),
                                     n_probe=n_probe):
                    answers = self._condense(reqs)
            else:
                answers = self._condense(reqs)
        finally:
            if n_probe != self._n_probe0:
                self._set_n_probe(self._n_probe0)
        for req, ans in zip(reqs, answers):
            if ans is None or isinstance(ans, Exception):
                req.state = "failed"
                req.done_s = time.perf_counter()
                self.counters.failed += 1
                events.append(RagEvent(req.req_id, "failed", repr(ans)))
                self._emit("failed", req.req_id, error=repr(ans))
                continue
            req.answer = ans
            req.state = "condensed"
            events.append(RagEvent(req.req_id, "retrieved",
                                   list(ans.doc_ids)))
            events.append(RagEvent(req.req_id, "condensed",
                                   ans.prompt_tokens))
            self._emit("retrieved", req.req_id, docs=len(ans.doc_ids))
            self._emit("condensed", req.req_id,
                       prompt_tokens=ans.prompt_tokens)
            prompt = self._slm.encode_prompt(ans.prompt)
            erid = self.engine.submit(prompt, req.max_new,
                                      greedy=self.greedy, seed=self.seed)
            self._decoding[erid] = req
            req.state = "decoding"

    def _engine_step(self, events: List[RagEvent]) -> None:
        """Advance the ContinuousEngine one step and translate its
        token/done events onto the session's requests."""
        tok = self._slm.tokenizer
        for ev in self.engine.step():
            req = self._decoding.get(ev.rid)
            if req is None:
                continue
            if ev.kind == "token":
                events.append(RagEvent(req.req_id, "token", ev.token))
            elif ev.kind == "shed":
                # engine refused the prompt (oversize: its pages can
                # never fit a slot's table width) — terminal, counted
                del self._decoding[ev.rid]
                req.state = "shed"
                req.done_s = time.perf_counter()
                self.counters.shed_oversize += 1
                events.append(RagEvent(req.req_id, "shed",
                                       ev.reason or "engine"))
                self._emit("shed", req.req_id,
                           reason=ev.reason or "engine")
            elif ev.kind == "done":
                del self._decoding[ev.rid]
                ans = req.answer
                ans.gen_tokens = list(ev.result.tokens)
                ans.generated = tok.decode(
                    [t for t in ev.result.tokens if t != tok.eos_id])
                ans.ttft_measured_s = ev.result.prefill_s
                req.state = "done"
                req.done_s = time.perf_counter()
                self.counters.completed += 1
                events.append(RagEvent(req.req_id, "done", ans))
                self._emit("done", req.req_id,
                           n_tokens=len(ev.result.tokens))

    def step(self) -> List[RagEvent]:
        """Advance the session: flush submit-time events, shed expired
        requests, one retrieval/condense chunk, one engine step. Returns
        the events produced (possibly empty when idle)."""
        events: List[RagEvent] = self._events_out
        self._events_out = []
        self._expire_step(events)
        self._retrieve_step(events)
        self._engine_step(events)
        return events

    # ----------------------------------------------------------- draining

    def stream(self, queries: Iterable[str] = ()) -> Iterator[RagEvent]:
        """Submit `queries`, then yield events until the session drains.
        More queries may be submitted concurrently from the consuming
        loop — the generator keeps stepping while anything is pending."""
        for q in queries:
            yield RagEvent(self.submit(q), "submitted")
        while self.pending or self._events_out:
            yield from self.step()

    def run(self, queries: Iterable[str]) -> List[object]:
        """Drain `queries` to completed RAGAnswers, in submit order (a
        shed or failed request's slot in the list is None)."""
        rids = [self.submit(q) for q in queries]
        while self.pending or self._events_out:
            self.step()
        return [self.requests[r].answer if self.requests[r].state == "done"
                else None for r in rids]
