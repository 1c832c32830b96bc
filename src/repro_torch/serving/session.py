"""Request-centric RAG serving session (the port of
`repro.serving.session.RagSession`, without its degradation ladders).

    submitted -> retrieved -> condensed -> token ... token -> done

`submit(query)` queues a request; every `step()` (1) retrieves and
SCR-condenses up to `RETRIEVE_CHUNK` queued queries in one fused batch
through the pipeline's `answer_batch`, hands the condensed prompts to the
engine, and (2) advances the engine one continuous-batching step, so
retrieval for the next chunk runs while earlier requests decode.

The reference's deadlines, admission bound, SLO planning and per-query
retrieval retry are not ported: a retrieval or kernel fault raises
instead of being absorbed.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, List, Optional

from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.trace import TraceSink

_SESSION_SEQ = itertools.count()


@dataclass
class RagRequest:
    req_id: int
    query: str
    max_new: int
    state: str = "submitted"
    submitted_s: float = field(default_factory=time.perf_counter)
    done_s: Optional[float] = None
    answer: Optional[object] = None       # RAGAnswer once condensed


@dataclass
class RagEvent:
    """One request-visible state change: "retrieved" (doc ids),
    "condensed" (prompt token count), "token" (token id), "done" (the
    completed RAGAnswer) or "shed" (reason; terminal)."""
    req_id: int
    kind: str
    payload: object = None
    t: float = field(default_factory=time.perf_counter)


@dataclass
class SessionCounters:
    submitted: int = 0
    completed: int = 0
    shed_oversize: int = 0


class RagSession:
    """Streaming session over one RAG pipeline + one ContinuousEngine."""

    RETRIEVE_CHUNK = 4        # queries retrieved + condensed per step

    def __init__(self, pipe, *, max_new: int = 16,
                 trace: Optional[TraceSink] = None):
        self.pipe = pipe
        self.max_new = max_new
        self.counters = SessionCounters()
        self.trace = trace
        self.trace_src = f"s{next(_SESSION_SEQ)}"
        self._slm = pipe.slm
        self.engine: ContinuousEngine = self._slm.engine
        if trace is not None:
            self.engine.trace = trace
        self.requests: Dict[int, RagRequest] = {}
        self._queued: Deque[int] = deque()
        self._decoding: Dict[int, RagRequest] = {}   # engine rid -> request
        self._next_id = 0
        if not self.engine.pending:
            self.engine.warmup()

    def _emit(self, name: str, rid: int = -1, **attrs) -> None:
        if self.trace is not None:
            self.trace.emit("session", name, rid, src=self.trace_src,
                            **attrs)

    def submit(self, query: str, max_new: Optional[int] = None) -> int:
        """Queue one query; returns its request id."""
        rid = self._next_id
        self._next_id += 1
        self.counters.submitted += 1
        req = RagRequest(rid, query, max_new or self.max_new)
        self.requests[rid] = req
        self._emit("queued", rid, max_new=req.max_new)
        self._queued.append(rid)
        return rid

    @property
    def pending(self) -> int:
        """Requests not yet terminal (queued for retrieval or decoding)."""
        return len(self._queued) + len(self._decoding)

    def _retrieve_step(self, events: List[RagEvent]) -> None:
        take = [self._queued.popleft()
                for _ in range(min(self.RETRIEVE_CHUNK, len(self._queued)))]
        if not take:
            return
        reqs = [self.requests[r] for r in take]
        if self.trace is not None:
            with self.trace.span("session", "retrieve", src=self.trace_src,
                                 n=len(reqs), n_probe=self.pipe.n_probe):
                answers = self.pipe.answer_batch([r.query for r in reqs])
        else:
            answers = self.pipe.answer_batch([r.query for r in reqs])
        for req, ans in zip(reqs, answers):
            req.answer = ans
            req.state = "condensed"
            events.append(RagEvent(req.req_id, "retrieved",
                                   list(ans.doc_ids)))
            events.append(RagEvent(req.req_id, "condensed",
                                   ans.prompt_tokens))
            self._emit("retrieved", req.req_id, docs=len(ans.doc_ids))
            self._emit("condensed", req.req_id,
                       prompt_tokens=ans.prompt_tokens)
            erid = self.engine.submit(self._slm.encode_prompt(ans.prompt),
                                      req.max_new)
            self._decoding[erid] = req
            req.state = "decoding"

    def _engine_step(self, events: List[RagEvent]) -> None:
        tok = self._slm.tokenizer
        for ev in self.engine.step():
            req = self._decoding.get(ev.rid)
            if req is None:
                continue
            if ev.kind == "token":
                events.append(RagEvent(req.req_id, "token", ev.token))
            elif ev.kind == "shed":
                del self._decoding[ev.rid]
                req.state = "shed"
                req.done_s = time.perf_counter()
                self.counters.shed_oversize += 1
                events.append(RagEvent(req.req_id, "shed", ev.reason))
                self._emit("shed", req.req_id, reason=ev.reason)
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
        """One retrieval/condense chunk, then one engine step."""
        events: List[RagEvent] = []
        self._retrieve_step(events)
        self._engine_step(events)
        return events

    def run(self, queries: Iterable[str]) -> List[object]:
        """Drain `queries` to completed RAGAnswers, in submit order (None
        for a shed request)."""
        rids = [self.submit(q) for q in queries]
        while self.pending:
            self.step()
        return [self.requests[r].answer if self.requests[r].state == "done"
                else None for r in rids]
