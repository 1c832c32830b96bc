"""Per-request span tracing and the SLO admission controller built on it
(the port's copy of `repro.serving.trace`).

One taxonomy for every request-visible state change in the serving
stack, recorded as structured, monotonically-timestamped records in an
OTel-flavoured schema (docs/OBSERVABILITY.md); the port's components
emit the same records as the reference's:

    comp="engine"   queued -> admitted -> prefill_chunk* -> first_token
                    -> token* -> done | shed | cancelled
    comp="session"  queued -> retrieved -> condensed
                    -> done | shed | failed   (+ degraded instants)
    comp="sched"    queued -> placed*/requeue* -> done | shed
                    (+ replica-level hedge/strike/drain/probe/recover)
    comp="pager"    prefix_hit / cow_fork instants + page_stats snapshots
    comp="chaos"    injected (one per fault the harness fired)

Every record carries (seq, ts, comp, src, rid, name, ph, attrs): `seq`
is a sink-assigned monotone sequence number, `ts` a monotone
perf_counter timestamp (clamped so the record stream is ordered even if
the clock hiccups), `src` the emitting component instance (engine
replicas share one sink without rid collisions), `rid` the request id in
the component's namespace (-1 for component-level records), and `ph` the
phase: "I" instant, or "B"/"E" bracketing a span (prefill_chunk,
decode_step, retrieve).

`TraceSink` is a bounded ring buffer (oldest records evicted, counted in
`evicted`) that is exportable to JSONL (`export_jsonl`, read back by
`load_jsonl`) and queryable in-process (`query`, `durations`,
`percentile`). Recording is host-side bookkeeping only, so tokens are
identical with a sink attached or not. `tools/trace_check.py` (stdlib
only) checks an export's lifecycles, spans, terminals and page
accounting.

`SLOController` turns the live trace window into admission decisions:
it estimates a request's end-to-end cost from observed p95 stage costs
(per-query retrieval, prefill chunk, decode step) and plans a degrade
ladder (clamp max_new, shrink retrieve_chunk, reduce n_probe) before
recommending a shed. With no samples yet it always admits. On the card
the port's prefill_chunk span covers the chunk's device work
(serving/engine.py), so the prefill term is the chunk's cost.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional

# Request lifecycle taxonomy. Terminal names are shared by every comp;
# which non-terminal names a comp may emit (and their order) is encoded
# in tools/trace_check.py's per-comp rules.
TERMINALS = ("done", "shed", "failed", "cancelled")


@dataclass
class TraceRecord:
    """One trace record (see module docstring for the schema)."""
    seq: int
    ts: float
    comp: str
    src: str
    rid: int
    name: str
    ph: str = "I"                 # "I" instant | "B" span begin | "E" end
    attrs: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"seq": self.seq, "ts": self.ts, "comp": self.comp,
                "src": self.src, "rid": self.rid, "name": self.name,
                "ph": self.ph, "attrs": self.attrs}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceRecord":
        return cls(int(d["seq"]), float(d["ts"]), d["comp"],
                   d.get("src", ""), int(d.get("rid", -1)), d["name"],
                   d.get("ph", "I"), dict(d.get("attrs") or {}))


class TraceSink:
    """Bounded ring buffer of TraceRecords, shared by every component of
    one serving stack (engines, session, scheduler, chaos wrappers)."""

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        self.capacity = capacity
        self.clock = clock
        self._buf: deque = deque(maxlen=capacity)
        self._seq = 0
        self._last_ts = 0.0
        self.evicted = 0

    def __len__(self) -> int:
        return len(self._buf)

    # ------------------------------------------------------------ record

    def emit(self, comp: str, name: str, rid: int = -1, *, src: str = "",
             ph: str = "I", **attrs) -> TraceRecord:
        """Append one record. Timestamps are clamped monotone so the
        record stream is ordered by (seq, ts) even across clock quirks —
        the invariant tools/trace_check.py verifies first."""
        ts = self.clock()
        if ts < self._last_ts:
            ts = self._last_ts
        self._last_ts = ts
        rec = TraceRecord(self._seq, ts, comp, src, rid, name, ph, attrs)
        self._seq += 1
        if len(self._buf) == self.capacity:
            self.evicted += 1
        self._buf.append(rec)
        return rec

    @contextmanager
    def span(self, comp: str, name: str, rid: int = -1, *, src: str = "",
             **attrs):
        """Bracket a stage with B/E records (one span = one B + one E
        with the same (comp, src, name, rid) key)."""
        self.emit(comp, name, rid, src=src, ph="B", **attrs)
        try:
            yield
        finally:
            self.emit(comp, name, rid, src=src, ph="E")

    # ------------------------------------------------------------- query

    def records(self) -> List[TraceRecord]:
        """Snapshot of the buffer, oldest first."""
        return list(self._buf)

    def query(self, *, comp: Optional[str] = None,
              rid: Optional[int] = None, name: Optional[str] = None,
              src: Optional[str] = None) -> List[TraceRecord]:
        return [r for r in self._buf
                if (comp is None or r.comp == comp)
                and (rid is None or r.rid == rid)
                and (name is None or r.name == name)
                and (src is None or r.src == src)]

    def durations(self, comp: str, name: str, *,
                  window: Optional[int] = None) -> List[float]:
        """Completed span durations for (comp, name), oldest first,
        aggregated across src instances; `window` keeps only the most
        recent N (the "live trace window" the SLO controller reads)."""
        open_b: Dict[tuple, float] = {}
        out: List[float] = []
        for r in self._buf:
            if r.comp != comp or r.name != name:
                continue
            key = (r.src, r.rid)
            if r.ph == "B":
                open_b[key] = r.ts
            elif r.ph == "E" and key in open_b:
                out.append(r.ts - open_b.pop(key))
        return out[-window:] if window else out

    def percentile(self, comp: str, name: str, q: float = 95.0, *,
                   window: int = 256,
                   default: Optional[float] = None) -> Optional[float]:
        """q-th percentile of the last `window` completed (comp, name)
        span durations; `default` when no span completed yet."""
        ds = self.durations(comp, name, window=window)
        if not ds:
            return default
        ds = sorted(ds)
        idx = min(len(ds) - 1, int(round(q / 100.0 * (len(ds) - 1))))
        return ds[idx]

    # ------------------------------------------------------------ export

    def export_jsonl(self, path) -> int:
        """Write the buffer as JSON-lines; returns the record count."""
        recs = self.records()
        with open(path, "w") as f:
            for r in recs:
                f.write(json.dumps(r.to_dict(), default=str) + "\n")
        return len(recs)


def load_jsonl(path) -> List[TraceRecord]:
    """Read a TraceSink JSONL export back into records."""
    out: List[TraceRecord] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(TraceRecord.from_dict(json.loads(line)))
    return out


# --------------------------------------------------------------- SLO plan


@dataclass
class SLOPlan:
    """One admission decision: "admit" unchanged, "degrade" with the
    reduced knobs carried here, or "shed" (even the floor configuration
    cannot meet the budget). `est_s` is the p95-based cost estimate the
    decision was made on (None = no data, always admit)."""
    action: str
    max_new: int
    retrieve_chunk: int
    n_probe: int
    est_s: Optional[float] = None


class SLOController:
    """Plans the degrade-before-shed ladder from live trace p95s.

    Cost model per request, all terms p95 over the last `window`
    completed spans of the shared sink:

        retrieve_per_query = p95(session.retrieve) / mean chunk size
        prefill            = chunks(prompt) * p95(engine.prefill_chunk)
        decode             = max_new * p95(engine.decode_step)

    (one decode step emits one token per active slot, so the per-token
    cost IS the step cost). A missing term (cold window) disables the
    estimate and the plan is "admit" — the controller never sheds on no
    evidence. The ladder, in order: clamp max_new to what fits the
    budget after retrieval+prefill; shrink this step's retrieve_chunk;
    halve n_probe (floor `min_probe`). If the floor configuration
    (1 token, chunk 1, min probes) still exceeds the budget: "shed"."""

    def __init__(self, sink: TraceSink, *, window: int = 128,
                 min_tokens: int = 1, min_chunk: int = 1,
                 min_probe: int = 1):
        self.sink = sink
        self.window = window
        self.min_tokens = min_tokens
        self.min_chunk = min_chunk
        self.min_probe = min_probe

    # ------------------------------------------------------- stage costs

    def stage_costs(self) -> Dict[str, Optional[float]]:
        """p95 cost of each serving stage from the live trace window."""
        s = self.sink
        ret = None
        spans = s.durations("session", "retrieve", window=self.window)
        if spans:
            # retrieve spans carry chunk size in their B record attrs
            ns = [r.attrs.get("n", 1) for r in s.records()
                  if r.comp == "session" and r.name == "retrieve"
                  and r.ph == "B"][-len(spans):]
            per_q = sorted(d / max(int(n), 1) for d, n in zip(spans, ns))
            idx = min(len(per_q) - 1, int(round(0.95 * (len(per_q) - 1))))
            ret = per_q[idx]
        return {
            "retrieve_per_query_s": ret,
            "prefill_chunk_s": s.percentile("engine", "prefill_chunk",
                                            window=self.window),
            "decode_step_s": s.percentile("engine", "decode_step",
                                          window=self.window),
        }

    def estimate(self, max_new: int, *, prompt_chunks: int = 2,
                 costs: Optional[Dict[str, Optional[float]]] = None
                 ) -> Optional[float]:
        """p95-based end-to-end cost of one request, or None while any
        stage has no completed span in the window."""
        c = costs or self.stage_costs()
        ret, pre, dec = (c["retrieve_per_query_s"], c["prefill_chunk_s"],
                         c["decode_step_s"])
        if ret is None or pre is None or dec is None:
            return None
        return ret + prompt_chunks * pre + max_new * dec

    # ------------------------------------------------------------- plan

    def plan(self, budget_s: Optional[float], max_new: int,
             retrieve_chunk: int, n_probe: int, *,
             prompt_chunks: int = 2) -> SLOPlan:
        """Admission decision for one request with `budget_s` seconds of
        deadline budget left (None = unbounded: always admit)."""
        if budget_s is None:
            return SLOPlan("admit", max_new, retrieve_chunk, n_probe)
        costs = self.stage_costs()
        est = self.estimate(max_new, prompt_chunks=prompt_chunks,
                            costs=costs)
        if est is None or est <= budget_s:
            return SLOPlan("admit", max_new, retrieve_chunk, n_probe, est)
        ret, pre, dec = (costs["retrieve_per_query_s"],
                         costs["prefill_chunk_s"], costs["decode_step_s"])
        # ladder step 1: clamp max_new to what fits after retrieve+prefill
        fixed = ret + prompt_chunks * pre
        fit = int((budget_s - fixed) / dec) if dec > 0 else 0
        new_tokens = max(self.min_tokens, min(max_new, fit))
        # ladder steps 2+3: smaller retrieval chunk (this request's chunk
        # waits on fewer co-retrieved queries), fewer probes
        new_chunk = max(self.min_chunk, retrieve_chunk // 2)
        new_probe = max(self.min_probe, n_probe // 2)
        floor = self.estimate(self.min_tokens,
                              prompt_chunks=prompt_chunks, costs=costs)
        if floor is not None and floor > budget_s:
            return SLOPlan("shed", 0, new_chunk, new_probe, floor)
        return SLOPlan("degrade", new_tokens, new_chunk, new_probe, est)
