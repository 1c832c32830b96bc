"""Per-request span tracing (the port's copy of `repro.serving.trace`'s
`TraceSink`; the reference's SLO admission controller is not ported).

One taxonomy for every request-visible state change in the serving
stack, recorded as structured, monotonically-timestamped records in an
OTel-flavoured schema (docs/OBSERVABILITY.md); the port's engine and
session emit the same records as the reference's:

    comp="engine"   queued -> admitted -> prefill_chunk* -> first_token
                    -> token* -> done | shed
    comp="session"  queued -> retrieved -> condensed -> done | shed
    comp="pager"    prefix_hit / cow_fork instants + page_stats snapshots

Every record carries (seq, ts, comp, src, rid, name, ph, attrs): `seq`
is a sink-assigned monotone sequence number, `ts` a monotone
perf_counter timestamp (clamped so the record stream is ordered even if
the clock hiccups), `src` the emitting component instance, `rid` the
request id in the component's namespace (-1 for component-level
records), and `ph` the phase: "I" instant, or "B"/"E" bracketing a span
(prefill_chunk, decode_step, retrieve).

`TraceSink` is a bounded ring buffer (oldest records evicted, counted in
`evicted`), queryable in-process (`query`, `durations`). Recording is
host-side bookkeeping only, so tokens are identical with a sink attached
or not. The reference's JSONL export and percentile queries are not
ported yet.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


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


class TraceSink:
    """Bounded ring buffer of TraceRecords, shared by every component of
    one serving stack (engine, session)."""

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
        the invariant a trace check verifies first."""
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

    def durations(self, comp: str, name: str) -> List[float]:
        """Completed span durations for (comp, name), oldest first,
        aggregated across src instances."""
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
        return out
