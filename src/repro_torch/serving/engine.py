"""Generation engines (the port of `repro.serving.engine`, greedy
decoding): `ContinuousEngine`, continuous batching over a block-table
paged KV pool, and `Engine`, the length-bucketed wave path that is its
`continuous=False` parity baseline and the path of sliding-window
configs.

One global page pool [L, num_pages, page_size, G, dh] holds every slot's
K/V; each slot maps an ordered list of pages through its [W] page-table
row. `submit()` queues a request; each `step()` admits queued prompts
into free slots, advances every admitting slot by one prefill chunk, and
runs one decode step over all decoding slots. Prompts whose prefix is
cached map the shared pages read-only and copy-on-write fork at most one
partially matching page (serving/pager.py). The host-side control flow
is the reference's, line for line, so the same requests get the same
slots, pages and chunk boundaries; the device work goes through
`DenseLM` and its `flash_prefill` and `decode_attention_paged` kernels.

Sampled decoding is not ported: the reference draws from threefry
streams that PyTorch cannot reproduce, so `submit(greedy=False)` raises.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.ref import first_argmax
from repro_torch.models.dense import DenseLM, init_page_pool
from repro_torch.serving.pager import PagePool, PoolStats, PrefixCache
from repro_torch.serving.trace import TraceSink

# engine-instance counter: the `src` tag on trace records
_ENGINE_SEQ = itertools.count()


@dataclass
class GenResult:
    """One finished generation: token ids (including the EOS, if hit),
    the prompt length, and the prefill / decode wall time attributed to
    this request."""
    tokens: List[int]
    prompt_len: int
    prefill_s: float = 0.0          # up to the first token: the TTFT
    decode_s: float = 0.0


@dataclass
class EngineEvent:
    """One request-visible state change: "admitted", "token", "done"
    (`result` set) or "shed" (`reason` set; terminal, no tokens)."""
    rid: int
    kind: str
    token: Optional[int] = None
    result: Optional[GenResult] = None
    reason: Optional[str] = None


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    submitted_s: float
    tokens: List[int] = field(default_factory=list)
    filled: int = 0                  # prefill progress (incl. matched skip)
    matched: int = 0                 # prefix tokens reused from the cache
    slot: int = -1
    pages: List[int] = field(default_factory=list)
    prefill_s: float = 0.0
    decode_s: float = 0.0


class ContinuousEngine:
    """Slot-level continuous batching over a block-table paged KV pool,
    with prefix reuse and oversize shedding as in the reference."""

    # table width beyond ceil(max_len / page_size): a request slightly
    # over budget borrows transiently free pages instead of being shed
    OVERSIZE_PAGES = 2

    def __init__(self, model: DenseLM, *, slots: int = 4,
                 max_len: int = 512, eos_id: int = 2,
                 prefill_chunk: int = 32, page_size: int = 32,
                 trace: Optional[TraceSink] = None):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.prefill_chunk = prefill_chunk
        self.page_size = page_size
        self.trace = trace
        self.trace_src = f"e{next(_ENGINE_SEQ)}"
        self.table_width = -(-max_len // page_size) + self.OVERSIZE_PAGES
        self.num_pages = slots * self.table_width
        self.cache = init_page_pool(self.cfg, self.num_pages, page_size,
                                    device=self.device)
        self.pool = PagePool(self.num_pages)
        self.prefix = PrefixCache(self.pool, page_size)
        # host page table + lazily refreshed device copy
        self._tbl = np.zeros((slots, self.table_width), np.int32)
        self._tbl_dev: Optional[torch.Tensor] = None
        self.pos = np.zeros(slots, np.int32)
        self.last_tok = np.zeros(slots, np.int32)
        self.active = np.zeros(slots, bool)      # decoding (prefill done)
        self._occupant: List[Optional[_Request]] = [None] * slots
        self.queue: Deque[_Request] = deque()
        self._inflight: Dict[int, _Request] = {}
        self._next_rid = 0
        self.steps = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0

    def _table_dev(self) -> torch.Tensor:
        if self._tbl_dev is None:
            if self._tbl.min() < 0 or self._tbl.max() >= self.num_pages:
                raise RuntimeError("page table holds an invalid page id")
            self._tbl_dev = torch.tensor(self._tbl, device=self.device)
        return self._tbl_dev

    # ------------------------------------------------------------ tracing

    def _emit(self, name: str, rid: int = -1, *, comp: str = "engine",
              ph: str = "I", **attrs) -> None:
        if self.trace is not None:
            self.trace.emit(comp, name, rid, src=self.trace_src, ph=ph,
                            **attrs)

    def _trace_page_stats(self) -> None:
        if self.trace is not None:
            st = self.page_stats()
            self.trace.emit("pager", "page_stats", src=self.trace_src,
                            total=st.total, free=st.free,
                            mapped_refs=st.mapped_refs,
                            retained=st.retained,
                            inflight=len(self._inflight))

    # ------------------------------------------------------------- intake

    def submit(self, prompt: np.ndarray, max_new: int = 32,
               rid: Optional[int] = None, *, greedy: bool = True) -> int:
        """Queue one greedy request; returns its rid."""
        if not greedy:
            raise NotImplementedError(
                "sampled decoding is not ported (ROADMAP.md: sampled "
                "decoding); submit greedy requests")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        p = np.asarray(prompt, np.int32).reshape(-1)
        req = _Request(rid, p, max_new, time.perf_counter())
        self.queue.append(req)
        self._inflight[rid] = req
        self._emit("queued", rid, prompt_len=len(p), max_new=max_new,
                   greedy=True)
        return rid

    @property
    def pending(self) -> int:
        """Requests still in flight (queued, prefilling or decoding)."""
        return len(self._inflight)

    def page_stats(self) -> PoolStats:
        return PoolStats(self.pool.num_pages, self.pool.free_count,
                         int(self.pool.refs.sum()),
                         self.prefix.retained_count())

    # ------------------------------------------------------------- stepping

    def _release_pages(self, req: _Request) -> None:
        for pid in req.pages:
            self.pool.decref(pid)
        req.pages = []
        if req.slot >= 0:
            self._tbl[req.slot, :] = 0
            self._tbl_dev = None

    def _finish(self, req: _Request, events: List[EngineEvent]) -> None:
        s = req.slot
        self.active[s] = False
        self._occupant[s] = None
        self._inflight.pop(req.rid, None)
        self._release_pages(req)
        events.append(EngineEvent(req.rid, "done", result=GenResult(
            req.tokens, len(req.prompt), req.prefill_s, req.decode_s)))
        self._emit("done", req.rid, n_tokens=len(req.tokens),
                   prefill_s=req.prefill_s, decode_s=req.decode_s)
        self._trace_page_stats()

    def _emit_token(self, req: _Request, tok: int,
                    events: List[EngineEvent]) -> None:
        req.tokens.append(tok)
        events.append(EngineEvent(req.rid, "token", token=tok))
        self._emit("first_token" if len(req.tokens) == 1 else "token",
                   req.rid, token=tok)
        if tok == self.eos_id or len(req.tokens) >= req.max_new:
            self._finish(req, events)

    def _copy_page(self, src: int, dst: int) -> None:
        for t in self.cache.values():
            t[:, dst] = t[:, src]

    def _map_request(self, req: _Request, s: int) -> str:
        """Map `req`'s pages into slot `s`: "ok", "shed" (can never fit)
        or "wait" (pages free up when a live slot finishes)."""
        plen = len(req.prompt)
        ps = self.page_size
        if plen == 0:
            return "shed"
        need_total = -(-(plen + req.max_new) // ps)
        if need_total > self.table_width:
            return "shed"
        m = self.prefix.match(req.prompt)
        full, cow, matched = m.full, m.cow, m.matched
        # hold the matched pages across eviction/alloc
        for pid in full:
            self.pool.incref(pid)
        if cow:
            self.pool.incref(cow[0])
        fresh = self.pool.alloc(need_total - len(full))
        while fresh is None and self.prefix.evict_one():
            fresh = self.pool.alloc(need_total - len(full))
        if fresh is None:
            for pid in full:
                self.pool.decref(pid)
            if cow:
                self.pool.decref(cow[0])
            if any(r is not None for r in self._occupant):
                return "wait"
            return "shed"
        t0 = time.perf_counter()
        if cow:
            # fork the partially matching page: one page copy, then the
            # resumed prefill overwrites everything past the match point
            self._copy_page(cow[0], fresh[0])
            self.pool.decref(cow[0])
            self._emit("cow_fork", req.rid, comp="pager", src_page=cow[0],
                       dst_page=fresh[0], copy_len=cow[1])
        req.pages = full + fresh
        req.matched = req.filled = matched
        req.prefill_s += time.perf_counter() - t0
        self._tbl[s, :len(req.pages)] = req.pages
        self._tbl[s, len(req.pages):] = 0
        self._tbl_dev = None
        if matched:
            self.prefix_hits += 1
            self.prefix_tokens_reused += matched
            self._emit("prefix_hit", req.rid, comp="pager",
                       matched=matched, full_pages=len(full))
        return "ok"

    def _admit(self, events: List[EngineEvent]) -> None:
        for s in range(self.slots):
            while self._occupant[s] is None and self.queue:
                req = self.queue.popleft()
                st = self._map_request(req, s)
                if st == "wait":
                    self.queue.appendleft(req)
                    return
                if st == "shed":
                    self._inflight.pop(req.rid, None)
                    events.append(EngineEvent(req.rid, "shed",
                                              reason="oversize"))
                    self._emit("shed", req.rid, reason="oversize",
                               prompt_len=len(req.prompt))
                    self._trace_page_stats()
                    continue
                req.slot = s
                self._occupant[s] = req
                self.active[s] = False
                events.append(EngineEvent(req.rid, "admitted"))
                self._emit("admitted", req.rid, slot=s,
                           matched=req.matched, pages=len(req.pages))

    def _prefill_step(self, events: List[EngineEvent]) -> None:
        """Advance every admitting slot by one prompt chunk; a request
        resuming past a matched prefix takes a short first chunk up to
        the next chunk boundary, so later chunks land on the cold grid."""
        c = self.prefill_chunk
        for s in range(self.slots):
            req = self._occupant[s]
            if req is None or self.active[s]:
                continue
            t0 = time.perf_counter()
            end = min(len(req.prompt), (req.filled // c + 1) * c)
            chunk = req.prompt[req.filled:end]
            real = len(chunk)
            if real < c:
                chunk = np.concatenate([chunk, np.zeros(c - real, np.int32)])
            self._emit("prefill_chunk", req.rid, ph="B", slot=s,
                       start=req.filled, n=real)
            logits = self.model.prefill_chunk_paged(
                self.cache,
                torch.tensor(chunk[None].astype(np.int64), device=self.device),
                self._table_dev()[s], req.filled, page_size=self.page_size)
            req.filled += real
            self._emit("prefill_chunk", req.rid, ph="E")
            if req.filled >= len(req.prompt):
                plen = len(req.prompt)
                self.prefix.register(req.prompt,
                                     req.pages[:-(-plen // self.page_size)])
                tok = int(first_argmax(logits[0, real - 1].float()))
                self.pos[s] = plen
                self.last_tok[s] = tok
                self.active[s] = True
                req.prefill_s += time.perf_counter() - t0
                self._emit_token(req, tok, events)
            else:
                # the chunk's work ends inside this step's timing window
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                req.prefill_s += time.perf_counter() - t0

    def _decode_step(self, events: List[EngineEvent]) -> None:
        """One paged decode step over every active slot; greedy tokens
        (first maximum of each logits row) are the only data that reach
        the host."""
        if not self.active.any():
            return
        t0 = time.perf_counter()
        self._emit("decode_step", ph="B", active=int(self.active.sum()))
        dev = self.device
        logits = self.model.decode_step_paged(
            self.cache,
            torch.tensor(self.last_tok[:, None].astype(np.int64), device=dev),
            torch.tensor(self.pos.astype(np.int64), device=dev),
            torch.tensor(self.active, device=dev), self._table_dev(),
            page_size=self.page_size)
        nxt = first_argmax(logits.float(), -1).cpu().numpy()
        dt = time.perf_counter() - t0
        self._emit("decode_step", ph="E")
        self.steps += 1
        for s in range(self.slots):
            if not self.active[s]:
                continue
            req = self._occupant[s]
            req.decode_s += dt
            self.pos[s] += 1
            tok = int(nxt[s])
            self.last_tok[s] = tok
            self._emit_token(req, tok, events)

    def step(self) -> List[EngineEvent]:
        """Admit, advance each admitting slot one prefill chunk, then one
        decode step over all active slots. Returns the events produced."""
        events: List[EngineEvent] = []
        self._admit(events)
        self._prefill_step(events)
        self._decode_step(events)
        return events

    # ----------------------------------------------------------- draining

    def warmup(self) -> None:
        """One tiny request, as the reference's warmup runs (it registers
        the same prefix-cache entry, so later page allocation matches)."""
        self.generate([np.arange(2, dtype=np.int32)], max_new=2)
        self.steps = 0

    def generate(self, prompts: List[np.ndarray],
                 max_new: int = 32) -> List[GenResult]:
        """Submit everything, step until drained; rids are the batch
        indices. Raises RuntimeError if a request is shed (oversize)."""
        if self._inflight:
            raise RuntimeError("generate() on a busy engine")
        rids = [self.submit(p, max_new, rid=i) for i, p in enumerate(prompts)]
        results: Dict[int, GenResult] = {}
        while self._inflight:
            for ev in self.step():
                if ev.kind == "done":
                    results[ev.rid] = ev.result
                elif ev.kind == "shed":
                    raise RuntimeError(
                        f"request {ev.rid} shed: {ev.reason} "
                        f"(prompt + max_new exceed the page budget)")
        return [results[r] for r in rids]


class Engine:
    """Serving engine over one `DenseLM`: `generate()` routes through a
    shared `ContinuousEngine`, or through length-bucketed waves
    (`generate_wave`) when asked with `continuous=False`. A wave prefills its equal-length prompts in one
    full-sequence forward (`flash_prefill`) and decodes them together
    over a contiguous cache (`decode_attention`); a sliding-window cache
    is a ring of window slots. The paged path of sliding-window configs
    is not ported, so they run waves only."""

    def __init__(self, model: DenseLM, *, max_len: int = 512,
                 eos_id: int = 2, prefill_chunk: Optional[int] = None,
                 slots: int = 4, page_size: int = 32):
        """`max_len`: KV budget per request (prompt + generation);
        `slots`, `prefill_chunk` (default 32) and `page_size`: the
        shared ContinuousEngine's."""
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.max_len = max_len
        self.eos_id = eos_id
        self.slots = slots
        self.prefill_chunk = prefill_chunk or 32
        self.page_size = page_size
        self._cont: Dict[int, ContinuousEngine] = {}

    def continuous(self, slots: Optional[int] = None) -> ContinuousEngine:
        """The shared continuous engine over the same model and KV budget
        (one per slot count)."""
        n = slots or self.slots
        if n not in self._cont:
            self._cont[n] = ContinuousEngine(
                self.model, slots=n, max_len=self.max_len,
                eos_id=self.eos_id, prefill_chunk=self.prefill_chunk,
                page_size=self.page_size)
        return self._cont[n]

    def _grow_cache(self, cache: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Prefill sizes the cache to the prompt; decode needs max_len,
        capped at the sliding window: growing a ring past its window
        would change the `pos % len` cursor modulus that the prefill roll
        already baked into the layout."""
        target = self.max_len
        if self.cfg.sliding_window:
            target = min(target, self.cfg.sliding_window)
        grown = {}
        for name, x in cache.items():
            if x.shape[2] < target:
                pad = x.new_zeros(x.shape[:2] + (target - x.shape[2],)
                                  + x.shape[3:])
                x = torch.cat([x, pad], dim=2)
            grown[name] = x
        return grown

    def generate(self, prompts: List[np.ndarray], max_new: int = 32,
                 continuous: Optional[bool] = None) -> List[GenResult]:
        """Greedy generation. `continuous` (None or True) takes the
        continuous engine, as the reference does for every dense config;
        `continuous=False` runs waves of equal-length prompts, shortest
        first. Both give the same tokens. A sliding-window config raises
        unless `continuous=False`."""
        if continuous is None or continuous:
            if self.cfg.sliding_window:
                raise NotImplementedError(
                    "continuous batching of a sliding-window config needs "
                    "ring pages, not ported (ROADMAP.md Queue A 2); pass "
                    "continuous=False")
            return self.continuous().generate(prompts, max_new=max_new)
        buckets: Dict[int, List[int]] = {}
        for i, p in enumerate(prompts):
            buckets.setdefault(len(p), []).append(i)
        results: List[Optional[GenResult]] = [None] * len(prompts)
        for _, idxs in sorted(buckets.items()):
            wave = [prompts[i] for i in idxs]
            for i, r in zip(idxs, self.generate_wave(wave, max_new)):
                results[i] = r
        return results

    def generate_wave(self, prompts: List[np.ndarray],
                      max_new: int = 32) -> List[GenResult]:
        """One wave: prompts are 1-D int token arrays of EQUAL length.
        Every result carries the wave's prefill time (through the first
        token's logits) and its decode time."""
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        if any(len(p) != plen for p in prompts):
            raise ValueError("generate_wave requires equal-length prompts "
                             "(use generate())")
        dev = self.device
        toks = torch.tensor(np.stack([np.asarray(p, np.int64)
                                      for p in prompts]), device=dev)
        t0 = time.perf_counter()
        logits, cache = self.model.prefill(toks)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_prefill = time.perf_counter() - t0
        cache = self._grow_cache(cache)
        outs: List[List[int]] = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        t1 = time.perf_counter()
        for step in range(max_new):
            tok = first_argmax(logits.float(), -1)
            tok_np = tok.cpu().numpy()
            for i in range(b):
                if not done[i]:
                    outs[i].append(int(tok_np[i]))
                    if tok_np[i] == self.eos_id:
                        done[i] = True
            if done.all():
                break
            pos = min(plen + step, self.max_len - 1)
            logits = self.model.decode_step(cache, tok[:, None], pos)
        t_decode = time.perf_counter() - t1
        return [GenResult(outs[i], len(prompts[i]), t_prefill, t_decode)
                for i in range(b)]
