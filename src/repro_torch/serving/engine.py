"""Generation engines (the port of `repro.serving.engine`):
`ContinuousEngine`, continuous batching over a block-table paged KV pool,
and `Engine`, the length-bucketed wave path that is its
`continuous=False` parity baseline.

One global page pool [L, num_pages, page_size, G, dh] holds every slot's
K/V (int8 values plus [L, num_pages, page_size, G] f32 scale planes for
`kv_quant` configs); each slot maps an ordered list of pages through its
[W] page-table row. `submit()` queues a request; each `step()` admits
queued prompts into free slots, advances every admitting slot by one
prefill chunk, and runs one decode step over all decoding slots. Prompts
whose prefix is cached map the shared pages read-only and copy-on-write
fork at most one partially matching page (serving/pager.py). A
sliding-window config gives each slot a private ring of
min(window, abs_len) positions over ceil(ring_len / page_size) pages,
with no prefix cache. The host-side control flow is the reference's,
line for line, so the same requests get the same slots, pages and chunk
boundaries; the device work goes through the model (`DenseLM` or
`MoELM`): its prompt chunks attend the slot's pages on
`flash_prefill_paged`, its decode steps on `decode_attention_paged`
(`decode_attention_paged_q8` on an int8 pool). The wave engine's full
prefill stays on `flash_prefill`.

Under a mesh (`dist.sharding.use_mesh`) a wave's rows split over
"batch" (("pod", "data"), as far as they divide), each rank running its
rows through its model (a tensor-parallel part of a dense model built
under the mesh, `models.dense`), and the tokens are gathered, so every
rank returns every request's. The continuous engine serves one device,
as the reference's does: it refuses a tensor-parallel part.

Both greedy and sampled requests run on either engine. A sampled request
draws from its own stream `fold_in(PRNGKey(seed), rid)`, draw t under
`fold_in(stream, t)` with t the tokens it has already emitted (the
wave's step), through `serving/sampling.py`, the port's bit-equal copy of
the reference's threefry draws. So a request's sampled tokens depend
only on (seed, rid, its logits): they are the same whatever else is
co-resident, and the same on waves and on the continuous engine.
Greedy rows take the first maximum of their logits.

`cancel` abandons an in-flight request wherever it is (queued, admitted,
mid-prefill or decoding): its slot and page references are freed at once
and no further events come for it. `clone` makes a replica (the
`SlotScheduler`'s unit of failover) over the same model weights with its
own page pool.

A prompt chunk's trace span ("prefill_chunk", B to E) ends after the
chunk's work on the device: after the synchronize of a non-final chunk,
after the first token's draw of the final one. (The reference closes it
when the chunk is dispatched.) `SLOController` reads these spans as the
cost of a chunk.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.dist.collectives import all_gather_object
from repro_torch.dist.sharding import batch_part, get_mesh
from repro_torch.models.dense import DenseLM, init_page_pool
from repro_torch.models.model import supports_paged
from repro_torch.serving.pager import PagePool, PoolStats, PrefixCache
from repro_torch.serving.sampling import fold_in, prng_key, sample_rows
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
    greedy: bool = True
    # sampled requests only: the stream root fold_in(PRNGKey(seed), rid),
    # int64 [2] on the host; draw t folds in t = len(tokens)
    key: Optional[np.ndarray] = None


def stream_key(seed: int, rid: int) -> np.ndarray:
    """A request's stream root `fold_in(PRNGKey(seed), rid)` (host)."""
    return fold_in(prng_key(seed), rid).numpy()


class ContinuousEngine:
    """Slot-level continuous batching over a block-table paged KV pool,
    with prefix reuse and oversize shedding as in the reference. Raises
    ValueError for a config the paged path does not cover
    (`models.model.supports_paged`)."""

    # table width beyond ceil(max_len / page_size): a request slightly
    # over budget borrows transiently free pages instead of being shed
    OVERSIZE_PAGES = 2

    def __init__(self, model: DenseLM, *, slots: int = 4,
                 max_len: int = 512, eos_id: int = 2,
                 prefill_chunk: int = 32, page_size: int = 32,
                 trace: Optional[TraceSink] = None):
        if not supports_paged(model.cfg):
            raise ValueError(
                f"{model.cfg.name}: config without slot-paged KV support "
                "(use Engine's wave path)")
        if model.tp:
            raise ValueError(f"{model.cfg.name}: the continuous engine "
                             "serves one device, not a tensor-parallel "
                             "part (use Engine's wave path)")
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
        # max_len rounded up to whole chunks: the reference's
        # absolute-position scratch of a ring's chunked prefill; a ring
        # sheds a longer prompt, as the reference does
        self.abs_len = -(-max_len // prefill_chunk) * prefill_chunk
        if self.cfg.sliding_window:
            # a private ring over the window per slot (the wave path's
            # modulus); no prefix sharing
            self.ring_len = min(self.cfg.sliding_window, self.abs_len)
            self.table_width = -(-self.ring_len // page_size)
        else:
            self.ring_len = 0
            self.table_width = (-(-max_len // page_size)
                                + self.OVERSIZE_PAGES)
        self.num_pages = slots * self.table_width
        self.cache = init_page_pool(self.cfg, self.num_pages, page_size,
                                    device=self.device)
        self.pool = PagePool(self.num_pages)
        self.prefix: Optional[PrefixCache] = (
            None if self.ring_len else PrefixCache(self.pool, page_size))
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
        # utilisation and pager counters (decode steps only)
        self.steps = 0
        self.active_slot_steps = 0
        self.cancelled = 0
        self.shed = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0

    def clone(self, *, slots: Optional[int] = None) -> "ContinuousEngine":
        """An independent replica: the same model (its weights are shared,
        not copied) and settings, its own page pool and slot state."""
        return ContinuousEngine(
            self.model, slots=slots or self.slots, max_len=self.max_len,
            eos_id=self.eos_id, prefill_chunk=self.prefill_chunk,
            page_size=self.page_size, trace=self.trace)

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
               rid: Optional[int] = None, *, greedy: bool = True,
               seed: int = 0) -> int:
        """Queue one request; returns its rid. `greedy=False` samples
        from the request's own stream `fold_in(PRNGKey(seed), rid)`: pass
        an explicit `rid` to draw the same tokens across engines and
        runs, whatever else is co-resident."""
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        p = np.asarray(prompt, np.int32).reshape(-1)
        req = _Request(rid, p, max_new, time.perf_counter(), greedy=greedy)
        if not greedy:
            req.key = stream_key(seed, rid)
        self.queue.append(req)
        self._inflight[rid] = req
        self._emit("queued", rid, prompt_len=len(p), max_new=max_new,
                   greedy=greedy)
        return rid

    def _draw(self, req: _Request, row: torch.Tensor) -> int:
        """Next token for `req` from its logits row [V], drawn on the
        row's device: the first maximum, or draw t = len(req.tokens) of
        its stream."""
        key = np.zeros((1, 2), np.int64) if req.key is None else req.key[None]
        return int(sample_rows(row[None], key, [len(req.tokens)],
                               [req.greedy])[0])

    @property
    def pending(self) -> int:
        """Requests still in flight (queued, prefilling or decoding)."""
        return len(self._inflight)

    def free_slots(self) -> int:
        """Slots with no occupant (neither decoding nor admitting)."""
        return sum(1 for r in self._occupant if r is None)

    def available_slots(self) -> int:
        """Admission capacity: free slots less the queued requests (what
        a scheduler looks at)."""
        return self.free_slots() - len(self.queue)

    def page_stats(self) -> PoolStats:
        """Pool occupancy: total and free pages, the live references
        (slot mappings and prefix-cache retentions) and the retentions."""
        retained = self.prefix.retained_count() if self.prefix else 0
        return PoolStats(self.pool.num_pages, self.pool.free_count,
                         int(self.pool.refs.sum()), retained)

    def drop_prefix_cache(self) -> int:
        """Release every prefix-cache retention (pages a live slot maps
        survive until the slot frees them); returns the entries dropped."""
        return self.prefix.drop() if self.prefix else 0

    def cancel(self, rid: int) -> bool:
        """Abandon one in-flight request (a deadline, a superseded hedge,
        a scheduler failover): its slot and page references are freed at
        once, so the next `step()` can admit into them, and no further
        events come for the rid. False when the rid is unknown or
        finished."""
        req = self._inflight.pop(rid, None)
        if req is None:
            return False
        try:
            self.queue.remove(req)
        except ValueError:
            pass
        self._release_pages(req)
        s = req.slot
        if s >= 0 and self._occupant[s] is req:
            self._occupant[s] = None
            self.active[s] = False
        self.cancelled += 1
        self._emit("cancelled", rid, slot=s, n_tokens=len(req.tokens))
        self._trace_page_stats()
        return True

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
        if self.ring_len:
            # a ring wraps, so only the prefill scratch bounds the prompt;
            # every slot maps a full table width of private pages
            if plen > self.abs_len:
                return "shed"
            full: List[int] = []
            cow = None
            matched = 0
            need_total = self.table_width
        else:
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
        while fresh is None and self.prefix and self.prefix.evict_one():
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
                    self.shed += 1
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
                self._table_dev()[s], req.filled, req.filled + real,
                page_size=self.page_size, ring_len=self.ring_len)
            req.filled += real
            if req.filled >= len(req.prompt):
                plen = len(req.prompt)
                if self.prefix is not None:
                    self.prefix.register(
                        req.prompt, req.pages[:-(-plen // self.page_size)])
                tok = self._draw(req, logits[0, real - 1])
                self._emit("prefill_chunk", req.rid, ph="E")
                self.pos[s] = plen
                self.last_tok[s] = tok
                self.active[s] = True
                req.prefill_s += time.perf_counter() - t0
                self._emit_token(req, tok, events)
            else:
                # the chunk's work ends inside this step's timing window
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._emit("prefill_chunk", req.rid, ph="E")
                req.prefill_s += time.perf_counter() - t0

    def _decode_step(self, events: List[EngineEvent]) -> None:
        """One paged decode step over every active slot, then one
        `sample_rows` draw over every slot (greedy rows and sampled rows
        together); only the [slots] tokens reach the host."""
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
            page_size=self.page_size, ring_len=self.ring_len)
        keys = np.zeros((self.slots, 2), np.int64)
        ts = np.zeros(self.slots, np.int64)
        gr = np.ones(self.slots, bool)
        for s in range(self.slots):
            req = self._occupant[s]
            if self.active[s] and not req.greedy:
                keys[s] = req.key
                ts[s] = len(req.tokens)
                gr[s] = False
        nxt = sample_rows(logits, keys, ts, gr).cpu().numpy()
        dt = time.perf_counter() - t0
        self._emit("decode_step", ph="E")
        self.steps += 1
        self.active_slot_steps += int(self.active.sum())
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

    def utilisation(self) -> float:
        """Mean share of slots decoding a step."""
        return self.active_slot_steps / max(self.steps * self.slots, 1)

    # ----------------------------------------------------------- draining

    def warmup(self) -> None:
        """One tiny request, as the reference's warmup runs (it registers
        the same prefix-cache entry, so later page allocation matches)."""
        self.generate([np.arange(2, dtype=np.int32)], max_new=2)
        self.steps = self.active_slot_steps = 0

    def generate(self, prompts: List[np.ndarray], max_new: int = 32,
                 greedy: bool = True, seed: int = 0) -> List[GenResult]:
        """Submit everything, step until drained; rids are the batch
        indices, so the same (prompts, seed) draws the same sampled
        tokens whatever the engine served before. Raises RuntimeError if
        a request is shed (oversize)."""
        if self._inflight:
            raise RuntimeError("generate() on a busy engine")
        rids = [self.submit(p, max_new, rid=i, greedy=greedy, seed=seed)
                for i, p in enumerate(prompts)]
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


def grow_cache(cfg, cache: Dict[str, torch.Tensor], max_len: int
               ) -> Dict[str, torch.Tensor]:
    """A prefill's cache, sized to the prompt, grown for decoding to
    max_len positions, by the reference's rule (`Engine._grow_cache`):
    for the dense, moe and encdec families the K/V planes "k", "v" (and
    an int8 cache's scales "k_s", "v_s") grow along their position axis,
    capped at the sliding window, since growing a ring past its window
    would change the `pos % len` cursor modulus that the prefill roll
    already baked into the layout; an encdec cache's "cross_k",
    "cross_v" (the frames) never grow; the rglru and mamba2 caches are
    returned as they are (fixed-size states, and rings of the prompt's
    min(window, S) slots: ROADMAP F10)."""
    if cfg.family not in ("dense", "moe", "encdec"):
        return cache
    target = max_len
    if cfg.family in ("dense", "moe") and cfg.sliding_window:
        target = min(target, cfg.sliding_window)
    grown = dict(cache)
    for name in ("k", "v", "k_s", "v_s"):
        x = grown.get(name)
        if x is not None and x.shape[2] < target:
            pad = x.new_zeros(x.shape[:2] + (target - x.shape[2],)
                              + x.shape[3:])
            grown[name] = torch.cat([x, pad], dim=2)
    return grown


class Engine:
    """Serving engine over one model of a token-only family (`DenseLM`,
    `MoELM`, `RGLRULM` or `Mamba2LM`): `generate()` routes through a
    shared `ContinuousEngine` when the config supports the paged path,
    or through length-bucketed waves (`generate_wave`) when it does not
    (recurrentgemma, mamba2) or when asked with `continuous=False`. A
    wave prefills its equal-length prompts in one full-sequence forward
    (`flash_prefill` for attention) and decodes them together over the
    model's cache (`decode_attention`, or `decode_attention_q8` on an
    int8 cache; the recurrent states of rglru and mamba2); a
    sliding-window cache is a ring of window slots. Whisper and qwen2-vl
    take frames or patches, which the reference's `Engine` does not pass:
    they are served through their models' `prefill` / `decode_step`, and
    the Engine raises ValueError for them."""

    def __init__(self, model: DenseLM, *, max_len: int = 512,
                 eos_id: int = 2, prefill_chunk: Optional[int] = None,
                 slots: int = 4, page_size: int = 32):
        """`max_len`: KV budget per request (prompt + generation);
        `slots`, `prefill_chunk` (default 32) and `page_size`: the
        shared ContinuousEngine's."""
        if model.cfg.family == "encdec" or model.cfg.modality != "text":
            raise ValueError(f"{model.cfg.name}: the Engine serves token-"
                             "only models (call the model's prefill and "
                             "decode_step)")
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
        return grow_cache(self.cfg, cache, self.max_len)

    def generate(self, prompts: List[np.ndarray], max_new: int = 32,
                 greedy: bool = True, seed: int = 0,
                 continuous: Optional[bool] = None) -> List[GenResult]:
        """`continuous=None` takes the continuous engine when the config
        supports the paged path (`models.model.supports_paged`), as the
        reference routes, and the model is not a tensor-parallel part;
        `continuous=False`
        runs waves of equal-length prompts, shortest first. Both draw a
        sampled request from fold_in(PRNGKey(seed), rid) with rid the
        prompt index, so greedy and sampled tokens are the same on
        both."""
        if continuous is None:
            continuous = supports_paged(self.cfg) and not self.model.tp
        if continuous:
            return self.continuous().generate(prompts, max_new=max_new,
                                              greedy=greedy, seed=seed)
        buckets: Dict[int, List[int]] = {}
        for i, p in enumerate(prompts):
            buckets.setdefault(len(p), []).append(i)
        results: List[Optional[GenResult]] = [None] * len(prompts)
        for _, idxs in sorted(buckets.items()):
            wave = [prompts[i] for i in idxs]
            for i, r in zip(idxs, self.generate_wave(
                    wave, max_new, greedy, seed, rids=idxs)):
                results[i] = r
        return results

    def generate_wave(self, prompts: List[np.ndarray], max_new: int = 32,
                      greedy: bool = True, seed: int = 0,
                      rids: Optional[List[int]] = None) -> List[GenResult]:
        """One wave: prompts are 1-D int token arrays of EQUAL length.
        A sampled request draws step t under fold_in(fold_in(
        PRNGKey(seed), rid), t), as the continuous engine does; `rids`
        defaults to the batch indices. Every result carries the wave's
        prefill time (through the first token's logits) and its decode
        time (this rank's, under a mesh: its rows' part of the wave,
        `dist.sharding.batch_part`)."""
        plen = max(len(p) for p in prompts)
        if any(len(p) != plen for p in prompts):
            raise ValueError("generate_wave requires equal-length prompts "
                             "(use generate())")
        mesh = get_mesh()
        lo, hi, axes = batch_part(mesh, len(prompts))
        rids = list(range(len(prompts)) if rids is None else rids)[lo:hi]
        prompts = prompts[lo:hi]
        b = len(prompts)
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
        gflags = np.full(b, greedy)
        keys = np.zeros((b, 2), np.int64)
        if not greedy:
            keys = np.stack([stream_key(seed, r) for r in rids])
        t1 = time.perf_counter()
        for step in range(max_new):
            tok = sample_rows(logits, keys, np.full(b, step), gflags)
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
        if axes:
            outs = [o for part in all_gather_object(outs, mesh, axes)
                    for o in part]
        return [GenResult(o, plen, t_prefill, t_decode) for o in outs]
