"""Block-table KV pager: refcounted page pool + token-keyed prefix trie
(the port's copy of `repro.serving.pager`).

The ContinuousEngine's KV cache is one global page pool
`[L, num_pages, page_size, G, dh]` (models.dense.init_page_pool); each slot
maps an ordered list of page ids through its `[W]` page-table row. This
module owns the HOST-side bookkeeping for that pool:

`PagePool` — a free list plus per-page refcounts. A page is mapped into
a slot (+1 ref per slot), and may additionally be RETAINED by the prefix
cache (+1 ref); it returns to the free list only when the last reference
drops. Nothing here touches device memory — the engine scatters/gathers
through page ids, so "freeing" a page is pure bookkeeping and its stale
contents are masked (kv_len) until overwritten.

`PrefixCache` — a trie over prompt TOKEN IDS with page-granular edges:
each full-page edge is keyed by the exact tuple of `page_size` tokens it
holds and carries the (immutable, refcounted) page id that backs them.
Leaf nodes can also carry partial-page "tails": a page whose first
`valid` positions hold prompt tokens (its remainder sees the owning
request's decode writes, so only the prompt prefix is trustworthy).

Matching a new prompt walks full-page edges exactly (those pages are
mapped READ-ONLY into the new slot: pure sharing, zero copies), then
looks for the longest common prefix against a tail or a divergent
full-page edge — that page becomes a COPY-ON-WRITE source: the engine
copies it into a fresh page and the new request's prefill resumes at the
first divergent token. The match length is capped at len(prompt) - 1 so
at least one real token always runs through prefill (the first-token
logits come from the last prompt position).

Invariants the engine relies on:
- a page's refcount == (#slots mapping it) + (1 if trie-retained);
- shared (refcount > 1 or retained) pages are never scattered to: all
  writes land at logical positions >= the request's matched length,
  which sit in slot-private (fresh or COW) pages;
- registration never replaces an existing edge's page id (first writer
  wins), so concurrent readers of a shared page never see it swapped;
- eviction (LRU over leaf edges/tails) only drops the TRIE's reference —
  a page still mapped by a live slot survives until that slot frees it.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class PoolStats:
    total: int
    free: int
    mapped_refs: int      # sum of refcounts held by slot mappings + trie
    retained: int         # pages the prefix cache holds a reference on


class PagePool:
    """Free list + refcounts over `num_pages` device pages (host-side
    bookkeeping only; the engine owns the device arrays)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self.refs = np.zeros(num_pages, np.int32)
        self._free: Deque[int] = deque(range(num_pages))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate `n` pages at refcount 1, or None (all-or-nothing) —
        the caller may evict prefix-cache leaves and retry."""
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self.refs[p] = 1
        return pages

    def incref(self, pid: int) -> None:
        assert self.refs[pid] > 0, f"incref on free page {pid}"
        self.refs[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        assert self.refs[pid] > 0, f"decref on free page {pid}"
        self.refs[pid] -= 1
        if self.refs[pid] == 0:
            self._free.append(pid)
            return True
        return False


@dataclass
class _Tail:
    """A partial prompt page: only the first `valid` positions hold
    prompt tokens (the rest sees the owning request's decode writes)."""
    pid: int
    tokens: Tuple[int, ...]     # the `valid` prompt tokens, in order
    last_use: int = 0


@dataclass
class _Node:
    """One trie node; full-page edges keyed by their exact token tuple."""
    children: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)
    pid: int = -1               # page backing the edge INTO this node
    tails: List[_Tail] = field(default_factory=list)
    last_use: int = 0


@dataclass
class PrefixMatch:
    """Result of matching a prompt: `full` pages map read-only into the
    new slot; `cow` (if any) is a (source page id, copy length) pair —
    the source's first `cow[1]` tokens extend the match past the last
    full page and must be copied into a fresh page before the slot may
    write to that region. `matched` = total matched token count
    (== len(full) * page_size + (cow[1] if cow else 0))."""
    full: List[int]
    cow: Optional[Tuple[int, int]]
    matched: int


class PrefixCache:
    """Token-keyed prefix trie over immutable prompt pages."""

    def __init__(self, pool: PagePool, page_size: int, *,
                 max_tails_per_node: int = 4):
        self.pool = pool
        self.ps = page_size
        self.root = _Node()
        self.max_tails = max_tails_per_node
        self._clock = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------- match

    def match(self, prompt: np.ndarray) -> PrefixMatch:
        """Longest cached prefix of `prompt`, capped at len(prompt) - 1."""
        ps = self.ps
        toks = [int(t) for t in prompt]
        plen = len(toks)
        now = self._tick()
        node = self.root
        full: List[int] = []
        consumed = 0
        # full-page walk: only pages whose ENTIRE ps tokens match, and
        # never past the cap (the last prompt token must prefill)
        while consumed + ps <= plen - 1:
            key = tuple(toks[consumed:consumed + ps])
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = now
            full.append(child.pid)
            node = child
            consumed += ps
        # partial extension: longest common prefix against this node's
        # tails and divergent full-page edges -> COW source
        rest = toks[consumed:]
        cap = (plen - 1) - consumed          # max extra tokens matchable
        best_m, best_pid = 0, -1
        for tail in node.tails:
            m = _lcp(rest, tail.tokens, cap)
            if m > best_m:
                best_m, best_pid = m, tail.pid
                tail.last_use = now
        for key, child in node.children.items():
            m = _lcp(rest, key, cap)
            if m > best_m:
                best_m, best_pid = m, child.pid
                child.last_use = now
        cow = (best_pid, best_m) if best_m > 0 else None
        return PrefixMatch(full, cow, consumed + best_m)

    # ---------------------------------------------------------- register

    def register(self, prompt: np.ndarray, pages: List[int]) -> None:
        """Retain `prompt`'s pages after its prefill completed. `pages`
        is the owning slot's mapped page list in logical order; only the
        pages the prompt actually covers are registered (full pages as
        edges, the ragged last page as a tail). Existing edges keep their
        ORIGINAL page id (first writer wins — a duplicate page stays
        slot-private and is freed with its slot); every newly retained
        page gets one trie reference."""
        ps = self.ps
        toks = [int(t) for t in prompt]
        plen = len(toks)
        now = self._tick()
        node = self.root
        nfull = plen // ps
        for i in range(nfull):
            key = tuple(toks[i * ps:(i + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(pid=pages[i])
                node.children[key] = child
                self.pool.incref(pages[i])
            child.last_use = now
            node = child
        rem = plen - nfull * ps
        if rem > 0:
            key = tuple(toks[nfull * ps:])
            for tail in node.tails:
                if tail.tokens == key:
                    tail.last_use = now
                    return
            if len(node.tails) >= self.max_tails:
                oldest = min(node.tails, key=lambda t: t.last_use)
                node.tails.remove(oldest)
                self.pool.decref(oldest.pid)
            node.tails.append(_Tail(pages[nfull], key, now))
            self.pool.incref(pages[nfull])

    # ----------------------------------------------------------- evict

    def evict_one(self) -> bool:
        """Drop the least-recently-used leaf edge or tail (one trie
        reference); returns False when the trie is empty. A page still
        mapped by a live slot keeps its slot references — eviction only
        makes it unavailable to FUTURE prefix matches."""
        best = None          # (last_use, parent, key_or_tail, is_tail)
        stack = [self.root]
        while stack:
            node = stack.pop()
            for tail in node.tails:
                if best is None or tail.last_use < best[0]:
                    best = (tail.last_use, node, tail, True)
            for key, child in node.children.items():
                if not child.children and not child.tails:
                    if best is None or child.last_use < best[0]:
                        best = (child.last_use, node, key, False)
                else:
                    stack.append(child)
        if best is None:
            return False
        _, parent, item, is_tail = best
        if is_tail:
            parent.tails.remove(item)
            self.pool.decref(item.pid)
        else:
            child = parent.children.pop(item)
            self.pool.decref(child.pid)
            for tail in child.tails:      # orphaned tails free with it
                self.pool.decref(tail.pid)
        return True

    def retained_count(self) -> int:
        n = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            n += len(node.tails)
            for child in node.children.values():
                n += 1
                stack.append(child)
        return n


def _lcp(a, b, cap: int) -> int:
    """Length of the longest common prefix of `a` and `b`, capped."""
    n = min(len(a), len(b), cap)
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i
