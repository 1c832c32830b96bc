"""HNSW with the paper's update algorithms (the port of
`repro.core.hnsw`, numpy only).

Insertion follows Algorithm 1 (greedy descent -> expandCandidates ->
robustPrune -> connectTwoWay); deletion follows Algorithm 2 (entry-point /
max-level maintenance -> recNeighbors with robust pruning -> physical
removal). It is host-side index maintenance: the device consumes the
graphs' exported vectors (`graph_arrays`) as the EcoVector pack.

The graph makes the reference's decisions in the reference's order: the
same levels from the same `default_rng(seed)`, the same neighbour lists,
the same f32 distances (each a row of one `einsum("nd,nd->n")`).
`robust_prune` differs only in how it finds them: where the reference
measures every candidate against the neighbours chosen so far (one
numpy call a candidate), the port measures each chosen neighbour
against all candidates once (one call a choice) and keeps a mask of the
candidates it blocks. A distance's bits do not depend on which end of
the pair is subtracted, so every comparison sees the reference's value.

External vector ids are remapped to dense internal slots at the API
boundary (`insert`/`delete`/`search`/`reconstruct`/`graph_arrays` speak
external ids; `vectors`, `levels`, `neighbors` and `is_deleted` are
slot-indexed); slots freed by deletion are recycled by later inserts.
"""
from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Set

import numpy as np


class HNSW:
    def __init__(self, dim: int, M: int = 16, ef_construction: int = 100,
                 alpha: float = 1.0, seed: int = 0, max_elements: int = 1024):
        self.dim = dim
        self.M = M
        self.M0 = 2 * M
        self.efc = ef_construction
        self.alpha = alpha
        self.rng = np.random.default_rng(seed)
        self.ml = 1.0 / math.log(M)
        self.vectors = np.zeros((max_elements, dim), np.float32)
        self.levels: Dict[int, int] = {}
        # neighbors[level][node] -> list of node ids (internal slots)
        self.neighbors: List[Dict[int, List[int]]] = [dict()]
        self.is_deleted: Dict[int, bool] = {}
        self.entry_point = -1
        self.max_level = 0
        self._count = 0
        self.n_dist = 0  # distance-computation counter (power model)
        # external id <-> dense internal slot maps (slots index `vectors`)
        self._ext2int: Dict[int, int] = {}
        self._int2ext: List[int] = []
        self._free: List[int] = []       # recycled slots of deleted nodes

    # ------------------------------------------------------------ utils

    def __len__(self):
        return sum(1 for v in self.is_deleted.values() if not v)

    def _dist(self, vid: int, vec: np.ndarray) -> float:
        self.n_dist += 1
        d = self.vectors[vid] - vec
        return float(d @ d)

    def _dists(self, ids: List[int], vec: np.ndarray) -> np.ndarray:
        self.n_dist += len(ids)
        arr = self.vectors[np.asarray(ids, np.int64)]
        diff = arr - vec
        return np.einsum("nd,nd->n", diff, diff)

    def _ensure_capacity(self, vid: int):
        if vid >= self.vectors.shape[0]:
            new = np.zeros((max(vid + 1, 2 * self.vectors.shape[0]),
                            self.dim), np.float32)
            new[: self.vectors.shape[0]] = self.vectors
            self.vectors = new

    def _nbrs(self, vid: int, level: int) -> List[int]:
        if level >= len(self.neighbors):
            return []
        return self.neighbors[level].get(vid, [])

    def _slot_for(self, vid: int) -> int:
        """Resolve (or allocate) the dense internal slot for an external
        id; recycled slots are reused so the arrays stay dense under
        insert/delete churn."""
        slot = self._ext2int.get(vid)
        if slot is not None:
            return slot
        if self._free:
            slot = self._free.pop()
            self.levels.pop(slot, None)   # stale level of the old tenant
            self._int2ext[slot] = vid
        else:
            slot = len(self._int2ext)
            self._int2ext.append(vid)
        self._ext2int[vid] = slot
        return slot

    def reconstruct(self, vid: int) -> np.ndarray:
        return self.vectors[self._ext2int[vid]]

    def get_random_level(self) -> int:
        return int(-math.log(max(self.rng.random(), 1e-12)) * self.ml)

    # ----------------------------------------------------------- search

    def _greedy_descend(self, vec, cur: int, level: int) -> int:
        cur_d = self._dist(cur, vec)
        while True:
            nbrs = [nb for nb in self._nbrs(cur, level)
                    if nb >= 0 and not self.is_deleted.get(nb, False)]
            if not nbrs:
                return cur
            ds = self._dists(nbrs, vec)
            j = int(np.argmin(ds))
            if ds[j] >= cur_d:
                return cur
            cur, cur_d = nbrs[j], float(ds[j])

    def _search_layer(self, vec, entries: List[int], ef: int,
                      level: int) -> List[int]:
        """Beam search on one layer (batched neighbour distances)."""
        visited: Set[int] = set(entries)
        cand = [(self._dist(e, vec), e) for e in entries]
        heapq.heapify(cand)
        best = sorted([(-d, e) for d, e in cand])  # max-heap of results
        heapq.heapify(best)
        while cand:
            d, e = heapq.heappop(cand)
            if best and d > -best[0][0] and len(best) >= ef:
                break
            fresh = [nb for nb in self._nbrs(e, level)
                     if nb >= 0 and nb not in visited]
            if not fresh:
                continue
            visited.update(fresh)
            ds = self._dists(fresh, vec)
            for nb, nd in zip(fresh, ds):
                nd = float(nd)
                if len(best) < ef or nd < -best[0][0]:
                    heapq.heappush(cand, (nd, nb))
                    heapq.heappush(best, (-nd, nb))
                    if len(best) > ef:
                        heapq.heappop(best)
        out = sorted([(-d, e) for d, e in best])
        return [e for _, e in out]

    def expand_candidates(self, cur: int, vec, level: int,
                          ef: int) -> List[int]:
        return self._search_layer(vec, [cur], ef, level)

    def robust_prune(self, cand: List[int], vec, max_m: int) -> List[int]:
        """Select up to max_m diverse neighbours (alpha-pruning heuristic):
        in order of distance to `vec`, a candidate is taken unless a
        neighbour taken before it lies closer to it (times alpha) than
        `vec` does; then the nearest skipped ones fill up to max_m."""
        cand = [c for c in cand if not self.is_deleted.get(c, False)]
        if not cand:
            return []
        dq = self._dists(cand, vec)
        order = np.argsort(dq)
        ordered = [cand[i] for i in order.tolist()]
        dq_ord = dq[order]
        vecs = self.vectors[np.asarray(ordered, np.int64)]
        # open: positions (in `ordered`) of the candidates no choice has
        # blocked yet; the first of them is the next choice
        open_ = np.arange(len(ordered))
        taken: List[int] = []
        while len(taken) < max_m and len(open_):
            i, open_ = open_[0], open_[1:]
            taken.append(int(i))
            diffs = vecs[open_] - vecs[i]
            dd = np.einsum("nd,nd->n", diffs, diffs)
            open_ = open_[~(dd * self.alpha < dq_ord[open_])]
        chosen = [ordered[j] for j in taken]
        # backfill with nearest if diversity pruned too much
        if len(chosen) < max_m:
            for c in ordered:
                if len(chosen) >= max_m:
                    break
                if c not in chosen:
                    chosen.append(c)
        return chosen

    def _connect_two_way(self, vid: int, fnbr: List[int], level: int):
        while level >= len(self.neighbors):
            self.neighbors.append(dict())
        layer = self.neighbors[level]
        layer[vid] = list(fnbr)
        cap = self.M0 if level == 0 else self.M
        for nb in fnbr:
            lst = layer.setdefault(nb, [])
            if vid not in lst:
                lst.append(vid)
            if len(lst) > cap:
                layer[nb] = self.robust_prune(lst, self.vectors[nb], cap)

    # -------------------------------------------------- Algorithm 1: insert

    def insert(self, vid: int, vec: np.ndarray, level: Optional[int] = None):
        slot = self._slot_for(int(vid))
        self._ensure_capacity(slot)
        self.vectors[slot] = vec
        lvl = self.levels.get(slot, 0) if level is None else level
        if lvl <= 0:
            lvl = self.get_random_level()
        self.levels[slot] = lvl
        self.is_deleted[slot] = False
        self._count += 1

        if self.entry_point == -1:
            self.entry_point = slot
            self.max_level = lvl
            for l in range(lvl + 1):
                while l >= len(self.neighbors):
                    self.neighbors.append(dict())
                self.neighbors[l][slot] = []
            return

        cur = self.entry_point
        for l in range(self.max_level, lvl, -1):
            cur = self._greedy_descend(vec, cur, l)
        for l in range(min(lvl, self.max_level), -1, -1):
            cand = self.expand_candidates(cur, vec, l, self.efc)
            max_m = self.M0 if l == 0 else self.M
            fnbr = self.robust_prune(cand, vec, max_m)
            self._connect_two_way(slot, fnbr, l)
            if cand:
                cur = cand[0]
        for l in range(self.max_level + 1, lvl + 1):
            while l >= len(self.neighbors):
                self.neighbors.append(dict())
            self.neighbors[l][slot] = []
        if lvl > self.max_level:
            self.max_level = lvl
            self.entry_point = slot

    # ------------------------------------------------- Algorithm 2: delete

    def _rec_neighbors(self, vid: int, old_neighbors: List[int], level: int):
        """Reconnect the ex-neighbours of a deleted node on one layer."""
        layer = self.neighbors[level]
        alive = [n for n in old_neighbors
                 if not self.is_deleted.get(n, False) and n != vid]
        for n in alive:
            lst = [x for x in layer.get(n, []) if x != vid and
                   not self.is_deleted.get(x, False)]
            # candidate set: existing neighbours + the deleted node's other
            # neighbours (restores connectivity through the hole)
            cand = set(lst)
            cand.update(a for a in alive if a != n)
            cap = self.M0 if level == 0 else self.M
            layer[n] = self.robust_prune(list(cand), self.vectors[n], cap)

    def _check_and_decrease_max_level(self):
        while self.max_level > 0:
            occupied = [v for v, l in self.levels.items()
                        if l >= self.max_level and
                        not self.is_deleted.get(v, False)]
            if occupied:
                break
            self.max_level -= 1
        # keep the entry point consistent
        if self.entry_point != -1 and \
                self.levels.get(self.entry_point, 0) < self.max_level:
            for v, l in self.levels.items():
                if l >= self.max_level and not self.is_deleted.get(v, False):
                    self.entry_point = v
                    break

    def delete(self, vid: int):
        slot = self._ext2int.get(int(vid))
        if slot is None or self.is_deleted.get(slot, True):
            return
        if slot == self.entry_point:
            new_ep, new_max = -1, -1
            for v, l in sorted(self.levels.items(), key=lambda kv: -kv[1]):
                if v != slot and not self.is_deleted.get(v, False):
                    new_ep, new_max = v, l
                    break
            if new_ep == -1:
                self.entry_point = -1
                self.max_level = 0
            else:
                self.entry_point = new_ep
                self.max_level = new_max
        self.is_deleted[slot] = True
        for l in range(len(self.neighbors)):
            layer = self.neighbors[l]
            old = layer.pop(slot, [])
            # robustPrune during connectTwoWay can leave asymmetric edges:
            # also collect nodes that still point at the victim
            incoming = [n for n, lst in layer.items() if slot in lst]
            for n in incoming:
                layer[n] = [x for x in layer[n] if x != slot]
            affected = list(dict.fromkeys(list(old) + incoming))
            if affected:
                self._rec_neighbors(slot, affected, l)
        self._check_and_decrease_max_level()
        del self._ext2int[int(vid)]
        self._free.append(slot)

    # ----------------------------------------------------------- queries

    def search(self, vec: np.ndarray, k: int, ef_search: int = 64):
        if self.entry_point == -1:
            return np.zeros((0,), np.int64), np.zeros((0,), np.float32)
        cur = self.entry_point
        for l in range(self.max_level, 0, -1):
            cur = self._greedy_descend(vec, cur, l)
        cand = self._search_layer(vec, [cur], max(ef_search, k), 0)
        cand = [c for c in cand if not self.is_deleted.get(c, False)][:k]
        return (np.asarray([self._int2ext[c] for c in cand], np.int64),
                self._dists(cand, vec) if cand else np.zeros((0,), np.float32))

    # -------------------------------------------------------- persistence

    SEGMENT_KIND = "hnsw.graph"

    def save(self, path: str) -> None:
        """Persist the whole graph (vectors, levels, neighbours, id maps,
        RNG state) as one checksummed segment, written atomically."""
        from repro_torch.core import store
        store.dump_obj(path, self, kind=self.SEGMENT_KIND)

    @classmethod
    def load(cls, path: str) -> "HNSW":
        """Validated restore of `save()` output: magic, length and CRC are
        checked before any byte reaches pickle; raises
        `store.CorruptSegmentError` on truncation or bit-rot."""
        from repro_torch.core import store
        g = store.load_obj(path, kind=cls.SEGMENT_KIND)
        if not isinstance(g, cls):
            raise store.CorruptSegmentError(
                f"{path}: decoded {type(g).__name__}, not {cls.__name__}")
        return g

    # --------------------------------------------------------- accounting

    def memory_bytes(self) -> int:
        """Vectors + neighbour links (paper Table 1 convention)."""
        n_links = sum(len(lst) for layer in self.neighbors
                      for lst in layer.values())
        n = len(self)
        return n * self.dim * 4 + n_links * 4

    def graph_arrays(self):
        """Export (external) ids and vectors of the live nodes, in slot
        insertion order, for device-side dense scans."""
        slots = [v for v, d in self.is_deleted.items() if not d]
        ids = np.asarray([self._int2ext[s] for s in slots], np.int64)
        return ids, self.vectors[np.asarray(slots, np.int64)]
