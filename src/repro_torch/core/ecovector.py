"""EcoVector (paper §3): the two-tier ANN index, the port of
`repro.core.ecovector`.

  * k-means cluster partitioning (§3.1.1; the `kmeans_assign` kernel),
  * an HNSW over the centroids, held in RAM (§3.1.2),
  * an independent small HNSW per cluster, spilled to disk files and
    loaded and released per query (§3.1.3-3.1.4),
  * host search = centroid k-ANNS -> load n_probe cluster graphs ->
    per-cluster graph search -> merge (§3.2),
  * insert and delete by Algorithms 1 and 2 (§3.3), in the owning
    cluster's graph only.

The device path, `search_device_batched`, routes on the centroids and
scans the padded [NC, CAP, d] cluster pack with the `ecoscan` kernel,
the probes never leaving the device. The pack is built from the
graphs' exported rows (`graph_arrays`) and kept up incrementally: an
update marks its cluster dirty, and the next device query rewrites
that cluster's block in place, growing CAP geometrically on overflow;
the device tensors then take only the rewritten blocks (one indexed
copy), and are uploaded whole only on the first build or a CAP change.
They are copies, never views of the host pack.

Spill files are checksummed segments written atomically
(`core/store.py`). One that fails its checksum at query time is
quarantined: search skips it and widens the probe set, and
`rebuild_cluster` restores it from the rows the pack still held or from
caller-supplied vectors.

Durability, as the reference's: `save()` commits the whole index
(centroids, centroid graph, id maps, every healthy spill file, each
verified on the way) as the next generation of a `store.Journal`; after
it, `insert` / `delete` append their op to the fsync'd write-ahead log
before they apply, and `load()` = the latest generation + WAL replay.
The files are the reference's format, and `load` reads a generation
either package committed (`store.loads` maps the pickled class paths);
the port writes its own HNSW class path, so its spill files and state
record differ from the reference's by that string only.
`core/tiered.py` splits the device pack hot/cold under a budget.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import store
from repro_torch.core.hnsw import HNSW
from repro_torch.core.kmeans import kmeans
from repro_torch.kernels import ops, ref

_CLUSTER_KIND = "ecovector.cluster"
_STATE_KIND = "ecovector.state"


@dataclass
class EcoVectorStats:
    disk_loads: int = 0
    disk_bytes: int = 0
    disk_time_s: float = 0.0
    distance_ops: int = 0
    # device-pack maintenance
    pack_full_builds: int = 0       # whole [NC, CAP, d] rebuilds from disk
    pack_cluster_repacks: int = 0   # single-cluster block rewrites in place
    pack_grows: int = 0             # geometric CAP growths on overflow
    truncated_vectors: int = 0      # rows currently dropped by a forced cap
    # durability
    corrupt_reads: int = 0          # spill-file loads that failed checksums
    quarantined: int = 0            # clusters currently quarantined
    rebuilt: int = 0                # clusters restored (rebuild/auto-heal)
    wal_replayed: int = 0           # mutations replayed by load()
    # tiering (core/tiered.py; zero on an index that is not tiered)
    tier_hot_hits: int = 0          # probes served from the device pack
    tier_cold_hits: int = 0         # probes served from the cold host pack
    promotions: int = 0             # clusters moved cold -> hot
    demotions: int = 0              # clusters moved hot -> cold
    # the device tensors (the port's own counters)
    mirror_uploads: int = 0         # whole-pack uploads
    mirror_blocks: int = 0          # cluster blocks copied in place


class EcoVector:
    # bound on update-path graphs kept resident between an update and the
    # next device query: keeps the partial-loading memory contract (beyond
    # it, a repack reads the eldest from disk again)
    PENDING_GRAPHS_MAX = 8

    def __init__(self, dim: int, n_clusters: int = 64, M: int = 16,
                 ef_construction: int = 100, storage_dir: Optional[str] = None,
                 cache_clusters: int = 0, seed: int = 0, device="cuda"):
        self.dim = dim
        self.n_clusters = n_clusters
        self.M = M
        self.efc = ef_construction
        self.seed = seed
        self.device = resolve_device(device)
        self.storage_dir = storage_dir or tempfile.mkdtemp(prefix="ecovector_")
        os.makedirs(self.storage_dir, exist_ok=True)
        self.centroids: Optional[np.ndarray] = None
        self.centroid_graph: Optional[HNSW] = None
        self.assign: Dict[int, int] = {}          # vid -> cluster
        self.cluster_members: List[List[int]] = []
        self.stats = EcoVectorStats()
        # the build's host seconds by step, and the pack builds' seconds
        self.timings: Dict[str, float] = {}
        # LRU of loaded cluster graphs (off by default: the paper's
        # EcoVector releases each graph after its query)
        self.cache_clusters = cache_clusters
        self._cache: Dict[int, HNSW] = {}         # insertion order == LRU
        self._quarantined: Set[int] = set()       # clusters failing checksums
        self._salvage: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._journal: Optional[store.Journal] = None
        self._persist_root: Optional[str] = None
        self._replaying = False                   # WAL replay: don't re-log
        self._reset_pack_state()

    def _reset_pack_state(self):
        self._device_pack: Optional[Tuple] = None  # (data, lens, slots, cap)
        self._dirty: Set[int] = set()              # clusters needing repack
        self._mirror: Optional[Tuple] = None       # device (data, lens)
        self._mirror_dirty: Set[int] = set()       # blocks stale on device
        self._centroids_dev: Optional[torch.Tensor] = None
        self._pack_forced_cap: Optional[int] = None  # explicit cap budget
        self._trunc_by_cluster: Dict[int, int] = {}  # rows currently dropped
        self._pending_graphs: Dict[int, HNSW] = {}   # dirty graphs in hand

    # ----------------------------------------------------------- build

    def _new_graph(self, c: int, n: int) -> HNSW:
        return HNSW(self.dim, M=self.M, ef_construction=self.efc,
                    seed=self.seed + c, max_elements=max(n, 4))

    def build(self, vectors: np.ndarray, ids: Optional[np.ndarray] = None):
        vectors = np.asarray(vectors, np.float32)
        n = vectors.shape[0]
        ids = np.arange(n, dtype=np.int64) if ids is None else ids
        k = min(self.n_clusters, max(1, n))
        t0 = time.perf_counter()
        self.centroids, assign = kmeans(vectors, k, seed=self.seed,
                                        device=self.device)
        self.n_clusters = self.centroids.shape[0]
        t1 = time.perf_counter()
        self.centroid_graph = HNSW(self.dim, M=self.M,
                                   ef_construction=self.efc, seed=self.seed,
                                   max_elements=self.n_clusters)
        for c in range(self.n_clusters):
            self.centroid_graph.insert(c, self.centroids[c])
        t2 = time.perf_counter()
        # per-cluster graphs, spilled to disk
        self.cluster_members = [[] for _ in range(self.n_clusters)]
        for c in range(self.n_clusters):
            mask = assign == c
            cvids = ids[mask]
            self.cluster_members[c] = list(map(int, cvids))
            g = self._new_graph(c, len(cvids))
            for vid, vec in zip(cvids, vectors[mask]):
                g.insert(int(vid), vec)
                self.assign[int(vid)] = c
            self._store_cluster(c, g)
        self.timings.update(kmeans_s=t1 - t0, centroid_graph_s=t2 - t1,
                            graphs_s=time.perf_counter() - t2)
        self._reset_pack_state()
        return self

    # ------------------------------------------------------ disk tier

    def _path(self, c: int) -> str:
        return os.path.join(self.storage_dir, f"cluster_{c:05d}.bin")

    def _store_cluster(self, c: int, g: HNSW):
        # atomic + checksummed: a crash mid-write leaves the previous
        # spill file intact, never a torn pickle
        store.dump_obj(self._path(c), g, kind=_CLUSTER_KIND)
        self._cache.pop(c, None)

    def _load_cluster(self, c: int) -> HNSW:
        """Load one spill file, validating magic, length and per-record
        CRC32 before any byte reaches pickle. Raises
        `store.CorruptSegmentError` on truncation or bit-rot and for
        clusters already quarantined."""
        if c in self._quarantined:
            raise store.CorruptSegmentError(
                f"cluster {c} is quarantined (failed checksums earlier); "
                f"rebuild_cluster() restores it")
        if c in self._cache:
            g = self._cache.pop(c)           # LRU: most recently used last
            self._cache[c] = g
            return g
        t0 = time.perf_counter()
        g = store.load_obj(self._path(c), kind=_CLUSTER_KIND)
        if not isinstance(g, HNSW):
            raise store.CorruptSegmentError(
                f"{self._path(c)}: decoded {type(g).__name__}, not HNSW")
        self.stats.disk_loads += 1
        self.stats.disk_bytes += os.path.getsize(self._path(c))
        self.stats.disk_time_s += time.perf_counter() - t0
        if self.cache_clusters:
            while len(self._cache) >= self.cache_clusters:
                self._cache.pop(next(iter(self._cache)))  # evict LRU head
            self._cache[c] = g
        return g

    def _load_cluster_checked(self, c: int) -> Optional[HNSW]:
        """Corruption-tolerant load: a cluster failing its checksum is
        healed from an in-hand graph when there is one, else quarantined
        and reported as None so the caller can skip it and widen."""
        if c in self._quarantined:
            return None
        try:
            return self._load_cluster(c)
        except (store.StoreError, OSError, pickle.UnpicklingError,
                EOFError) as e:
            self.stats.corrupt_reads += 1
            pending = self._pending_graphs.get(c)
            if pending is not None:
                # the freshest graph is still in hand from the update
                # path: rewrite the spill file instead of losing data
                self._store_cluster(c, pending)
                self.stats.rebuilt += 1
                return pending
            warnings.warn(f"cluster {c} failed validation ({e}); "
                          f"quarantined: search degrades around it",
                          stacklevel=3)
            self._quarantine(c)
            return None

    def _quarantine(self, c: int):
        """Take a corrupt cluster out of service: salvage the rows the
        pack still holds, drop its members from the bookkeeping, zero its
        pack block so host and device search agree, and move the bad
        file aside."""
        if c in self._quarantined:
            return
        self._quarantined.add(c)
        self._cache.pop(c, None)
        self._pending_graphs.pop(c, None)
        if self._device_pack is not None:
            data, lens, slot_ids, _ = self._device_pack
            m = int(lens[c])
            if m > 0 and c not in self._salvage:
                # pack rows predate the corruption: the rebuild source
                # (stale if c was dirty)
                self._salvage[c] = (slot_ids[c, :m].copy(),
                                    data[c, :m].copy())
            data[c] = 0.0
            slot_ids[c, :] = -1
            lens[c] = 0
            self._mirror_dirty.add(c)
            self._dirty.discard(c)
        for vid in self.cluster_members[c]:
            self.assign.pop(int(vid), None)
        self.cluster_members[c] = []
        self._trunc_by_cluster.pop(c, None)
        if os.path.exists(self._path(c)):
            store.quarantine_file(self._path(c))
        self.stats.quarantined = len(self._quarantined)

    def rebuild_cluster(self, c: int, ids: Optional[np.ndarray] = None,
                        vectors: Optional[np.ndarray] = None) -> int:
        """Restore a quarantined cluster from source vectors: the rows
        salvaged from the pack at quarantine time, or caller-supplied
        (ids, vectors). Returns the number of vectors restored."""
        if ids is None or vectors is None:
            if c not in self._salvage:
                raise store.StoreError(
                    f"cluster {c}: no salvage copy available; pass "
                    f"(ids, vectors) re-derived from the source corpus")
            ids, vectors = self._salvage[c]
        ids = np.asarray(ids, np.int64)
        vectors = np.asarray(vectors, np.float32)
        g = self._new_graph(c, len(ids))
        for vid, vec in zip(ids, vectors):
            g.insert(int(vid), vec)
        self._quarantined.discard(c)
        self.stats.quarantined = len(self._quarantined)
        self._store_cluster(c, g)
        qfile = self._path(c) + ".quarantined"
        if os.path.exists(qfile):
            try:
                os.remove(qfile)
            except OSError:
                pass
        self.cluster_members[c] = list(map(int, ids))
        for vid in ids:
            self.assign[int(vid)] = c
        self._salvage.pop(c, None)
        self._mark_dirty(c, g)
        self.stats.rebuilt += 1
        return len(ids)

    def _release_cluster(self, c: int, g: HNSW, dirty: bool = False):
        if dirty:
            self._store_cluster(c, g)
        # not cached -> dropped: the partial-loading contract

    # ----------------------------------------------------------- search

    def _route(self, q: np.ndarray, n: int) -> List[int]:
        """Ranked centroid ids from the in-RAM graph (distance ops
        counted), quarantined clusters filtered out."""
        n0 = self.centroid_graph.n_dist
        cids, _ = self.centroid_graph.search(q, n, ef_search=max(2 * n, 16))
        self.stats.distance_ops += self.centroid_graph.n_dist - n0
        return [c for c in map(int, cids) if c not in self._quarantined]

    def search(self, q: np.ndarray, k: int = 10, n_probe: int = 4,
               ef_search: int = 32) -> Tuple[np.ndarray, np.ndarray]:
        """Host search: centroid graph -> load clusters -> graph search
        per cluster -> merge -> release.

        A cluster failing its checksum mid-query is quarantined and
        skipped, and the probe set widens to the next-nearest healthy
        centroids, so the query still scans `n_probe` clusters whenever
        enough survive."""
        q = np.asarray(q, np.float32)
        want = min(n_probe, self.n_clusters)
        # over-ask just enough to cover clusters already quarantined
        ask = min(self.n_clusters, want + len(self._quarantined))
        ranked = self._route(q, ask)
        best_ids: List[int] = []
        best_d: List[float] = []
        scanned, i = 0, 0
        while i < len(ranked) and scanned < want:
            c = ranked[i]
            i += 1
            g = self._load_cluster_checked(c)
            if g is None:
                # a fresh quarantine: widen once to the full healthy
                # ranking so the probe budget is still met
                if len(ranked) < self.n_clusters - len(self._quarantined):
                    seen = set(ranked[:i]) | self._quarantined
                    ranked = ranked[:i] + [
                        c2 for c2 in self._route(q, self.n_clusters)
                        if c2 not in seen]
                continue
            n0 = g.n_dist
            ids, dists = g.search(q, k, ef_search=ef_search)
            # per-query delta only: the pickled graph's lifetime counter
            # includes construction-time distances
            self.stats.distance_ops += g.n_dist - n0
            best_ids.extend(map(int, ids))
            best_d.extend(map(float, dists))
            self._release_cluster(c, g)
            scanned += 1
        order = np.argsort(best_d)[:k]
        return (np.asarray([best_ids[i] for i in order], np.int64),
                np.asarray([best_d[i] for i in order], np.float32))

    # ----------------------------------------------------- device path

    def device_pack(self, cap: Optional[int] = None,
                    force_full: bool = False):
        """The padded host pack the ecoscan kernel reads, as (data [NC,
        CAP, d] f32, lens [NC] i32, slot_ids [NC, CAP] i64, cap).

        Kept up incrementally: after insert/delete only the dirty
        clusters' blocks are rewritten in place. A full rebuild happens
        only on the first call, on an explicit `cap` change, or with
        `force_full=True` (with `cap=None` that also lifts a forced cap).

        An explicit `cap` must be positive and is a hard per-cluster row
        budget: clusters beyond it are truncated loudly (a warning and
        `stats.truncated_vectors`), and later repacks keep to it."""
        if cap is not None and cap <= 0:
            raise ValueError(f"device_pack cap must be positive, got {cap} "
                             f"(omit cap for automatic sizing)")
        if (self._device_pack is None or force_full
                or (cap is not None and cap != self._device_pack[3])):
            self._build_pack(cap)
        else:
            if cap is not None:
                # same size as the current pack, but now an explicit budget
                self._pack_forced_cap = cap
            if self._dirty:
                self._repack_dirty()
        return self._device_pack

    def _build_pack(self, cap: Optional[int] = None):
        t0 = time.perf_counter()
        sizes = [len(m) for m in self.cluster_members]
        need = int(np.max(sizes)) if sizes else 0
        auto_cap = cap is None
        cap = cap or max(8, need)
        self._pack_forced_cap = None if auto_cap else cap
        nc = self.n_clusters
        data = np.zeros((nc, cap, self.dim), np.float32)
        slot_ids = -np.ones((nc, cap), np.int64)
        lens = np.zeros((nc,), np.int32)
        self._trunc_by_cluster = {}
        self._pending_graphs.clear()
        for c in range(nc):
            g = self._load_cluster_checked(c)
            if g is None:
                # quarantined (earlier or just now): its block stays empty
                # and search degrades around it
                continue
            ids, vecs = g.graph_arrays()
            m = len(ids)
            if m > cap:
                if auto_cap:
                    # the auto cap is sized from cluster_members: a graph
                    # holding more rows means the two diverged
                    raise RuntimeError(
                        f"cluster {c} graph has {m} rows but "
                        f"cluster_members implies cap {cap}: "
                        f"members/graph bookkeeping diverged")
                self._trunc_by_cluster[c] = m - cap
                warnings.warn(
                    f"device_pack cap={cap} truncates cluster {c} "
                    f"({m - cap} of {m} vectors dropped; recall will "
                    f"suffer; omit cap to size the pack automatically)",
                    stacklevel=3)
                m = cap
            data[c, :m] = vecs[:m]
            slot_ids[c, :m] = ids[:m]
            lens[c] = m
        self.stats.truncated_vectors = sum(self._trunc_by_cluster.values())
        self.stats.pack_full_builds += 1
        self._dirty.clear()
        self._mirror = None
        self._mirror_dirty.clear()
        self._device_pack = (data, lens, slot_ids, cap)
        self.timings["pack_s"] = (self.timings.get("pack_s", 0.0)
                                  + time.perf_counter() - t0)

    def _repack_dirty(self):
        """Rewrite only the dirty clusters' blocks in place. An auto-cap
        pack first grows CAP geometrically if a dirty cluster overflows;
        a forced-cap pack keeps its budget and truncates loudly."""
        data, lens, slot_ids, cap = self._device_pack
        need = max(len(self.cluster_members[c]) for c in self._dirty)
        if need > cap and self._pack_forced_cap is None:
            new_cap = cap
            while new_cap < need:
                new_cap *= 2
            ndata = np.zeros((data.shape[0], new_cap, self.dim), np.float32)
            ndata[:, :cap] = data
            nslots = -np.ones((data.shape[0], new_cap), np.int64)
            nslots[:, :cap] = slot_ids
            data, slot_ids, cap = ndata, nslots, new_cap
            self.stats.pack_grows += 1
            self._mirror = None          # a new shape: upload it whole
            self._mirror_dirty.clear()
        for c in sorted(self._dirty):
            # insert/delete left the freshly stored graph in hand (an
            # emptied graph is falsy through HNSW.__len__: test for None)
            g = self._pending_graphs.pop(c, None)
            if g is None:
                g = self._load_cluster_checked(c)
            if g is None:
                # corrupt mid-repack: _quarantine already zeroed the block
                continue
            ids, vecs = g.graph_arrays()
            m = len(ids)
            self._trunc_by_cluster.pop(c, None)
            if m > cap:
                if self._pack_forced_cap is None:
                    # growth is sized from cluster_members: a bigger graph
                    # means the two diverged
                    raise RuntimeError(
                        f"cluster {c} graph has {m} rows but "
                        f"cluster_members implies cap {cap}: "
                        f"members/graph bookkeeping diverged")
                self._trunc_by_cluster[c] = m - cap
                warnings.warn(
                    f"device_pack cap={cap} truncates cluster {c} on "
                    f"repack ({m - cap} of {m} vectors dropped; use "
                    f"device_pack(force_full=True) without cap to lift "
                    f"the budget)", stacklevel=4)
                m = cap
            data[c, :m] = vecs[:m]
            data[c, m:] = 0.0
            slot_ids[c, :m] = ids[:m]
            slot_ids[c, m:] = -1
            lens[c] = m
            self.stats.pack_cluster_repacks += 1
            self._mirror_dirty.add(c)
        self._dirty.clear()
        self.stats.truncated_vectors = sum(self._trunc_by_cluster.values())
        self._device_pack = (data, lens, slot_ids, cap)

    def device_arrays(self):
        """The pack and centroids on the index's device: (data [NC, CAP,
        d], lens [NC], centroids [NC, d]). After updates only the
        rewritten blocks are copied in place (one indexed copy); the
        pack is uploaded whole on its first build or a CAP change. The
        tensors are copies, never views of the host arrays."""
        data, lens, _, _ = self.device_pack()
        if self._mirror is None or tuple(self._mirror[0].shape) != data.shape:
            self._mirror = (torch.tensor(data, device=self.device),
                            torch.tensor(lens, device=self.device))
            self._mirror_dirty.clear()
            self.stats.mirror_uploads += 1
        elif self._mirror_dirty:
            touched = sorted(self._mirror_dirty)
            mdata, mlens = self._mirror
            mdata[torch.tensor(touched, device=self.device)] = torch.tensor(
                data[touched], device=self.device)
            mlens.copy_(torch.tensor(lens))
            self._mirror_dirty.clear()
            self.stats.mirror_blocks += len(touched)
        if self._centroids_dev is None:
            self._centroids_dev = torch.tensor(
                np.asarray(self.centroids, np.float32), device=self.device)
        return self._mirror[0], self._mirror[1], self._centroids_dev

    def search_device_batched(self, q: np.ndarray, k: int = 10,
                              n_probe: int = 4):
        """Batched search over q [B, d]: centroid routing and the ecoscan
        kernel run back to back on the device, the probes never leave
        it. Returns (ids [B, k] int64, dists [B, k] f32) as numpy."""
        q = np.atleast_2d(np.asarray(q, np.float32))
        if q.shape[0] == 0:
            return (np.zeros((0, k), np.int64), np.zeros((0, k), np.float32))
        n_probe = min(n_probe, self.n_clusters)
        data_t, lens_t, cent_t = self.device_arrays()
        _, lens, slot_ids, _ = self._device_pack
        qt = torch.tensor(q, device=self.device)
        probes = ref.route_topk(qt, cent_t, n_probe)
        dists, slots = ops.ecoscan(qt, data_t, lens_t, probes, k)
        # power-model accounting: dense routing + scanned candidates
        self.stats.distance_ops += q.shape[0] * self.n_clusters
        self.stats.distance_ops += int(lens[probes.cpu().numpy()].sum())
        slots = slots.cpu().numpy()
        ids = np.where(slots >= 0,
                       slot_ids.reshape(-1)[np.clip(slots, 0, None)], -1)
        return ids, dists.cpu().numpy()

    # ----------------------------------------------------------- update

    def _pack_live(self) -> bool:
        """Is there a device layout that insert/delete must keep in step
        (by dirty marks)? The tiered index, whose layout is its own,
        overrides this."""
        return self._device_pack is not None

    def _mark_dirty(self, c: int, g: Optional[HNSW] = None):
        if self._pack_live():
            self._dirty.add(c)
            if g is not None:
                self._pending_graphs.pop(c, None)
                self._pending_graphs[c] = g
                while len(self._pending_graphs) > self.PENDING_GRAPHS_MAX:
                    self._pending_graphs.pop(next(iter(self._pending_graphs)))

    def _wal_append(self, op: tuple):
        """Journal a mutation before it applies: when this returns the op
        is fsync'd and survives kill -9 (load replays it). No-op until
        the index has a persistence root (the first `save()`)."""
        if self._journal is not None and not self._replaying:
            self._journal.append(
                pickle.dumps(op, protocol=pickle.HIGHEST_PROTOCOL))

    def insert(self, vid: int, vec: np.ndarray):
        """§3.3.1: route to the nearest centroid, Algorithm-1 insert into
        that cluster's graph only. The pack is not invalidated: the
        owning cluster is marked dirty and rewritten in place on the next
        device query. With a persistence root the op reaches the WAL
        (fsync'd) before it applies."""
        vec = np.asarray(vec, np.float32)
        self._wal_append(("insert", int(vid), vec.tobytes()))
        cids, _ = self.centroid_graph.search(vec, 1, ef_search=16)
        c = int(cids[0])
        if c in self._quarantined:
            # the owner's graph is lost: restart it from the salvage copy
            # (when there is one) plus this vector
            if c in self._salvage:
                sids, svecs = self._salvage[c]
                keep = sids != int(vid)
                ids = np.concatenate([sids[keep],
                                      np.asarray([int(vid)], np.int64)])
                vecs = np.concatenate([svecs[keep], vec[None]])
            else:
                ids = np.asarray([int(vid)], np.int64)
                vecs = vec[None]
            self.rebuild_cluster(c, ids, vecs)
            return
        g = self._load_cluster(c)
        g.insert(int(vid), vec)
        self.assign[int(vid)] = c
        self.cluster_members[c].append(int(vid))
        self._release_cluster(c, g, dirty=True)
        self._mark_dirty(c, g)

    def delete(self, vid: int):
        """§3.3.2: Algorithm-2 delete inside the owning cluster's graph
        (WAL'd first, like insert)."""
        self._wal_append(("delete", int(vid)))
        c = self.assign.pop(int(vid), None)
        if c is None or c in self._quarantined:
            return                       # unknown, or its data already lost
        g = self._load_cluster(c)
        g.delete(int(vid))
        if int(vid) in self.cluster_members[c]:
            self.cluster_members[c].remove(int(vid))
        self._release_cluster(c, g, dirty=True)
        self._mark_dirty(c, g)

    # ------------------------------------------------------ persistence

    def save(self, root: Optional[str] = None) -> int:
        """Commit the whole index (centroids, centroid graph, id maps,
        every healthy spill file) as the next generation under `root`,
        then rotate the WAL: the compaction step, the journaled
        mutations folded into the snapshot. Later `insert` / `delete`
        are journaled against the new generation. Returns its number."""
        root = root or self._persist_root
        if root is None:
            raise ValueError("save() needs a root directory (none given "
                             "and no previous save to reuse)")
        if self.centroids is None or self.centroid_graph is None:
            raise store.StoreError("save() before build(): nothing to "
                                   "persist yet")
        if self._journal is None or self._journal.root != root:
            self._journal = store.Journal(root)
        tmp = self._journal.begin()
        self._write_state(tmp)
        g = self._journal.commit()
        self._persist_root = root
        return g

    def _write_state(self, d: str):
        # spill files first: verify-on-copy may quarantine a rotten
        # cluster, and state.seg records the quarantine set after it
        for c in range(self.n_clusters):
            if c in self._quarantined:
                continue
            try:
                # bit-rot in a spill file must not reach a snapshot
                blob = store.verify_segment(self._path(c),
                                            kind=_CLUSTER_KIND)
            except (store.StoreError, OSError) as e:
                self.stats.corrupt_reads += 1
                warnings.warn(f"cluster {c} failed validation during "
                              f"save ({e}); quarantined and left out of "
                              f"the snapshot", stacklevel=3)
                self._quarantine(c)
                continue
            with open(os.path.join(d, f"cluster_{c:05d}.bin"), "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
        cent_bytes, cent_spec = store.array_record(
            np.asarray(self.centroids, np.float32))
        state = {
            "dim": self.dim, "n_clusters": self.n_clusters, "M": self.M,
            "ef_construction": self.efc, "seed": self.seed,
            "cache_clusters": self.cache_clusters,
            "assign": {int(k): int(v) for k, v in self.assign.items()},
            "cluster_members": [list(map(int, m))
                                for m in self.cluster_members],
            "quarantined": sorted(self._quarantined),
        }
        store.write_segment(
            os.path.join(d, "state.seg"),
            [pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL),
             cent_bytes,
             pickle.dumps(self.centroid_graph,
                          protocol=pickle.HIGHEST_PROTOCOL)],
            {"centroids": cent_spec}, kind=_STATE_KIND)

    @classmethod
    def load(cls, root: str, storage_dir: Optional[str] = None,
             device="cuda") -> "EcoVector":
        """Restore the latest committed generation (of either package)
        and replay its WAL. The spill files are copied into a fresh
        working `storage_dir` (the generation stays immutable)."""
        j = store.Journal(root)
        g = j.latest()
        if g is None:
            raise FileNotFoundError(f"no committed generation under "
                                    f"{root}")
        meta, recs = j.read_segment(g, "state.seg", _STATE_KIND, 3)
        state = store.loads(recs[0])
        self = cls(state["dim"], n_clusters=state["n_clusters"],
                   M=state["M"], ef_construction=state["ef_construction"],
                   storage_dir=storage_dir, seed=state["seed"],
                   cache_clusters=state["cache_clusters"], device=device)
        self.centroids = store.record_array(recs[1], meta["centroids"])
        self.centroid_graph = store.loads(recs[2])
        if not isinstance(self.centroid_graph, HNSW):
            raise store.CorruptSegmentError(
                f"{root}: generation {g} centroid graph is "
                f"{type(self.centroid_graph).__name__}, not HNSW")
        self.assign = {int(k): int(v) for k, v in state["assign"].items()}
        self.cluster_members = [list(m) for m in state["cluster_members"]]
        self._quarantined = set(state["quarantined"])
        self.stats.quarantined = len(self._quarantined)
        for name in j.manifest(g)["files"]:
            if name.startswith("cluster_"):
                with open(os.path.join(self.storage_dir, name), "wb") as f:
                    f.write(j.read_file(g, name))
        self._journal = j
        self._persist_root = root
        self._restore_extra(j, g)
        self._replay_journal()
        return self

    def _restore_extra(self, j: store.Journal, g: int) -> None:
        """Subclass hook: restore more generation files (the tiered
        index's tier assignment and cold pack) after the core state and
        before the WAL replays, so replayed ops land on that layout."""

    def _replay_journal(self) -> None:
        """Re-apply every acknowledged mutation journaled since the
        loaded generation (a torn tail was never acknowledged)."""
        ops_raw, _torn = self._journal.replay()
        self._replaying = True
        try:
            for raw in ops_raw:
                self._apply_wal(store.loads(raw))
        finally:
            self._replaying = False
        self.stats.wal_replayed = len(ops_raw)

    def _apply_wal(self, op: tuple):
        kind = op[0]
        if kind == "insert":
            _, vid, vec_bytes = op
            self.insert(int(vid), np.frombuffer(vec_bytes, np.float32))
        elif kind == "delete":
            self.delete(int(op[1]))
        else:
            raise store.CorruptSegmentError(
                f"unknown WAL op {kind!r} (journal from a newer version?)")

    # ------------------------------------------------------- accounting

    def ram_bytes(self) -> int:
        """Resident memory: the centroid graph and ids (the paper's Table 1
        EcoVector row: 4*Nc*(d + M'/(1-p0)) + 8N + one loaded inverted
        list), plus what the runtime keeps on top of the paper's model:
        the LRU graph cache, the update path's pending graphs and the
        device tensors."""
        base = self.centroid_graph.memory_bytes() if self.centroid_graph else 0
        ids = 8 * len(self.assign)
        one_list = self.avg_cluster_bytes()
        cached = sum(g.memory_bytes() for g in self._cache.values())
        pending = sum(g.memory_bytes()
                      for c, g in self._pending_graphs.items()
                      if c not in self._cache)
        return (base + ids + one_list + cached + pending
                + self.device_resident_bytes())

    def device_resident_bytes(self) -> int:
        """Bytes of the device tensors (the pack, its lens, the
        centroids); zero until the first device search makes them."""
        tensors = list(self._mirror or ()) + (
            [] if self._centroids_dev is None else [self._centroids_dev])
        return sum(t.numel() * t.element_size() for t in tensors)

    def disk_bytes(self) -> int:
        return sum(os.path.getsize(self._path(c))
                   for c in range(self.n_clusters)
                   if os.path.exists(self._path(c)))

    def avg_cluster_bytes(self) -> int:
        sizes = [os.path.getsize(self._path(c))
                 for c in range(self.n_clusters)
                 if os.path.exists(self._path(c))]
        return int(np.mean(sizes)) if sizes else 0

    def cluster_sizes(self) -> np.ndarray:
        return np.asarray([len(m) for m in self.cluster_members])
