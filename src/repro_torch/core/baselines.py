"""The paper's retrieval baselines (§3.4, Tables 1-2, Figures 6-10): IVF,
IVFPQ, HNSW, HNSWPQ, IVF-DISK, IVFPQ-DISK and IVF-HNSW, and EcoVector
through `make_index`; the port of `repro.core.baselines`.

Common interface: build / search / insert / delete / ram_bytes, plus a
`stats` counter of distance ops and disk traffic. The k-means partition
and PQ training run on the port's k-means (`kmeans_assign` kernel); the
ADC of IVFPQ and IVFPQ-DISK runs as one `pq_adc` launch per query, its
sums in the reference's numpy order, so both return the reference's
distances bit for bit. IVFPQ keeps every list's codes in one pack on
the device and hands the probed lists to the launch as segments of it;
IVFPQ-DISK loads the probed lists' files, as the reference does, and
scores their concatenated codes. The graph indexes (HNSW, HNSWPQ's graph
over PQ reconstructions, IVF-HNSW's centroid graph) are the port's numpy
HNSW on the host, as in the reference; so are routing, inverted lists,
exact IVF distances and top-k.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import store
from repro_torch.core.ecovector import EcoVector
from repro_torch.core.hnsw import HNSW
from repro_torch.core.kmeans import kmeans
from repro_torch.core.pq import PQ


@dataclass
class SearchStats:
    distance_ops: int = 0
    disk_loads: int = 0
    disk_bytes: int = 0
    disk_time_s: float = 0.0

    def reset(self):
        self.distance_ops = 0
        self.disk_loads = 0
        self.disk_bytes = 0
        self.disk_time_s = 0.0


def _topk(ids, d2, k):
    order = np.argsort(d2)[:k]
    return ids[order].astype(np.int64), d2[order].astype(np.float32)


def _empty() -> Tuple[np.ndarray, np.ndarray]:
    return np.zeros(0, np.int64), np.zeros(0, np.float32)


class _ClusteredBase:
    """Shared IVF machinery: k-means + inverted lists."""

    def __init__(self, dim, n_clusters=64, seed=0, device="cuda"):
        self.dim = dim
        self.n_clusters = n_clusters
        self.seed = seed
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None
        self.lists: List[np.ndarray] = []      # ids per cluster
        self.stats = SearchStats()

    def _partition(self, vectors, ids):
        self.centroids, assign = kmeans(vectors, min(self.n_clusters,
                                                     len(vectors)),
                                        seed=self.seed, device=self.device)
        self.n_clusters = self.centroids.shape[0]
        self.lists = [ids[assign == c] for c in range(self.n_clusters)]
        return assign

    def _probe(self, q, n_probe):
        d2 = np.sum((self.centroids - q) ** 2, axis=1)
        self.stats.distance_ops += self.n_clusters
        return np.argsort(d2)[:n_probe]

    def _nearest_cluster(self, vec):
        return int(np.argmin(np.sum((self.centroids - vec) ** 2, axis=1)))


class IVF(_ClusteredBase):
    name = "IVF"
    on_disk = False

    def build(self, vectors, ids=None):
        vectors = np.asarray(vectors, np.float32)
        ids = np.arange(len(vectors), dtype=np.int64) if ids is None else ids
        self._partition(vectors, ids)
        self.vecs: Dict[int, np.ndarray] = {int(i): v for i, v in
                                            zip(ids, vectors)}
        return self

    def search(self, q, k=10, n_probe=4, **kw):
        q = np.asarray(q, np.float32)
        probes = self._probe(q, n_probe)
        all_ids, all_d = [], []
        for c in probes:
            ids = self.lists[c]
            if not len(ids):
                continue
            vecs = np.stack([self.vecs[int(i)] for i in ids])
            d2 = np.sum((vecs - q) ** 2, axis=1)
            self.stats.distance_ops += len(ids)
            all_ids.append(ids)
            all_d.append(d2)
        if not all_ids:
            return _empty()
        return _topk(np.concatenate(all_ids), np.concatenate(all_d), k)

    def insert(self, vid, vec):
        c = self._nearest_cluster(vec)
        self.lists[c] = np.append(self.lists[c], vid)
        self.vecs[int(vid)] = np.asarray(vec, np.float32)

    def delete(self, vid):
        for c in range(self.n_clusters):
            m = self.lists[c] != vid
            if m.sum() != len(self.lists[c]):
                self.lists[c] = self.lists[c][m]
        self.vecs.pop(int(vid), None)

    def ram_bytes(self):
        n = len(self.vecs)
        return (self.n_clusters * self.dim * 4 + n * 8 + n * self.dim * 4)


class IVFPQ(IVF):
    name = "IVFPQ"

    def __init__(self, dim, n_clusters=64, m_pq=8, nbits=8, seed=0,
                 device="cuda"):
        super().__init__(dim, n_clusters, seed, device)
        self.pq = PQ(dim, m_pq, nbits, device=self.device)

    def build(self, vectors, ids=None):
        vectors = np.asarray(vectors, np.float32)
        ids = np.arange(len(vectors), dtype=np.int64) if ids is None else ids
        assign = self._partition(vectors, ids)
        self.pq.train(vectors[np.random.default_rng(0).choice(
            len(vectors), min(len(vectors), 4096), replace=False)])
        codes = self.pq.encode(vectors)
        self.codes: Dict[int, np.ndarray] = {
            int(i): c for i, c in zip(ids, codes)}
        self._set_pack(codes[np.argsort(assign, kind="stable")])
        return self

    def _set_pack(self, packed: np.ndarray):
        """Keep packed [N, m] uint8, every list's codes in list order and
        each list's id order, on the PQ's device as `pack`, with the list
        offsets `pack_offsets` [n_lists + 1] on the host: list c is the
        pack rows pack_offsets[c] .. pack_offsets[c + 1] - 1."""
        self.pack = torch.tensor(packed, device=self.pq.device)
        self.pack_offsets = np.concatenate(
            [[0], np.cumsum([len(l) for l in self.lists])]).astype(np.int64)
        self._pack_stale = False

    def _fresh_pack(self):
        """Rebuild the pack from `codes` and `lists` after an update."""
        if self._pack_stale:
            ids = [int(i) for l in self.lists for i in l]
            self._set_pack(np.stack([self.codes[i] for i in ids]) if ids
                           else np.zeros((0, self.pq.m), np.uint8))

    def _list_codes(self, c) -> Tuple[np.ndarray, np.ndarray]:
        ids = self.lists[c]
        codes = (np.stack([self.codes[int(i)] for i in ids]) if len(ids)
                 else np.zeros((0, self.pq.m), np.uint8))
        return ids, codes

    def probed_codes(self, q, n_probe) -> Tuple[np.ndarray, np.ndarray]:
        """Route q and stack the ids [N] and codes [N, m] of its probed
        lists in probe order (what `search` scores)."""
        probes = self._probe(np.asarray(q, np.float32), n_probe)
        all_ids, all_codes = [], []
        for c in probes:
            ids, codes = self._list_codes(int(c))
            if not len(ids):
                continue
            self.stats.distance_ops += len(ids)
            all_ids.append(ids)
            all_codes.append(codes)
        if not all_ids:
            return np.zeros(0, np.int64), np.zeros((0, self.pq.m), np.uint8)
        return np.concatenate(all_ids), np.concatenate(all_codes)

    def search(self, q, k=10, n_probe=4, **kw):
        """Route on the host; one `pq_adc` launch scores the probed lists
        as segments of the device pack, in probe order."""
        q = np.asarray(q, np.float32)
        probes = self._probe(q, n_probe)
        self._fresh_pack()
        starts = self.pack_offsets[probes]
        lens = self.pack_offsets[probes + 1] - starts
        n = int(lens.sum())
        self.stats.distance_ops += n
        if not n:
            return _empty()
        scores = self.pq.adc_segments(self.pq.adc_table(q), self.pack,
                                      starts, lens)
        return _topk(np.concatenate([self.lists[c] for c in probes]), scores,
                     k)

    def insert(self, vid, vec):
        c = self._nearest_cluster(vec)
        self.lists[c] = np.append(self.lists[c], vid)
        self.codes[int(vid)] = self.pq.encode(vec[None])[0]
        self._pack_stale = True

    def delete(self, vid):
        self._pack_stale = True
        super().delete(vid)
        self.codes.pop(int(vid), None)

    def ram_bytes(self):
        n = len(self.codes)
        return (self.n_clusters * self.dim * 4 + n * 8
                + n * self.pq.m * self.pq.nbits // 8
                + self.pq.ksub * self.dim * 4)


class _DiskListMixin:
    """Inverted lists (vectors or codes) in checksummed segment files
    (`core/store.py`), written atomically and validated on every load."""

    LIST_KIND = "ivf.list"

    def _init_disk(self, tag):
        self.storage_dir = tempfile.mkdtemp(prefix=f"{tag}_")
        self.on_disk = True

    def _lpath(self, c):
        return os.path.join(self.storage_dir, f"list_{c:05d}.bin")

    def _store_list(self, c, payload):
        store.dump_obj(self._lpath(c), payload, kind=self.LIST_KIND)

    def _load_list(self, c):
        t0 = time.perf_counter()
        payload = store.load_obj(self._lpath(c), kind=self.LIST_KIND)
        self.stats.disk_loads += 1
        self.stats.disk_bytes += os.path.getsize(self._lpath(c))
        self.stats.disk_time_s += time.perf_counter() - t0
        return payload


class IVFDisk(_ClusteredBase, _DiskListMixin):
    name = "IVF-DISK"

    def __init__(self, dim, n_clusters=64, seed=0, device="cuda"):
        super().__init__(dim, n_clusters, seed, device)
        self._init_disk("ivfdisk")

    def build(self, vectors, ids=None):
        vectors = np.asarray(vectors, np.float32)
        ids = np.arange(len(vectors), dtype=np.int64) if ids is None else ids
        assign = self._partition(vectors, ids)
        for c in range(self.n_clusters):
            m = assign == c
            self._store_list(c, (ids[m], vectors[m]))
        self.n_total = len(vectors)
        return self

    def search(self, q, k=10, n_probe=4, **kw):
        q = np.asarray(q, np.float32)
        probes = self._probe(q, n_probe)
        all_ids, all_d = [], []
        for c in probes:
            lids, lvecs = self._load_list(int(c))
            if not len(lids):
                continue
            d2 = np.sum((lvecs - q) ** 2, axis=1)
            self.stats.distance_ops += len(lids)
            all_ids.append(lids)
            all_d.append(d2)
        if not all_ids:
            return _empty()
        return _topk(np.concatenate(all_ids), np.concatenate(all_d), k)

    def insert(self, vid, vec):
        c = self._nearest_cluster(vec)
        lids, lvecs = self._load_list(c)
        self._store_list(c, (np.append(lids, vid),
                             np.vstack([lvecs, vec[None]])))
        self.lists[c] = np.append(self.lists[c], vid)
        self.n_total += 1

    def delete(self, vid):
        for c in range(self.n_clusters):
            if vid in self.lists[c]:
                lids, lvecs = self._load_list(c)
                m = lids != vid
                self._store_list(c, (lids[m], lvecs[m]))
                self.lists[c] = self.lists[c][m]
                self.n_total -= 1
                return

    def ram_bytes(self):
        # centroids + ids + one loaded list (Table 1 IVF-DISK row)
        avg = int(np.mean([len(l) for l in self.lists])) if self.lists else 0
        return (self.n_clusters * self.dim * 4 + self.n_total * 8
                + avg * self.dim * 4)


class IVFPQDisk(IVFPQ, _DiskListMixin):
    """IVFPQ with its code lists on disk. `insert` and `delete` are
    IVFPQ's, as in the reference: they update the in-RAM id lists and
    never rewrite a list file (ROADMAP Queue C, F6)."""
    name = "IVFPQ-DISK"

    def __init__(self, dim, n_clusters=64, m_pq=8, nbits=8, seed=0,
                 device="cuda"):
        super().__init__(dim, n_clusters, m_pq, nbits, seed, device)
        self._init_disk("ivfpqdisk")

    def build(self, vectors, ids=None):
        super().build(vectors, ids)
        for c in range(self.n_clusters):
            self._store_list(c, super()._list_codes(c))
        self.codes = {}  # codes live on disk now, and no pack is resident
        self.pack = None
        return self

    def _list_codes(self, c) -> Tuple[np.ndarray, np.ndarray]:
        return self._load_list(c)

    def search(self, q, k=10, n_probe=4, **kw):
        """Load the probed lists (disk stats as the reference's); their
        concatenated codes go to the device in one copy, for one
        `pq_adc` launch."""
        q = np.asarray(q, np.float32)
        ids, codes = self.probed_codes(q, n_probe)
        if not len(ids):
            return _empty()
        return _topk(ids, self.pq.adc_scores(q, codes), k)

    def ram_bytes(self):
        n = sum(len(l) for l in self.lists)
        avg = int(np.mean([len(l) for l in self.lists])) if self.lists else 0
        return (self.n_clusters * self.dim * 4 + n * 8
                + avg * self.pq.m * self.pq.nbits // 8
                + self.pq.ksub * self.dim * 4)


class HNSWIndex:
    name = "HNSW"
    on_disk = False

    def __init__(self, dim, M=16, ef_construction=100, seed=0, **kw):
        self.dim = dim
        self.g = HNSW(dim, M=M, ef_construction=ef_construction, seed=seed)
        self.stats = SearchStats()

    def build(self, vectors, ids=None):
        vectors = np.asarray(vectors, np.float32)
        ids = np.arange(len(vectors), dtype=np.int64) if ids is None else ids
        for i, v in zip(ids, vectors):
            self.g.insert(int(i), v)
        return self

    def search(self, q, k=10, ef_search=64, **kw):
        ids, d = self.g.search(np.asarray(q, np.float32), k, ef_search)
        self.stats.distance_ops += ef_search * self.g.M
        return ids, d

    def insert(self, vid, vec):
        self.g.insert(int(vid), np.asarray(vec, np.float32))

    def delete(self, vid):
        self.g.delete(int(vid))

    def ram_bytes(self):
        return self.g.memory_bytes()


class HNSWPQ(HNSWIndex):
    """An HNSW over the PQ reconstructions of the vectors: the search
    walks the graph with exact distances to the reconstructions and
    needs no ADC table."""
    name = "HNSWPQ"

    def __init__(self, dim, M=16, ef_construction=100, m_pq=8, nbits=8,
                 seed=0, device="cuda"):
        super().__init__(dim, M, ef_construction, seed)
        self.pq = PQ(dim, m_pq, nbits, device=device)
        self.codes: Dict[int, np.ndarray] = {}

    def build(self, vectors, ids=None):
        vectors = np.asarray(vectors, np.float32)
        ids = np.arange(len(vectors), dtype=np.int64) if ids is None else ids
        self.pq.train(vectors[np.random.default_rng(0).choice(
            len(vectors), min(len(vectors), 4096), replace=False)])
        codes = self.pq.encode(vectors)
        # graph built over reconstructed (quantised) vectors
        for i, v, c in zip(ids, self.pq.decode(codes), codes):
            self.g.insert(int(i), v)
            self.codes[int(i)] = c
        return self

    def ram_bytes(self):
        n = len(self.codes)
        links = self.g.memory_bytes() - len(self.g) * self.dim * 4
        return (n * self.pq.m * self.pq.nbits // 8 + links
                + self.pq.ksub * self.dim * 4)


class IVFHNSW(IVFDisk):
    """Centroid HNSW + flat inverted lists on disk."""
    name = "IVF-HNSW"

    def __init__(self, dim, n_clusters=64, M_cent=16, seed=0, device="cuda"):
        super().__init__(dim, n_clusters, seed, device)
        self.M_cent = M_cent

    def build(self, vectors, ids=None):
        super().build(vectors, ids)
        self.centroid_graph = HNSW(self.dim, M=self.M_cent,
                                   ef_construction=64, seed=self.seed,
                                   max_elements=self.n_clusters)
        for c in range(self.n_clusters):
            self.centroid_graph.insert(c, self.centroids[c])
        return self

    def _probe(self, q, n_probe):
        cids, _ = self.centroid_graph.search(q, n_probe,
                                             ef_search=max(16, 2 * n_probe))
        self.stats.distance_ops += 16 * self.M_cent
        return cids

    def ram_bytes(self):
        avg = int(np.mean([len(l) for l in self.lists])) if self.lists else 0
        return (self.centroid_graph.memory_bytes() + self.n_total * 8
                + avg * self.dim * 4)


INDEXES = {"IVF": IVF, "IVFPQ": IVFPQ, "HNSW": HNSWIndex, "HNSWPQ": HNSWPQ,
           "IVF-DISK": IVFDisk, "IVFPQ-DISK": IVFPQDisk,
           "IVF-HNSW": IVFHNSW, "EcoVector": EcoVector}
ALL_BASELINES = ["IVF", "IVFPQ", "HNSW", "HNSWPQ", "IVF-DISK", "IVFPQ-DISK",
                 "IVF-HNSW", "EcoVector"]


def make_index(name: str, dim: int, **kw):
    """The index `name` (one of `ALL_BASELINES`) at width `dim`; `device=`
    defaults to cuda where the index runs a kernel."""
    return INDEXES[name](dim, **kw)
