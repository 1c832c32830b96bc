"""EcoVector (paper §3) device search: k-means partitioning, the padded
[NC, CAP, d] cluster pack, and the fused route -> scan batched search.

The port of `repro.core.ecovector` covers the build and the device path
only. A fresh `build` packs each cluster's members in insertion (id)
order, which is the order the reference's per-cluster HNSW graphs export
(`graph_arrays`), so pack, slot ids and search results equal the
reference's. The host HNSW search, disk tier, WAL and the insert/delete
repack path are not ported yet; `insert` and `delete` raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.kmeans import kmeans
from repro_torch.kernels import ops, ref


class EcoVector:
    def __init__(self, dim: int, n_clusters: int = 64, device="cuda"):
        self.dim = dim
        self.n_clusters = n_clusters
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None
        self._pack: Optional[Tuple] = None      # (data, lens, slot_ids, cap)
        self._dev: Optional[Tuple] = None       # (data, lens, centroids)

    def build(self, vectors: np.ndarray, ids: Optional[np.ndarray] = None):
        vectors = np.asarray(vectors, np.float32)
        n = vectors.shape[0]
        ids = np.arange(n, dtype=np.int64) if ids is None else ids
        k = min(self.n_clusters, max(1, n))
        self.centroids, assign = kmeans(vectors, k, seed=0,
                                        device=self.device)
        self.n_clusters = self.centroids.shape[0]
        members = [list(map(int, ids[assign == c]))
                   for c in range(self.n_clusters)]
        row_of = {int(v): i for i, v in enumerate(ids)}
        cap = max(8, max(len(m) for m in members))
        data = np.zeros((self.n_clusters, cap, self.dim), np.float32)
        slot_ids = -np.ones((self.n_clusters, cap), np.int64)
        lens = np.zeros((self.n_clusters,), np.int32)
        for c, mem in enumerate(members):
            m = len(mem)
            data[c, :m] = vectors[[row_of[v] for v in mem]]
            slot_ids[c, :m] = mem
            lens[c] = m
        self._pack = (data, lens, slot_ids, cap)
        # device copies (never aliases of the host pack)
        self._dev = (torch.tensor(data, device=self.device),
                     torch.tensor(lens, device=self.device),
                     torch.tensor(self.centroids, device=self.device))
        return self

    def device_pack(self):
        """The host pack as (data [NC, CAP, d], lens [NC], slot_ids
        [NC, CAP], cap), the layout the ecoscan kernel reads."""
        return self._pack

    def device_arrays(self):
        """The pack and centroids on the index's device: (data, lens,
        centroids)."""
        return self._dev

    def search_device_batched(self, q: np.ndarray, k: int = 10,
                              n_probe: int = 4):
        """Batched search over q [B, d]: centroid routing and the ecoscan
        kernel run back to back on the device, the probes never leave
        it. Returns (ids [B, k] int64, dists [B, k] f32) as numpy."""
        q = np.atleast_2d(np.asarray(q, np.float32))
        if q.shape[0] == 0:
            return (np.zeros((0, k), np.int64), np.zeros((0, k), np.float32))
        n_probe = min(n_probe, self.n_clusters)
        data, lens, cent = self.device_arrays()
        qt = torch.tensor(q, device=self.device)
        probes = ref.route_topk(qt, cent, n_probe)
        dists, slots = ops.ecoscan(qt, data, lens, probes, k)
        slots = slots.cpu().numpy()
        slot_ids = self._pack[2]
        ids = np.where(slots >= 0,
                       slot_ids.reshape(-1)[np.clip(slots, 0, None)], -1)
        return ids, dists.cpu().numpy()

    def insert(self, *args, **kwargs):
        raise NotImplementedError(
            "EcoVector updates (per-cluster HNSW + dirty-cluster repack) are "
            "not ported yet: see ROADMAP.md Queue A")

    delete = insert
