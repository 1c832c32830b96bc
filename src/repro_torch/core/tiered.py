"""Tiered hot/cold EcoVector, the port of `repro.core.tiered`: an index
served under an explicit ``device_budget_bytes``.

  * **Hot tier**: a device-resident block pack of the most-probed
    clusters, scanned by the `ecoscan` kernel through its ``block_map``
    cluster -> row indirection.
  * **Cold tier**: a checksummed, mmap'd host pack (`ColdPack`): raw f32
    rows in ``cold_payload.raw`` and a segment manifest of per-cluster
    CRCs. The cold tier lives on the host by design (the reference's
    semantics, not a fallback). A batch's cold probes are gathered from
    the mmap into a scratch behind the hot rows (one transient `cat` on
    the device) and scanned on the card in the SAME `ecoscan` launch,
    with the block map sending each cold cluster to its scratch row. The
    kernel orders candidates by (distance, p * CAP + j) whatever the
    row, so ids and distances are bit-identical to the all-resident
    index at equal ``n_probe``: tiering changes cost, never candidates.
  * **TierManager**: a per-cluster EMA of route hits (seeded from the
    LRU graph cache) plans promotions and demotions at search
    boundaries, at most ``moves_per_sync`` a search; a promotion
    rewrites one row in place, a demotion writes through to the cold
    pack before its device row is freed.

The device tensors are copies, never views, of the host hot pack (F4):
after a sync only the rewritten rows are copied (one `index_copy_`).
The index holds on the card exactly the centroids, the [NC] cluster ->
row map and the hot rows with their lens: `device_resident_bytes`.

Durability: `save()` stages the cold pack (verified and compacted) and
``tiering.seg`` (hot set, EMA, cap, budget) into the generation; `load()`
restores the tier assignment and the cold pack before the WAL replays.
The spill files stay the authority for both tiers: a cold entry that
fails its CRC heals from its spill graph, and when that is rotten too
the cluster is quarantined and the probe set widens. The files are the
reference's format; `load` reads a generation of either package.
"""
from __future__ import annotations

import os
import pickle
import warnings
import zlib
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import store
from repro_torch.core.ecovector import EcoVector
from repro_torch.kernels import ops, ref

_COLD_KIND = "ecovector.coldpack"
_TIER_KIND = "ecovector.tiering"
COLD_MANIFEST = "cold_manifest.seg"
COLD_PAYLOAD = "cold_payload.raw"
TIER_STATE = "tiering.seg"


class ColdPack:
    """Checksummed, mmap'd host pack of the cold clusters' vectors.

    ``cold_payload.raw`` holds raw float32 rows (random-access mmap
    slices); ``cold_manifest.seg`` maps cluster -> (row offset, row
    count, payload CRC32, external ids). `put` appends payload (fsync)
    and then commits the manifest atomically: the manifest is the
    linearization point, and a crash mid-append leaves unreferenced rows
    that the next `compact()` or save folds away. A cluster's CRC is
    checked on its first touch per process; a mismatch raises
    `CorruptSegmentError`."""

    def __init__(self, dirpath: str, dim: int):
        self.dir = dirpath
        self.dim = dim
        self.entries: Dict[int, Dict[str, Any]] = {}
        self.payload_rows = 0            # committed rows (manifest view)
        self._mm: Optional[np.memmap] = None
        self._verified: Set[int] = set()
        if os.path.exists(self.manifest_path):
            self._read_manifest()

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dir, COLD_MANIFEST)

    @property
    def payload_path(self) -> str:
        return os.path.join(self.dir, COLD_PAYLOAD)

    def _read_manifest(self) -> None:
        state = store.load_obj(self.manifest_path, kind=_COLD_KIND)
        if state.get("dim") != self.dim:
            raise store.CorruptSegmentError(
                f"{self.manifest_path}: dim {state.get('dim')} where "
                f"{self.dim} expected")
        self.entries = {int(c): e for c, e in state["entries"].items()}
        self.payload_rows = int(state["payload_rows"])

    def _flush_manifest(self) -> None:
        store.dump_obj(self.manifest_path,
                       {"dim": self.dim, "payload_rows": self.payload_rows,
                        "entries": self.entries}, kind=_COLD_KIND)

    def has(self, c: int) -> bool:
        return c in self.entries

    def clusters(self) -> Set[int]:
        return set(self.entries)

    def _mmap(self) -> Optional[np.memmap]:
        if self._mm is None and os.path.exists(self.payload_path) \
                and os.path.getsize(self.payload_path) > 0:
            self._mm = np.memmap(self.payload_path, dtype=np.uint8,
                                 mode="r")
        return self._mm

    def _row_bytes(self) -> int:
        return self.dim * 4

    def get(self, c: int, verify: Optional[bool] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [n] i64, vecs [n, d] f32) of cluster `c`. The payload CRC
        is checked on the first touch per process (always with
        ``verify=True``); a mismatch raises CorruptSegmentError."""
        e = self.entries[c]
        rb = self._row_bytes()
        a, b = e["off"] * rb, (e["off"] + e["n"]) * rb
        mm = self._mmap()
        if mm is None or len(mm) < b:
            raise store.CorruptSegmentError(
                f"{self.payload_path}: cluster {c} span [{a}:{b}] beyond "
                f"payload ({0 if mm is None else len(mm)} bytes)")
        raw = bytes(mm[a:b])
        if verify or (verify is None and c not in self._verified):
            if zlib.crc32(raw) != e["crc"]:
                raise store.CorruptSegmentError(
                    f"{self.payload_path}: cluster {c} payload CRC "
                    f"mismatch (bit-rot in the cold pack)")
            self._verified.add(c)
        vecs = np.frombuffer(raw, np.float32).reshape(e["n"], self.dim)
        return np.asarray(e["ids"], np.int64), vecs

    def put(self, c: int, ids: np.ndarray, vecs: np.ndarray,
            flush: bool = True) -> None:
        """Write one cluster through: append its rows (fsync), then
        commit the manifest. Replaces any earlier entry (whose rows stay
        as garbage until compaction)."""
        vecs = np.ascontiguousarray(vecs, np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"cold put: vecs {vecs.shape} vs dim "
                             f"{self.dim}")
        raw = vecs.tobytes()
        rb = self._row_bytes()
        with open(self.payload_path, "ab") as f:
            size = f.tell()
            if size % rb:                # torn unacknowledged tail: pad to
                pad = rb - size % rb     # the next row boundary
                f.write(b"\0" * pad)
                size += pad
            off = size // rb
            f.write(raw)
            store._fs_event("cold.append")
            f.flush()
            os.fsync(f.fileno())
        store._fs_event("cold.fsync")
        self._mm = None                  # remap: the file grew
        self.entries[c] = {"off": off, "n": int(vecs.shape[0]),
                           "crc": zlib.crc32(raw),
                           "ids": np.asarray(ids, np.int64)}
        self._verified.add(c)
        self.payload_rows = max(self.payload_rows, off + vecs.shape[0])
        if flush:
            self._flush_manifest()

    def drop(self, c: int, flush: bool = True) -> None:
        if self.entries.pop(c, None) is not None:
            self._verified.discard(c)
            if flush:
                self._flush_manifest()

    def live_rows(self) -> int:
        return sum(e["n"] for e in self.entries.values())

    def file_bytes(self) -> int:
        try:
            return os.path.getsize(self.payload_path)
        except OSError:
            return 0

    def write_snapshot(self, dst_dir: str) -> None:
        """Stage a verified, compacted copy of the pack into `dst_dir`.
        Every entry's CRC is checked on the way out: bit-rot never
        reaches a snapshot."""
        rows: List[bytes] = []
        entries: Dict[int, Dict[str, Any]] = {}
        off = 0
        for c in sorted(self.entries):
            ids, vecs = self.get(c, verify=True)
            raw = vecs.tobytes()
            rows.append(raw)
            entries[c] = {"off": off, "n": int(vecs.shape[0]),
                          "crc": zlib.crc32(raw),
                          "ids": np.asarray(ids, np.int64)}
            off += int(vecs.shape[0])
        store.atomic_write_bytes(os.path.join(dst_dir, COLD_PAYLOAD),
                                 b"".join(rows))
        store.write_segment(
            os.path.join(dst_dir, COLD_MANIFEST),
            [pickle.dumps({"dim": self.dim, "payload_rows": off,
                           "entries": entries},
                          protocol=pickle.HIGHEST_PROTOCOL)],
            kind=_COLD_KIND)

    def compact(self) -> None:
        """Rewrite the payload with only live rows (dropping the garbage
        of crashed appends and replaced entries)."""
        self.write_snapshot(self.dir)
        self._mm = None
        self._verified.clear()
        self._read_manifest()


class TierManager:
    """Per-cluster access EMA and promotion/demotion planning. `record`
    folds one batch's probe counts into the EMA; `plan` returns
    (promote, demote) moving the hot set toward the top
    ``budget_rows`` clusters by EMA, with a hysteresis ratio: a cluster
    must be decisively hotter than the coldest resident to swap."""

    def __init__(self, n_clusters: int, alpha: float = 0.3,
                 hysteresis: float = 1.25):
        self.n = n_clusters
        self.alpha = alpha
        self.hysteresis = hysteresis
        self.ema = np.zeros(n_clusters, np.float64)

    def seed_from_cache(self, lru_keys) -> None:
        """Seed from the LRU graph cache: recency is the only access
        signal before the first device search (later == hotter)."""
        keys = [c for c in lru_keys if 0 <= c < self.n]
        for i, c in enumerate(keys):
            self.ema[c] = max(self.ema[c], 0.5 * (i + 1) / max(len(keys), 1))

    def record(self, probes: np.ndarray) -> None:
        flat = np.asarray(probes).reshape(-1)
        flat = flat[(flat >= 0) & (flat < self.n)]
        counts = np.bincount(flat, minlength=self.n).astype(np.float64)
        self.ema *= (1.0 - self.alpha)
        self.ema += self.alpha * counts

    def plan(self, hot: Set[int], budget_rows: int,
             blocked: Set[int]) -> Tuple[List[int], List[int]]:
        elig = [c for c in range(self.n) if c not in blocked]
        hot_l = sorted((c for c in elig if c in hot),
                       key=lambda c: (self.ema[c], -c))      # coldest first
        cold_l = sorted((c for c in elig if c not in hot),
                        key=lambda c: (-self.ema[c], c))     # hottest first
        demote: List[int] = []
        while len(hot_l) > budget_rows:                      # over budget
            demote.append(hot_l.pop(0))
        promote: List[int] = []
        free = budget_rows - len(hot_l)
        while free > 0 and cold_l:                           # fill free rows
            promote.append(cold_l.pop(0))
            free -= 1
        for cand in cold_l:                                  # swaps
            if not hot_l or self.ema[cand] <= 0:
                break
            victim = hot_l[0]
            if self.ema[cand] > self.hysteresis * self.ema[victim] + 1e-9:
                demote.append(hot_l.pop(0))
                promote.append(cand)
            else:
                break
        return promote, demote


class TieredEcoVector(EcoVector):
    """EcoVector whose device pack is split hot/cold under
    ``device_budget_bytes``. ``None`` keeps every cluster hot; any budget
    serves the same candidates: cold probes are gathered from the mmap'd
    `ColdPack` and scanned in the same kernel launch via ``block_map``.
    There is no monolithic pack: `device_pack` and `device_arrays`
    raise `StoreError`; `activate()` makes the tiers and their device
    tensors."""

    def __init__(self, *args, device_budget_bytes: Optional[int] = None,
                 ema_alpha: float = 0.3, hysteresis: float = 1.25,
                 moves_per_sync: int = 4, **kw):
        self.device_budget_bytes = device_budget_bytes
        self.ema_alpha = ema_alpha
        self.hysteresis = hysteresis
        self.moves_per_sync = moves_per_sync
        super().__init__(*args, **kw)

    # ------------------------------------------------------- tier state

    def _reset_pack_state(self):
        super()._reset_pack_state()
        self._tier_live = False
        self._cap: int = 0
        self._hot_data: Optional[np.ndarray] = None   # [R, cap, d] f32
        self._hot_ids: Optional[np.ndarray] = None    # [R, cap] i64
        self._hot_lens: Optional[np.ndarray] = None   # [R] i32
        self._hot_row: Optional[np.ndarray] = None    # [NC] i32, -1 = cold
        self._row_cluster: List[int] = []             # row -> cluster / -1
        self._free_rows: List[int] = []
        # device copies (data, lens, cluster -> row map) and the rows
        # rewritten on the host since they were last refreshed
        self._hot_mirror: Optional[Tuple[torch.Tensor, ...]] = None
        self._hot_mirror_dirty: Set[int] = set()
        self._cold: Optional[ColdPack] = None
        self._tm: Optional[TierManager] = None
        self._restored_tiering = getattr(self, "_restored_tiering", None)

    def _pack_live(self) -> bool:
        # dirty marks count from the moment the index has content: the
        # cold pack restored by load() must see the WAL's mutations
        return self.centroid_graph is not None

    def device_pack(self, cap=None, force_full=False):
        raise store.StoreError(
            "TieredEcoVector has no monolithic device pack: the hot/cold "
            "split is managed by device_budget_bytes; use "
            "search_device_batched / device_resident_bytes")

    def device_arrays(self):
        raise store.StoreError(
            "TieredEcoVector has no monolithic device pack: activate() "
            "makes the hot tier's device tensors")

    def hot_clusters(self) -> Set[int]:
        if not self._tier_live:
            return set()
        return {c for c in self._row_cluster if c >= 0}

    def cold_clusters(self) -> Set[int]:
        if self._cold is None:
            return set()
        return self._cold.clusters()

    # ------------------------------------------------------ budget math

    def _fixed_device_bytes(self) -> int:
        """Device bytes that do not depend on the hot-row count: the
        routing centroids and the [NC] cluster -> row map."""
        cent = (int(self.centroids.size) * 4
                if self.centroids is not None else 0)
        return cent + self.n_clusters * 4

    def _row_device_bytes(self) -> int:
        return self._cap * self.dim * 4 + 4      # data row + lens entry

    def _budget_rows(self) -> Optional[int]:
        if self.device_budget_bytes is None:
            return None
        spare = self.device_budget_bytes - self._fixed_device_bytes()
        if spare < 0:
            warnings.warn(
                f"device_budget_bytes={self.device_budget_bytes} does not "
                f"even cover the routing centroids "
                f"({self._fixed_device_bytes()} B); serving all-cold",
                stacklevel=3)
            return 0
        return int(spare // self._row_device_bytes())

    def device_resident_bytes(self) -> int:
        if not self._tier_live:
            return super().device_resident_bytes()
        R = len(self._row_cluster)
        return self._fixed_device_bytes() + R * self._row_device_bytes()

    def all_resident_bytes(self) -> int:
        """What the all-hot layout would hold on the device: the base of
        a fractional budget. Computable before activation."""
        cap = max(self._cap, 8, self._cluster_need())
        row = cap * self.dim * 4 + 4
        return self._fixed_device_bytes() + self.n_clusters * row

    def ram_bytes(self) -> int:
        total = super().ram_bytes()
        if self._cold is not None:
            # the mmap'd payload is page cache, not anonymous RAM; the
            # manifest's id arrays are resident
            total += sum(e["ids"].nbytes + 64
                         for e in self._cold.entries.values())
        return total

    # ------------------------------------------------------- activation

    def set_device_budget(self, budget: Optional[int]) -> None:
        """Re-budget at runtime: recompute the row budget and demote /
        promote to fit. ``None`` lifts the budget (every cluster hot)."""
        self.device_budget_bytes = budget
        if self._tier_live:
            self._retier()

    def activate(self) -> None:
        """Make the tiers (first call) and bring their device tensors up
        to date, so the first search pays for neither."""
        self._ensure_tiers()
        self._hot_arrays()

    def _cluster_need(self) -> int:
        sizes = [len(m) for m in self.cluster_members]
        return int(max(sizes)) if sizes else 0

    def _ensure_tiers(self) -> None:
        if not self._tier_live:
            self._activate()
        self._tier_sync()

    def _activate(self) -> None:
        """The initial hot/cold split: the persisted tier assignment when
        one was loaded, else the top-budget clusters by (cache-seeded)
        EMA. Every healthy cluster that is not hot is written through to
        the cold pack."""
        self._cap = max(8, self._cluster_need())
        self._tm = TierManager(self.n_clusters, alpha=self.ema_alpha,
                               hysteresis=self.hysteresis)
        self._tm.seed_from_cache(list(self._cache))
        self._cold = ColdPack(self.storage_dir, self.dim)
        restored = self._restored_tiering
        if restored is not None:
            self._cap = max(self._cap, int(restored["cap"]))
            ema = np.asarray(restored["ema"], np.float64)
            if ema.shape[0] == self.n_clusters:
                self._tm.ema = np.maximum(self._tm.ema, ema)
            if self.device_budget_bytes is None:
                self.device_budget_bytes = restored["budget"]
        budget_rows = self._budget_rows()
        healthy = [c for c in range(self.n_clusters)
                   if c not in self._quarantined]
        if budget_rows is None:
            want_hot = healthy
        else:
            pref = (sorted((c for c in restored["hot"] if c in
                            set(healthy)),
                           key=lambda c: (-self._tm.ema[c], c))
                    if restored is not None else
                    sorted(healthy, key=lambda c: (-self._tm.ema[c], c)))
            rest = [c for c in healthy if c not in set(pref)]
            want_hot = (pref + sorted(
                rest, key=lambda c: (-self._tm.ema[c], c)))[:budget_rows]
        self._rebuild_hot(want_hot)
        hot_set = set(want_hot)
        missing = [c for c in healthy
                   if c not in hot_set and not self._cold.has(c)]
        for c in missing:
            g = self._load_cluster_checked(c)
            if g is None:
                continue
            ids, vecs = g.graph_arrays()
            self._cold.put(c, ids, vecs, flush=False)
        if missing:
            self._cold._flush_manifest()
        self._tier_live = True

    def _rebuild_hot(self, want_hot: List[int]) -> None:
        """(Re)allocate the hot arrays for `want_hot`, taking rows from
        the previous hot arrays where possible, else the cold pack or the
        spill graphs. Demoted clusters write through to the cold pack
        before their rows disappear."""
        budget_rows = self._budget_rows()
        R = (self.n_clusters if budget_rows is None
             else min(self.n_clusters, budget_rows))
        want_hot = want_hot[:R]
        old = (self._hot_data, self._hot_ids, self._hot_lens,
               self._hot_row)
        prev_hot = self.hot_clusters() if self._hot_row is not None else set()
        data = np.zeros((R, self._cap, self.dim), np.float32)
        ids_a = -np.ones((R, self._cap), np.int64)
        lens = np.zeros((R,), np.int32)
        hot_row = -np.ones((self.n_clusters,), np.int32)
        row_cluster = [-1] * R
        for row, c in enumerate(want_hot):
            got = self._fetch_cluster_rows(c, old)
            if got is None:
                continue                      # quarantined along the way
            cids, cvecs = got
            if len(cids) > self._cap:
                raise RuntimeError(
                    f"cluster {c} has {len(cids)} rows but tier cap is "
                    f"{self._cap}: members/graph bookkeeping diverged")
            m = len(cids)
            data[row, :m] = cvecs
            ids_a[row, :m] = cids
            lens[row] = m
            hot_row[c] = row
            row_cluster[row] = c
        self._hot_data, self._hot_ids, self._hot_lens = data, ids_a, lens
        self._hot_row, self._row_cluster = hot_row, row_cluster
        self._free_rows = [r for r, c in enumerate(row_cluster) if c < 0]
        self._hot_mirror = None
        self._hot_mirror_dirty.clear()
        now_hot = {c for c in row_cluster if c >= 0}
        if self._cold is not None:
            # write the newly demoted clusters through, then drop the
            # promoted ones from the pack (one manifest commit each way)
            changed = False
            for c in sorted(prev_hot - now_hot):
                if c in self._quarantined:
                    continue
                got = self._fetch_cluster_rows(c, old)
                if got is not None:
                    self._cold.put(c, got[0], got[1], flush=False)
                    self.stats.demotions += 1
                    changed = True
            if changed:
                self._cold._flush_manifest()
            dropped = [c for c in sorted(now_hot) if self._cold.has(c)]
            for c in dropped:
                self._cold.drop(c, flush=False)
            if dropped:
                self._cold._flush_manifest()

    def _fetch_cluster_rows(self, c: int, old=None
                            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(ids, vecs) of a healthy cluster from the cheapest source: the
        previous hot arrays, the cold pack (healed from the spill graph
        on a CRC failure), else the spill graph."""
        if c in self._quarantined:
            return None
        if old is not None and old[3] is not None and old[3][c] >= 0:
            row = old[3][c]
            m = int(old[2][row])
            return old[1][row, :m].copy(), old[0][row, :m].copy()
        if self._cold is not None and self._cold.has(c):
            try:
                return self._cold.get(c)
            except store.CorruptSegmentError as e:
                self.stats.corrupt_reads += 1
                warnings.warn(f"cold pack entry for cluster {c} failed "
                              f"validation ({e}); healing from the spill "
                              f"graph", stacklevel=3)
        g = self._load_cluster_checked(c)     # may quarantine
        if g is None:
            return None
        ids, vecs = g.graph_arrays()
        if self._cold is not None and self._cold.has(c):
            self._cold.put(c, ids, vecs)      # heal the rotten entry
            self.stats.rebuilt += 1
        return ids, vecs

    # ------------------------------------------------------------- sync

    def _tier_sync(self, moves: Optional[int] = None) -> None:
        """Search-boundary maintenance: (1) flush dirty clusters into
        their current tier (hot rows rewritten in place, cold entries
        written through, never a promotion); (2) apply up to `moves`
        planned promotions / demotions."""
        if not self._tier_live:
            return
        if self._dirty:
            need = max((len(self.cluster_members[c]) for c in self._dirty),
                       default=0)
            if need > self._cap:
                new_cap = self._cap
                while new_cap < need:
                    new_cap *= 2
                self._cap = new_cap
                self.stats.pack_grows += 1
                # the row grew: the budget buys fewer rows now
                self._rebuild_hot(sorted(
                    self.hot_clusters(),
                    key=lambda c: (-self._tm.ema[c], c)))
            dirty = sorted(self._dirty)
            self._dirty.clear()
            cold_touched = False
            for c in dirty:
                if c in self._quarantined:
                    continue
                g = self._pending_graphs.pop(c, None)
                if g is None:
                    g = self._load_cluster_checked(c)
                if g is None:
                    continue
                ids, vecs = g.graph_arrays()
                row = int(self._hot_row[c])
                if row >= 0:
                    m = len(ids)
                    self._hot_data[row, :m] = vecs
                    self._hot_data[row, m:] = 0.0
                    self._hot_ids[row, :m] = ids
                    self._hot_ids[row, m:] = -1
                    self._hot_lens[row] = m
                    self._hot_mirror_dirty.add(row)
                    self.stats.pack_cluster_repacks += 1
                else:
                    self._cold.put(c, ids, vecs, flush=False)
                    cold_touched = True
            if cold_touched:
                self._cold._flush_manifest()
        budget_rows = self._budget_rows()
        n = self.moves_per_sync if moves is None else moves
        if n <= 0 or budget_rows is None:
            return
        promote, demote = self._tm.plan(self.hot_clusters(), budget_rows,
                                        self._quarantined)
        for c in demote:
            if n <= 0:
                break
            self._demote(c)
            n -= 1
        for c in promote:
            if n <= 0 or not self._free_rows:
                break
            self._promote(c)
            n -= 1

    def _demote(self, c: int) -> None:
        row = int(self._hot_row[c])
        if row < 0:
            return
        m = int(self._hot_lens[row])
        # write through BEFORE freeing the row: a crash in between leaves
        # the cluster in both tiers, which a reload reconciles
        self._cold.put(c, self._hot_ids[row, :m].copy(),
                       self._hot_data[row, :m].copy())
        self._clear_row(c, row)
        self.stats.demotions += 1

    def _clear_row(self, c: int, row: int) -> None:
        self._hot_data[row] = 0.0
        self._hot_ids[row] = -1
        self._hot_lens[row] = 0
        self._hot_row[c] = -1
        self._row_cluster[row] = -1
        self._free_rows.append(row)
        self._hot_mirror_dirty.add(row)

    def _promote(self, c: int) -> None:
        got = self._fetch_cluster_rows(c)
        if got is None:
            return
        ids, vecs = got
        m = min(len(ids), self._cap)
        row = self._free_rows.pop()
        self._hot_data[row, :m] = vecs[:m]
        self._hot_data[row, m:] = 0.0
        self._hot_ids[row, :m] = ids[:m]
        self._hot_ids[row, m:] = -1
        self._hot_lens[row] = m
        self._hot_row[c] = row
        self._row_cluster[row] = c
        self._hot_mirror_dirty.add(row)
        self._cold.drop(c)
        self.stats.promotions += 1

    def _retier(self) -> None:
        """Apply a budget change now (unbounded moves): demote the
        overflow, then fill free rows with the hottest cold clusters."""
        budget_rows = self._budget_rows()
        if budget_rows is None:
            budget_rows = self.n_clusters
        target = sorted(
            (c for c in range(self.n_clusters)
             if c not in self._quarantined),
            key=lambda c: (-self._tm.ema[c],
                           0 if self._hot_row[c] >= 0 else 1, c))
        self._rebuild_hot(target[:budget_rows])

    # ------------------------------------------------------------ search

    def _quarantine(self, c: int):
        if c in self._quarantined:
            return
        if self._tier_live:
            row = int(self._hot_row[c])
            if row >= 0:
                m = int(self._hot_lens[row])
                if m > 0 and c not in self._salvage:
                    self._salvage[c] = (self._hot_ids[row, :m].copy(),
                                        self._hot_data[row, :m].copy())
                self._clear_row(c, row)
            elif self._cold is not None and self._cold.has(c):
                if c not in self._salvage:
                    try:
                        self._salvage[c] = self._cold.get(c, verify=False)
                    except store.CorruptSegmentError:
                        pass
                self._cold.drop(c)
            self._dirty.discard(c)
        super()._quarantine(c)

    def _hot_arrays(self):
        """The hot tier on the index's device: (data [R, cap, d], lens
        [R], cluster -> row map [NC], centroids [NC, d]). Copies, never
        views of the host arrays; after a sync only the rewritten rows
        are copied (one `index_copy_`) and lens and the map uploaded."""
        if (self._hot_mirror is None or tuple(self._hot_mirror[0].shape)
                != self._hot_data.shape):
            self._hot_mirror = tuple(
                torch.tensor(a, device=self.device)
                for a in (self._hot_data, self._hot_lens, self._hot_row))
            self._hot_mirror_dirty.clear()
            self.stats.mirror_uploads += 1
        elif self._hot_mirror_dirty:
            rows = sorted(self._hot_mirror_dirty)
            mdata, mlens, mrow = self._hot_mirror
            mdata.index_copy_(0, torch.tensor(rows, device=self.device),
                              torch.tensor(self._hot_data[rows],
                                           device=self.device))
            mlens.copy_(torch.from_numpy(self._hot_lens))
            mrow.copy_(torch.from_numpy(self._hot_row))
            self._hot_mirror_dirty.clear()
            self.stats.mirror_blocks += len(rows)
        if self._centroids_dev is None:
            self._centroids_dev = torch.tensor(
                np.asarray(self.centroids, np.float32), device=self.device)
        return (*self._hot_mirror, self._centroids_dev)

    def device_tensors(self) -> List[torch.Tensor]:
        """Every tensor the index holds on its device."""
        held = list(self._hot_mirror or ())
        if self._centroids_dev is not None:
            held.append(self._centroids_dev)
        return held

    def _route_device(self, qt: torch.Tensor, n_probe: int) -> np.ndarray:
        """Routing over ALL centroids on the device: the same plain
        `route_topk` as the all-resident path, so the probes are equal.
        Quarantined clusters widen the ask and are filtered out, keeping
        the probe budget met where enough clusters survive."""
        cent = self._hot_arrays()[3]
        if not self._quarantined:
            return ref.route_topk(qt, cent, n_probe).cpu().numpy()
        ask = min(self.n_clusters, n_probe + len(self._quarantined))
        ranked = ref.route_topk(qt, cent, ask).cpu().numpy()
        out = -np.ones((qt.shape[0], n_probe), np.int32)
        for b in range(qt.shape[0]):
            keep = [c for c in ranked[b] if c not in self._quarantined]
            out[b, :len(keep[:n_probe])] = keep[:n_probe]
        return out

    def _gather_cold(self, cold_cids: List[int]):
        """Scratch [n_pow2, cap, d] + ids + lens of this batch's cold
        probes, gathered from the mmap'd pack (padded to a power of two
        of rows, so the scan meets few shapes), and the clusters kept (a
        cluster quarantined on the way is left out)."""
        n = len(cold_cids)
        padded = 1
        while padded < n:
            padded *= 2
        data = np.zeros((padded, self._cap, self.dim), np.float32)
        ids_a = -np.ones((padded, self._cap), np.int64)
        lens = np.zeros((padded,), np.int32)
        kept: List[int] = []
        for c in cold_cids:
            got = self._fetch_cluster_rows(c)
            if got is None:
                continue                      # quarantined: caller reroutes
            cids, cvecs = got
            i = len(kept)
            m = min(len(cids), self._cap)
            data[i, :m] = cvecs[:m]
            ids_a[i, :m] = cids[:m]
            lens[i] = m
            kept.append(c)
        return data, ids_a, lens, kept

    def search_device_batched(self, q: np.ndarray, k: int = 10,
                              n_probe: int = 4):
        """Tier-aware batched search: route over every centroid on the
        device, then ONE `ecoscan` launch over the hot rows followed by a
        scratch of the batch's cold probes (gathered from the mmap), the
        block map sending each cold cluster to its scratch row. Ids and
        distances equal the all-resident index's. Returns (ids [B, k]
        int64, dists [B, k] f32) as numpy."""
        q = np.atleast_2d(np.asarray(q, np.float32))
        if q.shape[0] == 0:
            return (np.zeros((0, k), np.int64), np.zeros((0, k), np.float32))
        n_probe = min(n_probe, self.n_clusters)
        self._ensure_tiers()
        qt = torch.tensor(q, device=self.device)
        probes = self._route_device(qt, n_probe)
        scratch = None
        for _attempt in range(self.n_clusters + 1):
            valid = probes[probes >= 0]
            cold_cids = sorted(set(map(int, valid[self._hot_row[valid] < 0]))
                               - self._quarantined)
            if not cold_cids:
                scratch = None
                break
            scratch = self._gather_cold(cold_cids)
            if len(scratch[3]) == len(cold_cids):
                break
            # a cold probe was quarantined mid-gather: route wider
            probes = self._route_device(qt, n_probe)
        else:
            scratch = None
        valid = probes[probes >= 0]
        n_hot = int((self._hot_row[valid] >= 0).sum())
        self.stats.tier_hot_hits += n_hot
        self.stats.tier_cold_hits += int(valid.size) - n_hot
        self._tm.record(probes)

        hot_d, hot_l, hot_map, _ = self._hot_arrays()
        R = len(self._row_cluster)
        if scratch is not None:
            sdata, sids, slens, kept = scratch
            bmap = self._hot_row.copy()
            bmap[kept] = R + np.arange(len(kept), dtype=np.int32)
            scan_data = torch.cat([hot_d, torch.from_numpy(sdata).to(
                self.device)])
            scan_lens = torch.cat([hot_l, torch.from_numpy(slens).to(
                self.device)])
            scan_map = torch.from_numpy(bmap).to(self.device)
            slot_ids = np.concatenate([self._hot_ids, sids])
        else:
            scan_data, scan_lens, scan_map = hot_d, hot_l, hot_map
            slot_ids = self._hot_ids
        if scan_data.shape[0] == 0:
            return (np.full((q.shape[0], k), -1, np.int64),
                    np.zeros((q.shape[0], k), np.float32))
        dists, slots = ops.ecoscan(qt, scan_data, scan_lens,
                                   torch.from_numpy(probes).to(self.device),
                                   k, block_map=scan_map)
        # power-model accounting: dense routing + scanned candidates
        self.stats.distance_ops += q.shape[0] * self.n_clusters
        csizes = np.asarray([len(m) for m in self.cluster_members],
                            np.int64)
        self.stats.distance_ops += int(csizes[valid].sum())
        slots = slots.cpu().numpy()
        ids = np.where(slots >= 0,
                       slot_ids.reshape(-1)[np.clip(slots, 0, None)], -1)
        return ids, dists.cpu().numpy()

    # ------------------------------------------------------ persistence

    def _write_state(self, d: str):
        if self._tier_live:
            self._tier_sync(moves=0)          # fold dirty into the tiers
        super()._write_state(d)
        if not self._tier_live:
            return
        self._cold.write_snapshot(d)          # verified + compacted
        store.write_segment(
            os.path.join(d, TIER_STATE),
            [pickle.dumps({"hot": sorted(self.hot_clusters()),
                           "cap": self._cap,
                           "ema": self._tm.ema,
                           "budget": self.device_budget_bytes},
                          protocol=pickle.HIGHEST_PROTOCOL)],
            kind=_TIER_KIND)

    def _restore_extra(self, j: store.Journal, g: int) -> None:
        files = j.manifest(g)["files"]
        if TIER_STATE not in files:
            return
        _, recs = j.read_segment(g, TIER_STATE, _TIER_KIND, 1)
        self._restored_tiering = store.loads(recs[0])
        if self.device_budget_bytes is None:
            self.device_budget_bytes = self._restored_tiering["budget"]
        for name in (COLD_MANIFEST, COLD_PAYLOAD):
            if name in files:
                with open(os.path.join(self.storage_dir, name), "wb") as f:
                    f.write(j.read_file(g, name))


# ------------------------------------------------------------------ scrub

def scrub_cold_pack(dirpath: str, dim: Optional[int] = None
                    ) -> List[Dict[str, Any]]:
    """Verify a cold pack in `dirpath`: the manifest segment, every
    cluster's payload span in bounds, every per-cluster CRC. One report
    dict per item, `store.scrub_path`'s shape (`ok=False` is
    corruption)."""
    man = os.path.join(dirpath, COLD_MANIFEST)
    out: List[Dict[str, Any]] = []
    if not os.path.exists(man):
        return out
    try:
        state = store.load_obj(man, kind=_COLD_KIND)
        out.append({"item": man, "ok": True,
                    "clusters": len(state["entries"])})
    except (store.StoreError, OSError) as e:
        return [{"item": man, "ok": False, "error": str(e)}]
    pack = ColdPack(dirpath, dim if dim is not None else state["dim"])
    for c in sorted(pack.entries):
        item = f"{pack.payload_path}#cluster_{c}"
        try:
            ids, vecs = pack.get(c, verify=True)
            if len(ids) != vecs.shape[0]:
                raise store.CorruptSegmentError(
                    f"cluster {c}: {len(ids)} ids vs {vecs.shape[0]} rows")
            out.append({"item": item, "ok": True, "rows": int(len(ids))})
        except (store.StoreError, OSError) as e:
            out.append({"item": item, "ok": False, "error": str(e)})
    return out


def scrub_tier_state(root: str) -> List[Dict[str, Any]]:
    """Verify the tier assignment of a Journal root's latest generation:
    hot and cold disjoint, hot, cold and quarantined covering every
    cluster, and the staged cold pack's per-cluster CRCs."""
    j = store.Journal(root)
    g = j.latest()
    out: List[Dict[str, Any]] = []
    if g is None:
        return out
    files = j.manifest(g)["files"]
    if TIER_STATE not in files:
        return out
    gen_dir = j.gen_dir(g)
    item = os.path.join(gen_dir, TIER_STATE)
    try:
        _, recs = j.read_segment(g, TIER_STATE, _TIER_KIND, 1)
        tiering = store.loads(recs[0])
        _, srecs = j.read_segment(g, "state.seg", "ecovector.state", 3)
        estate = store.loads(srecs[0])
    except (store.StoreError, OSError) as e:
        return out + [{"item": item, "ok": False, "error": str(e)}]
    out.extend(scrub_cold_pack(gen_dir, dim=estate["dim"]))
    hot = set(tiering["hot"])
    quarantined = set(estate["quarantined"])
    cold = set()
    if COLD_MANIFEST in files:
        try:
            cman = store.load_obj(os.path.join(gen_dir, COLD_MANIFEST),
                                  kind=_COLD_KIND)
            cold = {int(c) for c in cman["entries"]}
        except (store.StoreError, OSError):
            pass                     # already reported by scrub_cold_pack
    problems = []
    both = hot & cold
    if both:
        problems.append(f"clusters in BOTH tiers: {sorted(both)[:8]}")
    missing = set(range(int(estate["n_clusters"]))) - hot - cold - quarantined
    if missing:
        problems.append(f"clusters in NO tier: {sorted(missing)[:8]}")
    qhot = hot & quarantined
    if qhot:
        problems.append(f"quarantined clusters marked hot: "
                        f"{sorted(qhot)[:8]}")
    rep: Dict[str, Any] = {"item": item, "ok": not problems,
                           "hot": len(hot), "cold": len(cold),
                           "quarantined": len(quarantined)}
    if problems:
        rep["error"] = "; ".join(problems)
    out.append(rep)
    return out
