"""The port's tiered hot/cold EcoVector against the JAX package's on the
CPU (the reference's fixture: DIM 16, 320 vectors in 8 blobs, 8
clusters, M 8, efc 32, seed 11).

Tiered ids and distances are bit-equal to the port's all-resident index
at every budget (None, 1.0, 0.5, 0.25, below the centroids) and while
tiers move, and equal the reference `TieredEcoVector`'s (ids exact,
distances within 8 f32 ulps of the largest squared norm: each package's
plain ecoscan rounds in its own sum order). After the same query and
update sequences the hot and cold sets, promotions, demotions, hit
counts and EMA equal the reference's, and the `_no_leaks` invariants
hold under churn. The cold pack's payload and manifest, and
`tiering.seg`, are byte-equal to the reference's; the port's
`TieredEcoVector.load` reads a tiered generation the reference
committed, with its WAL. Crash sweeps through demotions and saves
reload bit-identical with a clean tier scrub; a rotten cold entry heals
from the spill, and with the spill rotten too the cluster is quarantined
and the probe set widens. The device tensors are copies of the host hot
pack, refreshed by rows, and hold exactly `device_resident_bytes`.
`ecoscan`'s block_map is held to the reference's on permuted and masked
layouts. `MobileRAG(device_budget_bytes=)` answers as the all-resident
pipeline."""
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from repro.core import store as jstore
from repro.core.ecovector import EcoVector as JEcoVector
from repro.core.tiered import ColdPack as JColdPack
from repro.core.tiered import TieredEcoVector as JTiered
from repro.core.tiered import TierManager as JTierManager
from repro.kernels import ref as jref
from repro_torch.core import store, store_faults
from repro_torch.core.ecovector import EcoVector
from repro_torch.core.tiered import (ColdPack, TieredEcoVector, TierManager,
                                     scrub_cold_pack, scrub_tier_state)
from repro_torch.kernels import ops

DIM = 16
KW = dict(n_clusters=8, M=8, ef_construction=32)
FRACS = (None, 1.0, 0.5, 0.25, 0.02)


@pytest.fixture(autouse=True)
def _clean_hooks():
    for s in (store, jstore):
        s.set_crash_hook(None)
        s.reset_fs_ops()
    yield
    for s in (store, jstore):
        s.set_crash_hook(None)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    centers = rng.normal(scale=4.0, size=(8, DIM))
    X = (centers.repeat(40, axis=0)
         + rng.normal(size=(320, DIM))).astype(np.float32)
    Q = (X[rng.choice(len(X), 12)]
         + 0.05 * rng.normal(size=(12, DIM))).astype(np.float32)
    return X, Q


def dist_atol(X, Q):
    """8 f32 ulps of the largest ||x||^2 + ||q||^2 of the data."""
    top = float((X.astype(np.float64) ** 2).sum(1).max()
                + (Q.astype(np.float64) ** 2).sum(1).max())
    return 8 * float(np.finfo(np.float32).eps) * top


@pytest.fixture(scope="module")
def base(data):
    return EcoVector(DIM, device="cpu", **KW).build(data[0])


def _tiered(X, path, **kw):
    return TieredEcoVector(DIM, storage_dir=str(path), device="cpu",
                           **dict(KW, **kw)).build(X)


def _jtiered(X, path, **kw):
    return JTiered(DIM, storage_dir=str(path), **dict(KW, **kw)).build(X)


def _no_leaks(tv):
    """Every device row is owned by exactly one hot cluster or free; hot
    and cold are disjoint and, with the quarantined, cover every
    cluster; the device bytes stay within the budget (or the centroid
    floor) and equal the bytes of the tensors held."""
    occupied = {r for r, c in enumerate(tv._row_cluster) if c >= 0}
    free = set(tv._free_rows)
    assert not (occupied & free)
    assert occupied | free == set(range(len(tv._row_cluster)))
    hot, cold = tv.hot_clusters(), tv.cold_clusters()
    assert not (hot & cold)
    assert hot | cold | tv._quarantined == set(range(tv.n_clusters))
    if tv.device_budget_bytes is not None:
        assert (tv.device_resident_bytes()
                <= max(tv.device_budget_bytes, tv._fixed_device_bytes()))
    if tv._hot_mirror is not None and not tv._hot_mirror_dirty:
        assert tv.device_resident_bytes() == sum(
            t.numel() * t.element_size() for t in tv.device_tensors())


def _tier_state(tv):
    return (tv.hot_clusters(), tv.cold_clusters(), tv.stats.promotions,
            tv.stats.demotions, tv.stats.tier_hot_hits,
            tv.stats.tier_cold_hits)


def _same_tiers(tv, jt):
    assert _tier_state(tv) == _tier_state(jt)
    np.testing.assert_array_equal(tv._tm.ema, jt._tm.ema)
    np.testing.assert_array_equal(tv._hot_row, jt._hot_row)


def _budget(tv, frac):
    return None if frac is None else int(frac * tv.all_resident_bytes())


# ----------------------------------------------------- kernel block_map

@pytest.mark.parametrize("masked", [False, True])
def test_ecoscan_block_map_matches_reference(masked):
    """A permuted layout through a block_map (cluster 2 masked, or not):
    the port's ecoscan wrapper (plain on the CPU) returns the identity
    layout's candidates under the same mask, bit for bit, and the
    reference's ids, with distances within 8 ulps of the largest squared
    norm of the reference's."""
    rng = np.random.default_rng(0)
    NC, CAP, d, B, P, K = 6, 8, 16, 3, 4, 5
    data = rng.normal(size=(NC, CAP, d)).astype(np.float32)
    lens = rng.integers(1, CAP + 1, NC).astype(np.int32)
    q = rng.normal(size=(B, d)).astype(np.float32)
    probes = rng.integers(0, NC, (B, P)).astype(np.int32)
    probes[0, -1] = -1                                  # padded probe
    probes[1, 0] = 2                                    # cluster 2 probed
    perm = rng.permutation(NC).astype(np.int32)          # cluster -> row
    ident = np.arange(NC, dtype=np.int32)
    if masked:
        perm[2] = ident[2] = -1
    pdata, plens = np.zeros_like(data), np.zeros_like(lens)
    inv = np.full(NC, -1)                                # row -> cluster
    for c in np.nonzero(perm >= 0)[0]:
        pdata[perm[c]], plens[perm[c]], inv[perm[c]] = data[c], lens[c], c
    t = torch.from_numpy
    d_id, i_id = ops.ecoscan(t(q), t(data), t(lens), t(probes), K,
                             block_map=t(ident))
    d_p, i_p = ops.ecoscan(t(q), t(pdata), t(plens), t(probes), K,
                           block_map=t(perm))
    jd, ji = jref.ecoscan(q, pdata, plens, probes, k=K, block_map=perm)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(jd), rtol=0,
                               atol=dist_atol(data.reshape(-1, d), q))
    ip = i_p.numpy()
    remap = np.where(ip >= 0, inv[np.clip(ip, 0, None) // CAP] * CAP
                     + ip % CAP, -1)
    np.testing.assert_array_equal(remap, i_id.numpy())
    np.testing.assert_array_equal(d_p.numpy(), d_id.numpy())
    if masked:
        assert not ((remap >= 2 * CAP) & (remap < 3 * CAP)).any()


# ------------------------------------------------------------ parity

def test_bit_identical_across_budgets(tmp_path, data, base):
    """Ids and distances bit-equal to the all-resident index at every
    budget; the reference's ids at each; its tier sets and counters."""
    X, Q = data
    ref_ids, ref_d = base.search_device_batched(Q, k=10, n_probe=4)
    tv = _tiered(X, tmp_path / "t")
    jt = _jtiered(X, tmp_path / "j")
    for frac in FRACS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            tv.set_device_budget(_budget(tv, frac))
            jt.set_device_budget(_budget(jt, frac))
            ids, d = tv.search_device_batched(Q, k=10, n_probe=4)
            jids, jd = jt.search_device_batched(Q, k=10, n_probe=4,
                                                use_pallas=False)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(d, ref_d)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_allclose(d, np.asarray(jd), rtol=0,
                                   atol=dist_atol(X, Q))
        _same_tiers(tv, jt)
        _no_leaks(tv)
    assert tv.cold_clusters() and tv.stats.tier_cold_hits > 0


def test_parity_holds_while_tiers_move(tmp_path, data, base):
    """Skewed batches move the EMA (promotions and demotions fire); each
    batch stays bit-equal to the all-resident index, and the tiers move
    as the reference's."""
    X, Q = data
    tv = _tiered(X, tmp_path / "t")
    jt = _jtiered(X, tmp_path / "j")
    tv.set_device_budget(_budget(tv, 0.5))
    jt.set_device_budget(_budget(jt, 0.5))
    for it in range(6):
        batch = Q if it % 2 == 0 else np.repeat(Q[it % len(Q)][None], 4, 0)
        bi, bd = base.search_device_batched(batch, k=8, n_probe=3)
        ti, td = tv.search_device_batched(batch, k=8, n_probe=3)
        jt.search_device_batched(batch, k=8, n_probe=3, use_pallas=False)
        np.testing.assert_array_equal(ti, bi)
        np.testing.assert_array_equal(td, bd)
        _same_tiers(tv, jt)
        _no_leaks(tv)
    assert tv.stats.promotions + tv.stats.demotions > 0
    assert tv.stats.tier_hot_hits > 0


# ------------------------------------------------------ churn / budget

def test_churn_never_exceeds_budget_or_leaks_rows(tmp_path, data):
    X, Q = data
    rng = np.random.default_rng(3)
    tv = _tiered(X, tmp_path / "t")
    jt = _jtiered(X, tmp_path / "j")
    budget = int(0.4 * tv.all_resident_bytes())
    tv.set_device_budget(budget)
    jt.set_device_budget(budget)
    base_vid = 10 ** 6
    for cycle in range(4):
        for i in range(5):
            vec = rng.normal(size=DIM).astype(np.float32)
            tv.insert(base_vid + 5 * cycle + i, vec)
            jt.insert(base_vid + 5 * cycle + i, vec)
        tv.delete(base_vid + 5 * cycle)
        jt.delete(base_vid + 5 * cycle)
        ids, _ = tv.search_device_batched(Q[:4], k=8, n_probe=4)
        jids, _ = jt.search_device_batched(Q[:4], k=8, n_probe=4,
                                           use_pallas=False)
        assert ids.shape == (4, 8)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        _same_tiers(tv, jt)
        assert tv.stats.pack_grows == jt.stats.pack_grows
        _no_leaks(tv)
        assert tv.device_resident_bytes() <= budget
        hd = tv._hot_mirror[0]
        assert torch.equal(hd, torch.from_numpy(tv._hot_data))
        assert hd.data_ptr() != tv._hot_data.ctypes.data


def test_device_rows_refreshed_by_rows(tmp_path, data):
    """After a sync inside the row shape (a delete from a hot cluster)
    only the rewritten rows are copied (one index_copy_ into the same storage); the tensors equal the
    host hot pack."""
    X, Q = data
    tv = _tiered(X, tmp_path / "t")
    tv.set_device_budget(_budget(tv, 0.5))
    tv.activate()
    hd, hl, hm, _ = tv._hot_arrays()
    ptr, up = hd.data_ptr(), tv.stats.mirror_uploads
    c = min(tv.hot_clusters())
    tv.delete(tv.cluster_members[c][0])       # a hot row, no CAP growth
    tv.search_device_batched(Q[:2], k=5, n_probe=2)
    hd2, hl2, hm2, _ = tv._hot_arrays()
    assert hd2.data_ptr() == ptr and tv.stats.mirror_uploads == up
    assert tv.stats.mirror_blocks >= 1
    assert torch.equal(hd2, torch.from_numpy(tv._hot_data))
    assert torch.equal(hl2, torch.from_numpy(tv._hot_lens))
    assert torch.equal(hm2, torch.from_numpy(tv._hot_row))


def test_cold_insert_marks_dirty_without_promotion(tmp_path, data):
    X, Q = data
    tv = _tiered(X, tmp_path / "t")
    tv.set_device_budget(int(0.4 * tv.all_resident_bytes()))
    tv.search_device_batched(Q[:2], k=5, n_probe=2)
    c = sorted(tv.cold_clusters())[0]
    vid = 7 * 10 ** 6
    tv.insert(vid, tv.centroids[c].astype(np.float32))
    assert tv.assign[vid] == c and c in tv._dirty
    tv._tier_sync(moves=0)
    assert c in tv.cold_clusters() and c not in tv.hot_clusters()
    assert vid in set(map(int, tv._cold.get(c)[0]))


def test_budget_smaller_than_centroids_serves_all_cold(tmp_path, data,
                                                      base):
    X, Q = data
    tv = _tiered(X, tmp_path / "t")
    with pytest.warns(UserWarning, match="serving all-cold"):
        tv.set_device_budget(8)
        ids, d = tv.search_device_batched(Q[:4], k=10, n_probe=4)
    bi, bd = base.search_device_batched(Q[:4], k=10, n_probe=4)
    np.testing.assert_array_equal(ids, bi)
    np.testing.assert_array_equal(d, bd)
    assert not tv.hot_clusters()
    assert tv.device_resident_bytes() == tv._fixed_device_bytes()


@pytest.mark.parametrize("method", ["device_pack", "device_arrays"])
def test_monolithic_pack_is_refused(tmp_path, data, method):
    tv = _tiered(data[0], tmp_path / "t")
    with pytest.raises(store.StoreError):
        getattr(tv, method)()


# ------------------------------------------------------- persistence

def test_save_load_restores_tiers_and_budget(tmp_path, data):
    X, Q = data
    tv = _tiered(X, tmp_path / "spill")
    tv.set_device_budget(int(0.5 * tv.all_resident_bytes()))
    ref_ids, ref_d = tv.search_device_batched(Q, k=10, n_probe=4)
    root = str(tmp_path / "j")
    tv.save(root)
    tv2 = TieredEcoVector.load(root, device="cpu")
    assert tv2.device_budget_bytes == tv.device_budget_bytes
    tv2._activate()
    assert tv2.hot_clusters() == tv.hot_clusters()
    ids, d = tv2.search_device_batched(Q, k=10, n_probe=4)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(d, ref_d)
    vid = 9 * 10 ** 6
    tv2.insert(vid, X[0])
    tv3 = TieredEcoVector.load(root, device="cpu")
    assert tv3.stats.wal_replayed >= 1 and vid in tv3.assign
    i3, _ = tv3.search_device_batched(X[0][None], k=5, n_probe=4)
    assert vid in set(map(int, i3[0]))
    _no_leaks(tv3)


def test_port_loads_reference_tiered_generation(tmp_path, data):
    """A tiered generation the reference committed, with a WAL'd insert:
    the port's load gives the reference's tiers, ids and distances."""
    X, Q = data
    jt = _jtiered(X, tmp_path / "jspill")
    jt.set_device_budget(int(0.5 * jt.all_resident_bytes()))
    jt.search_device_batched(Q, k=10, n_probe=4, use_pallas=False)
    root = str(tmp_path / "j")
    jt.save(root)
    jt.insert(9 * 10 ** 6, X[3])
    jt._journal.close()
    proot = str(tmp_path / "p")
    shutil.copytree(root, proot)
    tv = TieredEcoVector.load(proot, device="cpu")
    jt2 = JTiered.load(root)
    assert tv.stats.wal_replayed == jt2.stats.wal_replayed == 1
    assert tv.device_budget_bytes == jt2.device_budget_bytes
    ids, d = tv.search_device_batched(Q, k=10, n_probe=4)
    jids, jd = jt2.search_device_batched(Q, k=10, n_probe=4,
                                         use_pallas=False)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(d, np.asarray(jd), rtol=0,
                               atol=dist_atol(X, Q))
    _same_tiers(tv, jt2)
    _no_leaks(tv)


def test_tier_files_bytes_match_reference(tmp_path, data):
    """The same tiered index and queries in both packages (the port
    loads the reference's untiered generation): byte-equal cold payload,
    cold manifest and tiering.seg in the saved generations."""
    X, Q = data
    root = str(tmp_path / "g")
    JEcoVector(DIM, storage_dir=str(tmp_path / "s"), **KW).build(X).save(
        root)
    roots = {"p": str(tmp_path / "p"), "r": str(tmp_path / "r")}
    for r in roots.values():
        shutil.copytree(root, r)
    tv = TieredEcoVector.load(roots["p"], device="cpu")
    jt = JTiered.load(roots["r"])
    for t in (tv, jt):
        t.set_device_budget(int(0.3 * t.all_resident_bytes()))
    for it in range(3):
        batch = Q[it * 4:(it + 1) * 4]
        tv.search_device_batched(batch, k=10, n_probe=4)
        jt.search_device_batched(batch, k=10, n_probe=4, use_pallas=False)
    _same_tiers(tv, jt)
    assert tv.save() == jt.save() == 1
    for name in ("cold_payload.raw", "cold_manifest.seg", "tiering.seg"):
        a = open(os.path.join(roots["p"], "gen_00000001", name), "rb").read()
        b = open(os.path.join(roots["r"], "gen_00000001", name), "rb").read()
        assert a == b, name
    assert open(tv._cold.payload_path, "rb").read() == \
        open(jt._cold.payload_path, "rb").read()


def test_crash_sweep_mid_demotion_and_save(tmp_path, data):
    """From a tiered generation the reference committed: a crash at
    every third fs op while shrinking the budget (the demotion
    write-through) and saving; every reload is whole, bit-identical to
    the uncrashed run, with a clean tier scrub. The sweep has the
    reference's length (its load makes no fs op either)."""
    X, Q = data
    jt = _jtiered(X, tmp_path / "jspill")
    jt.set_device_budget(int(0.8 * jt.all_resident_bytes()))
    jt.search_device_batched(Q, k=10, n_probe=4, use_pallas=False)
    base_root = str(tmp_path / "base")
    jt.save(base_root)
    shrink = int(0.3 * jt.all_resident_bytes())

    def crashable(idx, root, **kw):
        idx.set_device_budget(shrink)     # demotions write through
        idx.search_device_batched(Q[:2], k=5, n_probe=4, **kw)
        idx.save(root)

    def copy(name):
        shutil.copytree(base_root, str(tmp_path / name))
        return str(tmp_path / name)

    ref_root = copy("ref")
    ref_idx = TieredEcoVector.load(ref_root, device="cpu")
    crashable(ref_idx, ref_root)
    ref_ids, ref_d = ref_idx.search_device_batched(Q, k=10, n_probe=4)
    probe_root = copy("probe")
    total = store_faults.count_fs_ops(lambda: crashable(
        TieredEcoVector.load(probe_root, device="cpu"), probe_root))
    j_root = copy("jprobe")
    jtotal = [0]

    def jrun():
        jstore.reset_fs_ops()
        crashable(JTiered.load(j_root), j_root, use_pallas=False)
        jtotal[0] = jstore.fs_ops()
    jrun()
    assert total == jtotal[0] and total >= 8
    for at in range(1, total + 1, 3):
        root = copy(f"r{at}")
        idx = TieredEcoVector.load(root, device="cpu")
        with store_faults.CrashPlan(at):
            try:
                crashable(idx, root)
            except store_faults.InjectedCrash:
                pass
        idx2 = TieredEcoVector.load(root, device="cpu")
        ids, d = idx2.search_device_batched(Q, k=10, n_probe=4)
        np.testing.assert_array_equal(ids, ref_ids)
        np.testing.assert_array_equal(d, ref_d)
        _no_leaks(idx2)
        assert all(r["ok"] for r in scrub_tier_state(root)), at


# ------------------------------------------------------- corruption

def _force_all_synced(tv, Q):
    tv.search_device_batched(Q[:2], k=5, n_probe=4)


def test_cold_corruption_heals_from_spill(tmp_path, data, base):
    X, Q = data
    tv = _tiered(X, tmp_path / "t")
    tv.set_device_budget(int(0.3 * tv.all_resident_bytes()))
    _force_all_synced(tv, Q)
    c = sorted(tv.cold_clusters())[0]
    off = int(tv._cold.entries[c]["off"]) * tv._cold._row_bytes() + 3
    store_faults.flip_byte(tv._cold.payload_path, off)
    tv._cold._verified = set()
    with pytest.warns(UserWarning, match="healing from the spill"):
        ids, d = tv.search_device_batched(Q, k=10, n_probe=8)
    bi, bd = base.search_device_batched(Q, k=10, n_probe=8)
    np.testing.assert_array_equal(ids, bi)
    np.testing.assert_array_equal(d, bd)
    assert tv.stats.corrupt_reads >= 1 and tv.stats.rebuilt >= 1
    assert c not in tv._quarantined
    assert all(r["ok"] for r in scrub_cold_pack(tv.storage_dir))


def test_cold_and_spill_both_corrupt_quarantines_and_widens(tmp_path, data):
    X, Q = data
    tv = _tiered(X, tmp_path / "t")
    tv.set_device_budget(int(0.3 * tv.all_resident_bytes()))
    _force_all_synced(tv, Q)
    c = sorted(tv.cold_clusters())[0]
    off = int(tv._cold.entries[c]["off"]) * tv._cold._row_bytes() + 3
    store_faults.flip_byte(tv._cold.payload_path, off)
    tv._cold._verified = set()
    store_faults.flip_byte(
        os.path.join(tv.storage_dir, f"cluster_{c:05d}.bin"), 40)
    tv._cache.pop(c, None)
    tv._pending_graphs.pop(c, None)
    with pytest.warns(UserWarning):
        ids, _ = tv.search_device_batched(Q, k=10, n_probe=4)
    assert c in tv._quarantined
    assert (ids >= 0).all()             # probe widening kept k results
    _no_leaks(tv)


def test_save_refuses_to_launder_cold_corruption(tmp_path, data):
    """A cold entry that rots before a save is never copied into the
    generation: the verified snapshot raises, and nothing is
    committed."""
    X, Q = data
    tv = _tiered(X, tmp_path / "t")
    tv.set_device_budget(int(0.3 * tv.all_resident_bytes()))
    _force_all_synced(tv, Q)
    c = sorted(tv.cold_clusters())[0]
    off = int(tv._cold.entries[c]["off"]) * tv._cold._row_bytes() + 3
    store_faults.flip_byte(tv._cold.payload_path, off)
    root = str(tmp_path / "j")
    with pytest.raises(store.CorruptSegmentError, match="CRC"):
        tv.save(root)
    assert store.Journal(root).latest() is None
    assert not all(r["ok"] for r in scrub_cold_pack(tv.storage_dir))


# -------------------------------------------------- memory accounting

def test_tiered_ram_bytes_counts_cold_manifest(tmp_path, data):
    X, Q = data
    tv = _tiered(X, tmp_path / "t")
    tv.set_device_budget(int(0.3 * tv.all_resident_bytes()))
    _force_all_synced(tv, Q)
    ids_bytes = sum(e["ids"].nbytes for e in tv._cold.entries.values())
    assert ids_bytes > 0 and tv.ram_bytes() > ids_bytes


@pytest.mark.parametrize("frac", FRACS)
def test_device_bytes_are_the_tensors_held(tmp_path, data, frac):
    """device_resident_bytes equals the reference's formula and the
    bytes of the tensors the index holds, and all_resident_bytes the
    reference's."""
    X, Q = data
    tv = _tiered(X, tmp_path / "t")
    jt = _jtiered(X, tmp_path / "j")
    assert tv.all_resident_bytes() == jt.all_resident_bytes()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        tv.set_device_budget(_budget(tv, frac))
        jt.set_device_budget(_budget(jt, frac))
        tv.activate()
        jt._ensure_tiers()
    assert tv.device_resident_bytes() == jt.device_resident_bytes() == sum(
        t.numel() * t.element_size() for t in tv.device_tensors())


# ----------------------------------------------------------- planner

def test_tier_manager_matches_reference():
    rng = np.random.default_rng(6)
    tm, jtm = TierManager(6), JTierManager(6)
    tm.seed_from_cache([3, 1])
    jtm.seed_from_cache([3, 1])
    hot = {0, 1}
    for step in range(12):
        probes = rng.integers(-1, 6, size=(3, 2))
        tm.record(probes)
        jtm.record(probes)
        np.testing.assert_array_equal(tm.ema, jtm.ema)
        assert tm.plan(hot, 2, {5}) == jtm.plan(hot, 2, {5})


def test_tier_manager_hysteresis_blocks_thrash():
    tm = TierManager(4, alpha=0.3, hysteresis=1.25)
    hot = {0, 1}
    tm.record(np.array([[0, 1], [0, 1]]))
    tm.record(np.array([[2]]))
    assert tm.plan(hot, budget_rows=2, blocked=set()) == ([], [])
    for _ in range(6):
        tm.record(np.array([[2, 2, 2]]))
    promote, demote = tm.plan(hot, budget_rows=2, blocked=set())
    assert 2 in promote and len(demote) == 1


def test_cold_pack_matches_reference(tmp_path):
    """The same puts in both packages' ColdPack: byte-equal payload and
    manifest, the same fs events; compaction keeps the live rows."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, 8)).astype(np.float32)
    b = rng.normal(size=(3, 8)).astype(np.float32)
    packs, events = {}, {}
    for name, (cls, s) in {"p": (ColdPack, store),
                           "r": (JColdPack, jstore)}.items():
        d = tmp_path / name
        d.mkdir()
        cp = cls(str(d), dim=8)
        names = []
        s.set_crash_hook(lambda n_, c_, names=names: names.append(n_))
        cp.put(0, np.arange(5), a)
        cp.put(1, np.arange(10, 13), b)
        cp.put(0, np.arange(5), a * 2)            # supersedes: dead span
        s.set_crash_hook(None)
        packs[name], events[name] = cp, names
    assert events["p"] == events["r"]
    assert events["p"][:2] == ["cold.append", "cold.fsync"]
    for fn in ("payload_path", "manifest_path"):
        assert open(getattr(packs["p"], fn), "rb").read() == \
            open(getattr(packs["r"], fn), "rb").read()
    cp = packs["p"]
    assert cp.file_bytes() > cp.live_rows() * cp._row_bytes()
    np.testing.assert_array_equal(cp.get(0)[1], a * 2)
    cp.compact()
    assert cp.file_bytes() == cp.live_rows() * cp._row_bytes()
    ids1, v1 = cp.get(1)
    np.testing.assert_array_equal(v1, b)
    np.testing.assert_array_equal(ids1, np.arange(10, 13))
    assert all(r["ok"] for r in scrub_cold_pack(str(tmp_path / "p")))
    assert ColdPack(str(tmp_path / "p"), dim=8).clusters() == {0, 1}
    with pytest.raises(store.CorruptSegmentError, match="dim"):
        ColdPack(str(tmp_path / "p"), dim=4)


# ------------------------------------------------------------ pipeline

def test_mobilerag_under_budget_answers_as_all_resident(tmp_path):
    """MobileRAG with device_budget_bytes=0.25 (tiered, activated at
    construction) and restored from its retrieval_state: the doc ids
    and prompts of the all-resident pipeline; the restore embeds
    nothing and keeps the budget."""
    from repro_torch.data.synthetic import make_qa_corpus
    from repro_torch.serving.embedder import HashEmbedder
    from repro_torch.serving.rag import MobileRAG
    corpus = make_qa_corpus(n_docs=320, n_questions=6, seed=2)
    emb = HashEmbedder(dim=64).fit(corpus.docs)
    qs = [e.question for e in corpus.examples]
    full = MobileRAG(corpus.docs, emb, top_k=3, device="cpu")
    state = str(tmp_path / "state")
    tiered = MobileRAG(corpus.docs, emb, top_k=3, device="cpu",
                       device_budget_bytes=0.25, retrieval_state=state)
    tv = tiered.index
    assert isinstance(tv, TieredEcoVector) and tv._tier_live
    assert tv.device_budget_bytes == int(0.25 * tv.all_resident_bytes())
    assert tv.cold_clusters()
    calls = []
    restored = MobileRAG(corpus.docs, lambda t: calls.append(len(t)) or
                         emb(t), top_k=3, device="cpu",
                         device_budget_bytes=0.25, retrieval_state=state)
    assert calls == [] and isinstance(restored.index, TieredEcoVector)
    assert restored.index.hot_clusters() == tv.hot_clusters()
    want = full.answer_batch(qs)
    for pipe in (tiered, restored):
        got = pipe.answer_batch(qs)
        assert [a.doc_ids for a in got] == [a.doc_ids for a in want]
        assert [a.prompt for a in got] == [a.prompt for a in want]
    assert (tiered.retrieval_fallbacks, restored.retrieval_fallbacks) == \
        (0, 0)
