"""The port's EcoVector host index and update path against the JAX
package's on the CPU (480 x 24 vectors in 6 blobs, 8 clusters, M 8,
efc 40): the same members, assignments, centroid graph and per-cluster
spill graphs after a build; host search with the same ids, distances and
stats at several n_probe / k, with and without the LRU cache; quarantine
of a corrupt spill file with the probe set widened, `rebuild_cluster`
and insert into a quarantined cluster; insert/delete into the same
graphs and a byte-equal pack after the repack, CAP growth, a forced cap
with its warnings and `truncated_vectors`; `search_device_batched` after
updates (ids equal, dists within 2e-5); the device tensors equal to the
host pack, with only dirty blocks copied when CAP did not grow; the
accounting, where each spill file is longer than the reference's by
exactly the difference of the pickled class paths; and `MobileRAG`'s
host-search mode over a given index."""
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

from repro.core import store as jstore
from repro.core.ecovector import EcoVector as JEcoVector
from repro.serving.embedder import HashEmbedder as JHashEmbedder
from repro.serving.rag import MobileRAG as JMobileRAG
from repro_torch.core import store
from repro_torch.core.ecovector import EcoVector
from repro_torch.serving.embedder import HashEmbedder
from repro_torch.serving.rag import MobileRAG

D, NC = 24, 8
# the data's scale: rows of norm ~1.2, like the unit embeddings the index
# serves (the device path's distances, |q|^2 - 2 q.x + |x|^2 in f32, lose
# absolute precision with the norms, so 2e-5 is only meaningful here)
S = 0.05
KW = dict(n_clusters=NC, M=8, ef_construction=40)
# each spill file pickles its HNSW class by module path, once
PICKLE_DIFF = len("repro_torch.core.hnsw") - len("repro.core.hnsw")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(6, D)) * 5
    X = (S * np.concatenate([c + rng.normal(size=(80, D))
                             for c in centers])).astype(np.float32)
    Q = X[::9] + (S * 0.05 * rng.normal(size=X[::9].shape)).astype(
        np.float32)
    return X, Q


def build_pair(X, tmp, **kw):
    kw = dict(KW, **kw)
    ev = EcoVector(D, storage_dir=str(tmp / "port"), device="cpu",
                   **kw).build(X)
    jev = JEcoVector(D, storage_dir=str(tmp / "ref"), **kw).build(X)
    return ev, jev


@pytest.fixture(scope="module")
def built(data, tmp_path_factory):
    return build_pair(data[0], tmp_path_factory.mktemp("eco"))


def assert_same_graph(g, jg):
    assert (g.levels, g.neighbors, g.entry_point, g.max_level) == \
        (jg.levels, jg.neighbors, jg.entry_point, jg.max_level)
    assert (g._ext2int, g._int2ext, g._free, g.is_deleted) == \
        (jg._ext2int, jg._int2ext, jg._free, jg.is_deleted)
    np.testing.assert_array_equal(g.vectors, jg.vectors)
    assert g.n_dist == jg.n_dist


def assert_same_spills(ev, jev):
    for c in range(ev.n_clusters):
        assert_same_graph(store.load_obj(ev._path(c)),
                          jstore.load_obj(jev._path(c)))


def assert_same_pack(ev, jev):
    pack, jpack = ev.device_pack(), jev.device_pack()
    assert pack[3] == jpack[3]
    for a, b in zip(pack[:3], jpack[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def assert_mirror_equal(ev):
    data, lens, cent = ev.device_arrays()
    hdata, hlens, _, _ = ev.device_pack()
    assert torch.equal(data, torch.from_numpy(hdata))
    assert torch.equal(lens, torch.from_numpy(hlens))
    assert data.data_ptr() != hdata.ctypes.data       # a copy, not a view
    return data


def test_build_matches_reference(built):
    ev, jev = built
    assert ev.n_clusters == jev.n_clusters == NC
    np.testing.assert_allclose(ev.centroids, jev.centroids, rtol=1e-5,
                               atol=1e-5)
    assert ev.cluster_members == jev.cluster_members
    assert ev.assign == jev.assign
    assert_same_graph(ev.centroid_graph, jev.centroid_graph)
    assert_same_spills(ev, jev)
    assert sorted(os.listdir(ev.storage_dir)) == \
        sorted(os.listdir(jev.storage_dir))
    assert set(ev.timings) == {"kmeans_s", "centroid_graph_s", "graphs_s"}


@pytest.mark.parametrize("n_probe,k,ef", [(1, 3, 32), (3, 5, 32),
                                          (4, 10, 64), (NC, 20, 32)])
def test_host_search_matches_reference(built, data, n_probe, k, ef):
    ev, jev = built
    _, Q = data
    s0 = (ev.stats.disk_loads, ev.stats.disk_bytes, ev.stats.distance_ops)
    j0 = (jev.stats.disk_loads, jev.stats.disk_bytes, jev.stats.distance_ops)
    for q in Q:
        ids, dists = ev.search(q, k, n_probe=n_probe, ef_search=ef)
        jids, jdists = jev.search(q, k, n_probe=n_probe, ef_search=ef)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(dists, jdists)
    loads = ev.stats.disk_loads - s0[0]
    assert loads == jev.stats.disk_loads - j0[0] == n_probe * len(Q)
    assert (ev.stats.disk_bytes - s0[1]) - (jev.stats.disk_bytes - j0[1]) \
        == PICKLE_DIFF * loads
    assert ev.stats.distance_ops - s0[2] == jev.stats.distance_ops - j0[2]


def test_lru_cache_matches_reference(data, tmp_path):
    X, Q = data
    ev, jev = build_pair(X, tmp_path, cache_clusters=2)
    for q in Q[:20]:
        for idx in (ev, jev):
            idx.search(q, 5, n_probe=3)
        assert list(ev._cache) == list(jev._cache)
    assert ev.stats.disk_loads == jev.stats.disk_loads < 60
    for c in (0, 1, 0, 2, 1):
        for idx in (ev, jev):
            idx._load_cluster(c)
    assert list(ev._cache) == list(jev._cache) == [2, 1]
    assert ev.stats.disk_loads == jev.stats.disk_loads


def corrupt(path):
    with open(path, "r+b") as f:
        f.seek(40)
        b = f.read(1)
        f.seek(40)
        f.write(bytes([b[0] ^ 0xFF]))


def test_quarantine_widen_and_rebuild(data, tmp_path):
    X, Q = data
    ev, jev = build_pair(X, tmp_path)
    for idx in (ev, jev):
        idx.search_device_batched(Q[:4], k=5, n_probe=2)
    q = Q[0]
    victim = int(ev._route(q, 1)[0])
    for idx in (ev, jev):
        corrupt(idx._path(victim))
    with pytest.warns(UserWarning, match="quarantined"):
        ids, dists = ev.search(q, 10, n_probe=3)
    with pytest.warns(UserWarning, match="quarantined"):
        jids, jdists = jev.search(q, 10, n_probe=3)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(dists, jdists)
    assert ev.stats.disk_loads == jev.stats.disk_loads
    assert (ev.stats.corrupt_reads, ev.stats.quarantined) == \
        (jev.stats.corrupt_reads, jev.stats.quarantined) == (1, 1)
    assert os.path.exists(ev._path(victim) + ".quarantined")
    assert ev.cluster_members[victim] == [] and ev.assign == jev.assign
    # the zeroed block reaches the device tensors as one dirty block
    blocks = ev.stats.mirror_blocks
    assert_same_pack(ev, jev)
    assert_mirror_equal(ev)
    assert ev.stats.mirror_blocks == blocks + 1
    for a, b in zip(ev.search_device_batched(Q, k=5, n_probe=3),
                    jev.search_device_batched(Q, k=5, n_probe=3)):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
    # restored from the rows the pack held
    assert ev.rebuild_cluster(victim) == jev.rebuild_cluster(victim) > 0
    assert not os.path.exists(ev._path(victim) + ".quarantined")
    assert_same_spills(ev, jev)
    assert_same_pack(ev, jev)
    for idx in (ev, jev):
        with pytest.raises(store.StoreError if idx is ev
                           else jstore.StoreError, match="salvage"):
            idx.rebuild_cluster(victim)
    assert ev.stats.rebuilt == jev.stats.rebuilt == 1
    np.testing.assert_array_equal(ev.search(q, 10, n_probe=3)[0],
                                  jev.search(q, 10, n_probe=3)[0])


def test_insert_into_quarantined_cluster(data, tmp_path):
    X, Q = data
    ev, jev = build_pair(X, tmp_path)
    for idx in (ev, jev):
        idx.device_pack()
    c = int(ev._route(X[0], 1)[0])
    for idx in (ev, jev):
        corrupt(idx._path(c))
        with pytest.warns(UserWarning, match="quarantined"):
            idx.search(X[0], 5, n_probe=1)
        idx.insert(9_000, X[0] + S * 0.01)
    assert ev.stats.quarantined == jev.stats.quarantined == 0
    assert ev.cluster_members == jev.cluster_members
    assert_same_spills(ev, jev)
    assert_same_pack(ev, jev)
    ids, _ = ev.search_device_batched(X[0] + S * 0.01, k=3, n_probe=2)
    assert 9_000 in ids[0]


def test_pending_graph_heals_corrupt_spill(data, tmp_path):
    X, _ = data
    ev, jev = build_pair(X, tmp_path)
    for idx in (ev, jev):
        idx.device_pack()
        idx.insert(9_100, X[3] + S * 0.02)
        c = idx.assign[9_100]
        corrupt(idx._path(c))
        idx._load_cluster_checked(c)
    assert (ev.stats.rebuilt, ev.stats.corrupt_reads) == \
        (jev.stats.rebuilt, jev.stats.corrupt_reads) == (1, 1)
    assert_same_spills(ev, jev)


def update_ops(X, rows, seed=1):
    """Inserts of perturbed `rows` of X (ids past the corpus), deletes of
    corpus ids and of some new ids, and re-inserts of deleted ids."""
    rng = np.random.default_rng(seed)
    ops = [("insert", 1000 + i, X[int(rng.choice(rows))]
            + (S * 0.05 * rng.normal(size=D)).astype(np.float32))
           for i in range(30)]
    gone = [int(i) for i in rng.choice(len(X), 25, replace=False)]
    ops += [("delete", i, None) for i in gone]
    ops += [("delete", 1000 + i, None) for i in range(0, 30, 4)]
    ops += [("insert", i, X[i]) for i in gone[:10]]
    ops += [("delete", 12345, None)]                  # unknown id: a no-op
    return ops


def apply(idx, ops):
    for op, vid, vec in ops:
        if op == "insert":
            idx.insert(vid, vec)
        else:
            idx.delete(vid)


def test_updates_same_graphs_and_pack(data, tmp_path):
    X, Q = data
    ev, jev = build_pair(X, tmp_path)
    for idx in (ev, jev):
        idx.search_device_batched(Q[:2], k=5, n_probe=2)
    uploads = ev.stats.mirror_uploads
    # the new rows go to the three smallest clusters: CAP does not grow
    small = np.argsort(ev.cluster_sizes())[:3]
    ops = update_ops(X, [v for c in small for v in ev.cluster_members[c]])
    apply(ev, ops)
    apply(jev, ops)
    assert ev.cluster_members == jev.cluster_members
    assert ev.assign == jev.assign
    assert_same_spills(ev, jev)
    assert len(ev._pending_graphs) <= ev.PENDING_GRAPHS_MAX
    assert list(ev._pending_graphs) == list(jev._pending_graphs)
    dirty = len(ev._dirty)
    assert_same_pack(ev, jev)
    for f in ("pack_full_builds", "pack_cluster_repacks", "pack_grows",
              "disk_loads", "truncated_vectors"):
        assert getattr(ev.stats, f) == getattr(jev.stats, f), f
    assert ev.stats.pack_grows == 0
    assert_mirror_equal(ev)
    assert ev.stats.mirror_uploads == uploads
    assert ev.stats.mirror_blocks == dirty
    for n_probe, k in ((2, 5), (4, 10)):
        ids, dists = ev.search_device_batched(Q, k=k, n_probe=n_probe)
        jids, jdists = jev.search_device_batched(Q, k=k, n_probe=n_probe)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(dists, jdists, rtol=2e-5, atol=2e-5)
        for q in Q[:8]:
            a, b = ev.search(q, k, n_probe), jev.search(q, k, n_probe)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    assert ev.stats.distance_ops == jev.stats.distance_ops
    ids, _ = ev.search_device_batched(np.stack([v for op, _, v in ops[:30]]),
                                      k=1, n_probe=NC)
    deleted = {vid for op, vid, _ in ops if op == "delete"} - \
        {vid for op, vid, _ in ops[55:] if op == "insert"}
    assert not set(ids.ravel().tolist()) & deleted
    kept = [i for i, (_, vid, _) in enumerate(ops[:30]) if vid not in deleted]
    assert (ids[kept, 0] == 1000 + np.asarray(kept)).all()


def test_cap_growth_matches_reference(data, tmp_path):
    X, Q = data
    ev, jev = build_pair(X, tmp_path)
    for idx in (ev, jev):
        idx.search_device_batched(Q[:2], k=5, n_probe=2)
    cap0 = ev.device_pack()[3]
    uploads = ev.stats.mirror_uploads
    rng = np.random.default_rng(2)
    new = [X[7] + (S * 0.3 * rng.normal(size=D)).astype(np.float32)
           for _ in range(cap0 + 5)]
    for idx in (ev, jev):
        for j, v in enumerate(new):
            idx.insert(60_000 + j, v)
    assert_same_pack(ev, jev)
    assert ev.device_pack()[3] == 2 * cap0
    assert ev.stats.pack_grows == jev.stats.pack_grows == 1
    assert_mirror_equal(ev)
    assert ev.stats.mirror_uploads == uploads + 1
    ids, dists = ev.search_device_batched(np.stack(new[:5]), k=3, n_probe=2)
    jids, jdists = jev.search_device_batched(np.stack(new[:5]), k=3,
                                             n_probe=2)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(dists, jdists, rtol=2e-5, atol=2e-5)
    assert (ids[:, 0] == 60_000 + np.arange(5)).all()


def test_forced_cap_matches_reference(data, tmp_path):
    X, Q = data
    ev, jev = build_pair(X, tmp_path)
    for idx in (ev, jev):
        with pytest.warns(UserWarning, match="truncates"):
            idx.device_pack(cap=40)
    assert ev.stats.truncated_vectors == jev.stats.truncated_vectors > 0
    assert_same_pack(ev, jev)
    for idx in (ev, jev):
        for j in range(3):
            idx.insert(70_000 + j, X[0] + S * 0.01 * j)
        with pytest.warns(UserWarning, match="truncates"):
            idx.device_pack()
    assert ev.stats.truncated_vectors == jev.stats.truncated_vectors
    assert_same_pack(ev, jev)
    with pytest.raises(ValueError, match="positive"):
        ev.device_pack(cap=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for idx in (ev, jev):
            idx.device_pack(force_full=True)
    assert ev.stats.truncated_vectors == 0
    assert_same_pack(ev, jev)


def test_diverged_bookkeeping_raises(data, tmp_path):
    X, _ = data
    ev, _ = build_pair(X, tmp_path)
    ev.device_pack()
    ev.cluster_members = [m[:1] for m in ev.cluster_members]
    with pytest.raises(RuntimeError, match="diverged"):
        ev.device_pack(force_full=True)


def test_accounting_matches_reference(built, data):
    ev, jev = built
    _, Q = data
    for idx in (ev, jev):
        idx.search_device_batched(Q[:2], k=5, n_probe=2)
    np.testing.assert_array_equal(ev.cluster_sizes(), jev.cluster_sizes())
    sizes = [os.path.getsize(ev._path(c)) - os.path.getsize(jev._path(c))
             for c in range(NC)]
    assert sizes == [PICKLE_DIFF] * NC
    g = store.load_obj(ev._path(0))
    assert len(pickle.dumps(g, protocol=pickle.HIGHEST_PROTOCOL)) - len(
        pickle.dumps(jstore.load_obj(jev._path(0)),
                     protocol=pickle.HIGHEST_PROTOCOL)) == PICKLE_DIFF
    assert ev.disk_bytes() - jev.disk_bytes() == PICKLE_DIFF * NC
    assert ev.avg_cluster_bytes() - jev.avg_cluster_bytes() == PICKLE_DIFF
    assert ev.device_resident_bytes() == jev.device_resident_bytes() > 0
    assert ev.ram_bytes() - jev.ram_bytes() == PICKLE_DIFF


def word_corpus(n_docs, seed, sentences=8, words=7):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(300)]
    return [" ".join(" ".join(rng.choice(vocab, words)).capitalize() + "."
                     for _ in range(sentences)) for _ in range(n_docs)]


def test_mobilerag_host_search_mode(tmp_path):
    docs = word_corpus(96, seed=4)
    emb, jemb = HashEmbedder(dim=32).fit(docs), JHashEmbedder(dim=32).fit(docs)
    vecs = emb(docs)
    ev = EcoVector(32, storage_dir=str(tmp_path / "p"), device="cpu",
                   **KW).build(vecs)
    jev = JEcoVector(32, storage_dir=str(tmp_path / "r"), **KW).build(vecs)
    pipe = MobileRAG(docs, emb, index=ev, device_retrieval=False,
                     device="cpu")
    jpipe = JMobileRAG(docs, jemb, index=jev, device_retrieval=False)
    assert pipe.index is ev and not pipe.device_retrieval
    assert ev._device_pack is None           # host mode makes no pack
    queries = [docs[i].split(". ")[2] for i in range(0, 96, 12)]
    out, jout = pipe.answer_batch(queries), jpipe.answer_batch(queries)
    assert [a.doc_ids for a in out] == [a.doc_ids for a in jout]
    assert [a.prompt for a in out] == [a.prompt for a in jout]
    assert ev.stats.disk_loads == jev.stats.disk_loads == 4 * len(queries)
    dev = MobileRAG(docs, emb, index=ev, device="cpu")
    assert dev.device_retrieval and ev._mirror is not None
    assert [a.doc_ids for a in dev.answer_batch(queries)] == \
        [a.doc_ids for a in jpipe.answer_batch(queries)]
