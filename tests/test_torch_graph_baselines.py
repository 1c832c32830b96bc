"""The port's graph baselines against the JAX package's on the CPU (480 x
24 vectors in 6 blobs; M 8, efc 40, 12 clusters, m_pq 4): HNSW's graph,
search ids and distances, stats and `ram_bytes` equal, also after
inserts and deletes; HNSWPQ's codes equal and its graph over the PQ
reconstructions equal (on the reference's codebooks, which the port's
k-means meets within 1e-5), with equal searches and `ram_bytes`;
IVF-HNSW's lists and centroid graph equal, searches, disk stats and
`ram_bytes` equal; `make_index` builds every name of the reference's
`make_index` as the same class."""
import numpy as np
import pytest

from repro.core.baselines import ALL_BASELINES as J_ALL_BASELINES
from repro.core.baselines import make_index as j_make_index
from repro_torch.core.baselines import ALL_BASELINES, make_index

D = 24
GRAPH = dict(M=8, ef_construction=40)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(6, D)) * 5
    X = np.concatenate([c + rng.normal(size=(80, D))
                        for c in centers]).astype(np.float32)
    Q = X[::11] + 0.05 * rng.normal(size=X[::11].shape).astype(np.float32)
    return X, Q


def assert_same_graph(g, jg):
    assert (g.levels, g.neighbors, g.entry_point, g.max_level) == \
        (jg.levels, jg.neighbors, jg.entry_point, jg.max_level)
    assert (g._ext2int, g._int2ext, g._free, g.is_deleted) == \
        (jg._ext2int, jg._int2ext, jg._free, jg.is_deleted)
    np.testing.assert_array_equal(g.vectors, jg.vectors)


def assert_same_search(idx, jidx, Q, **kw):
    for q in Q:
        ids, d = idx.search(q, **kw)
        jids, jd = jidx.search(q, **kw)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(d, jd)
    assert idx.stats.distance_ops == jidx.stats.distance_ops


def test_hnsw_index_matches_reference(data):
    X, Q = data
    idx = make_index("HNSW", D, device="cpu", **GRAPH).build(X)
    jidx = j_make_index("HNSW", D, **GRAPH).build(X)
    assert_same_graph(idx.g, jidx.g)
    assert idx.ram_bytes() == jidx.ram_bytes()
    for k, ef in ((1, 16), (10, 64)):
        assert_same_search(idx, jidx, Q, k=k, ef_search=ef)
    rng = np.random.default_rng(1)
    for h in (idx, jidx):
        for i in range(0, 480, 9):
            h.delete(i)
        for j in range(20):
            h.insert(5_000 + j, X[j] + 0.01 * j)
        h.insert(0, X[0])
    assert_same_graph(idx.g, jidx.g)
    assert_same_search(idx, jidx, Q + 0.01 * rng.normal(size=Q.shape)
                       .astype(np.float32), k=10, ef_search=32)
    assert idx.ram_bytes() == jidx.ram_bytes()


def test_hnswpq_matches_reference(data):
    X, Q = data
    kw = dict(GRAPH, m_pq=4)
    idx = make_index("HNSWPQ", D, device="cpu", **kw).build(X)
    jidx = j_make_index("HNSWPQ", D, **kw).build(X)
    np.testing.assert_allclose(idx.pq.codebooks, jidx.pq.codebooks,
                               rtol=1e-5, atol=1e-5)
    assert idx.codes.keys() == jidx.codes.keys()
    for i in idx.codes:
        np.testing.assert_array_equal(idx.codes[i], jidx.codes[i])
    # the graph over the reconstructions, from the reference's codebooks
    same = make_index("HNSWPQ", D, device="cpu", **kw)
    same.pq.train = lambda x: setattr(same.pq, "codebooks",
                                      jidx.pq.codebooks.copy())
    same.build(X)
    assert_same_graph(same.g, jidx.g)
    assert_same_search(same, jidx, Q, k=10, ef_search=64)
    assert idx.ram_bytes() == same.ram_bytes() == jidx.ram_bytes()


def test_ivf_hnsw_matches_reference(data):
    X, Q = data
    idx = make_index("IVF-HNSW", D, n_clusters=12, device="cpu").build(X)
    jidx = j_make_index("IVF-HNSW", D, n_clusters=12).build(X)
    np.testing.assert_allclose(idx.centroids, jidx.centroids, rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(idx.lists, jidx.lists):
        np.testing.assert_array_equal(a, b)
    assert_same_graph(idx.centroid_graph, jidx.centroid_graph)
    for n_probe in (1, 3, 6):
        assert_same_search(idx, jidx, Q, k=10, n_probe=n_probe)
    assert idx.stats.disk_loads == jidx.stats.disk_loads == \
        len(Q) * (1 + 3 + 6)
    assert idx.stats.disk_bytes == jidx.stats.disk_bytes
    assert idx.ram_bytes() == jidx.ram_bytes()


@pytest.mark.parametrize("name", J_ALL_BASELINES)
def test_make_index_builds_every_name(name, data):
    X, Q = data
    kw = {"IVFPQ": dict(m_pq=4), "HNSWPQ": dict(GRAPH, m_pq=4),
          "IVFPQ-DISK": dict(m_pq=4), "HNSW": GRAPH,
          "EcoVector": dict(GRAPH)}.get(name, {})
    if name not in ("HNSW", "HNSWPQ"):
        kw["n_clusters"] = 8
    idx = make_index(name, D, device="cpu", **kw).build(X[:200])
    jidx = j_make_index(name, D, **kw).build(X[:200])
    assert type(idx).__name__ == type(jidx).__name__
    assert getattr(idx, "name", name) == getattr(jidx, "name", name)
    ids, _ = idx.search(Q[0], k=5)
    jids, _ = jidx.search(Q[0], k=5)
    np.testing.assert_array_equal(ids, jids)
    assert ALL_BASELINES == J_ALL_BASELINES
