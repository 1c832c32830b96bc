"""The port's HNSW against the JAX package's on the CPU: after the same
operations the two graphs are equal (levels, neighbour lists on every
layer, entry point, max level, id maps and free slots, vectors, RNG
state, distance counter), under inserts, deletes, delete-all-then-
reinsert, heavy churn with slot reuse, huge external ids and alpha
pruning; searches return the same ids and the same f32 distances;
`memory_bytes`, `graph_arrays` and `reconstruct` are equal; `save`/`load`
round-trips through the port's segment store. Sizes: d <= 32, M 8,
efc 40, at most 400 inserts a scenario."""
import numpy as np
import pytest

from repro.core.hnsw import HNSW as JHNSW
from repro_torch.core import store
from repro_torch.core.hnsw import HNSW

D = 24


def assert_same_graph(g, jg):
    assert g.levels == jg.levels
    assert g.neighbors == jg.neighbors
    assert (g.entry_point, g.max_level) == (jg.entry_point, jg.max_level)
    assert g._ext2int == jg._ext2int
    assert g._int2ext == jg._int2ext
    assert g._free == jg._free
    assert g.is_deleted == jg.is_deleted
    np.testing.assert_array_equal(g.vectors, jg.vectors)
    assert (g.n_dist, g._count) == (jg.n_dist, jg._count)
    assert g.rng.bit_generator.state == jg.rng.bit_generator.state
    assert vars(g).keys() == vars(jg).keys()


def replay(ops, X, **kw):
    """Apply the same (op, id, row) sequence to both graphs."""
    kw = dict(dict(M=8, ef_construction=40, seed=3, max_elements=8), **kw)
    g, jg = HNSW(D, **kw), JHNSW(D, **kw)
    for op, vid, row in ops:
        for h in (g, jg):
            if op == "insert":
                h.insert(vid, X[row])
            else:
                h.delete(vid)
    return g, jg


def churn_ops(n_ops, pool, seed, p_delete=0.4, ids=None):
    rng = np.random.default_rng(seed)
    live, ops = set(), []
    for _ in range(n_ops):
        i = int(rng.integers(pool))
        vid = i if ids is None else ids[i]
        if vid in live and rng.random() < p_delete * 2:
            ops.append(("delete", vid, i))
            live.discard(vid)
        else:
            ops.append(("insert", vid, int(rng.integers(len(X_ALL)))))
            live.add(vid)
    return ops


X_ALL = np.random.default_rng(0).standard_normal((600, D)).astype(np.float32)
SCENARIOS = {
    "inserts": [("insert", i, i) for i in range(300)],
    "inserts_then_deletes": [("insert", i, i) for i in range(200)]
    + [("delete", i, i) for i in range(0, 200, 3)],
    "delete_all_then_reinsert": [("insert", i, i) for i in range(60)]
    + [("delete", i, i) for i in range(60)]
    + [("insert", i, 100 + i) for i in range(60)],
    "heavy_churn": churn_ops(400, 80, seed=1),
    "huge_ids": churn_ops(300, 100, seed=2,
                          ids=[10**15 + 7 * i for i in range(100)]),
    "reinsert_same_id": [("insert", i, i) for i in range(80)]
    + [("insert", 5, 300), ("insert", 9, 301), ("delete", 5, 0),
       ("insert", 5, 302)],
}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def graphs(request):
    return request.param, replay(SCENARIOS[request.param], X_ALL)


def test_graph_equal(graphs):
    _, (g, jg) = graphs
    assert_same_graph(g, jg)


def test_search_equal(graphs):
    _, (g, jg) = graphs
    Q = X_ALL[::37] + 0.1 * np.random.default_rng(4).standard_normal(
        (len(X_ALL[::37]), D)).astype(np.float32)
    for k, ef in ((1, 16), (5, 32), (10, 64)):
        for q in Q:
            ids, dists = g.search(q, k, ef_search=ef)
            jids, jdists = jg.search(q, k, ef_search=ef)
            np.testing.assert_array_equal(ids, jids)
            assert dists.dtype == jdists.dtype
            np.testing.assert_array_equal(dists, jdists)
    assert g.n_dist == jg.n_dist


def test_accounting_and_export_equal(graphs):
    _, (g, jg) = graphs
    assert len(g) == len(jg)
    assert g.memory_bytes() == jg.memory_bytes()
    ids, vecs = g.graph_arrays()
    jids, jvecs = jg.graph_arrays()
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(vecs, jvecs)
    for vid in ids[:10]:
        np.testing.assert_array_equal(g.reconstruct(int(vid)),
                                      jg.reconstruct(int(vid)))


@pytest.mark.parametrize("alpha", [1.2, 0.8])
def test_alpha_pruning_equal(alpha):
    ops = [("insert", i, i) for i in range(150)] + \
        [("delete", i, i) for i in range(0, 150, 4)]
    assert_same_graph(*replay(ops, X_ALL, alpha=alpha))


def test_forced_levels_and_empty_graph():
    g, jg = replay([("insert", i, i) for i in range(40)], X_ALL)
    for h in (g, jg):
        h.insert(1000, X_ALL[500], level=3)
        h.insert(1001, X_ALL[501], level=0)
    assert_same_graph(g, jg)
    e, je = HNSW(D), JHNSW(D)
    for a, b in zip(e.search(X_ALL[0], 3), je.search(X_ALL[0], 3)):
        np.testing.assert_array_equal(a, b)
    e.delete(7)
    je.delete(7)
    assert_same_graph(e, je)


@pytest.mark.parametrize("cap", [1, 3, 32])
def test_robust_prune_equal(cap):
    """The port's prune (one distance call a choice) picks what the
    reference's (one call a candidate) picks, on the same graph."""
    g, jg = replay([("insert", i, i) for i in range(120)], X_ALL)
    rng = np.random.default_rng(cap)
    for _ in range(30):
        cand = [int(c) for c in rng.choice(120, int(rng.integers(1, 60)),
                                           replace=False)]
        vec = X_ALL[int(rng.integers(600))]
        assert g.robust_prune(cand, vec, cap) == jg.robust_prune(cand, vec,
                                                                  cap)


def test_save_load_round_trip(tmp_path):
    g, _ = replay(SCENARIOS["delete_all_then_reinsert"], X_ALL)
    path = str(tmp_path / "g.seg")
    g.save(path)
    h = HNSW.load(path)
    assert_same_graph(h, g)
    assert store.read_segment(path)[0]["kind"] == HNSW.SEGMENT_KIND
    with open(path, "r+b") as f:
        f.seek(-5, 2)
        f.write(b"\xff")
    with pytest.raises(store.CorruptSegmentError):
        HNSW.load(path)
    store.dump_obj(path, {"not": "a graph"}, kind=HNSW.SEGMENT_KIND)
    with pytest.raises(store.CorruptSegmentError, match="not HNSW"):
        HNSW.load(path)
