"""The port's IVF baselines (IVF, IVFPQ, IVF-DISK, IVFPQ-DISK), PQ and
segment store against the JAX package on the CPU, on the data of
tests/test_baselines.py (720 x 24, 12 clusters, m_pq 4): centroids and PQ
codebooks within 1e-5 (k-means sums in another order), identical
inverted lists and codes, identical search ids with distances within
1e-5 (the ADC sums in another order) at n_probe 3 and 6, identical
`ram_bytes` and disk stats, insert/delete parity for IVF and IVF-DISK,
list files readable across the two packages, and the synthetic SIFT- and
NYTimes-like arrays identical."""
import os

import numpy as np
import pytest
import torch

from repro.core import store as jstore
from repro.core.baselines import make_index as j_make_index
from repro.core.pq import PQ as JPQ
from repro.data.synthetic import nytimes_like as j_nytimes_like
from repro.data.synthetic import sift_like as j_sift_like
from repro_torch.core import store
from repro_torch.core.baselines import make_index
from repro_torch.core.pq import PQ
from repro_torch.data.synthetic import nytimes_like, sift_like
from repro_torch.kernels import ops

NAMES = ["IVF", "IVFPQ", "IVF-DISK", "IVFPQ-DISK"]
PQ_NAMES = ["IVFPQ", "IVFPQ-DISK"]
KW = {"IVF": {"n_clusters": 12}, "IVFPQ": {"n_clusters": 12, "m_pq": 4},
      "IVF-DISK": {"n_clusters": 12},
      "IVFPQ-DISK": {"n_clusters": 12, "m_pq": 4}}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(6, 24)) * 5
    X = np.concatenate([c + rng.normal(size=(120, 24))
                        for c in centers]).astype(np.float32)
    Q = X[:10] + 0.01 * rng.normal(size=(10, 24)).astype(np.float32)
    return X, Q


@pytest.fixture(scope="module")
def built(data):
    X, _ = data
    return {n: (make_index(n, 24, device="cpu", **KW[n]).build(X),
                j_make_index(n, 24, **KW[n]).build(X)) for n in NAMES}


def _codes(idx):
    """Every vector's code, from RAM or from the list files."""
    if not idx.codes:
        return {int(i): c for cl in range(idx.n_clusters)
                for i, c in zip(*idx._load_list(cl))}
    return idx.codes


@pytest.mark.parametrize("name", NAMES)
def test_partition_matches_reference(built, name):
    idx, jidx = built[name]
    assert idx.n_clusters == jidx.n_clusters == 12
    np.testing.assert_allclose(idx.centroids, jidx.centroids, rtol=1e-5,
                               atol=1e-5)
    assert len(idx.lists) == len(jidx.lists)
    for a, b in zip(idx.lists, jidx.lists):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", PQ_NAMES)
def test_pq_codebooks_and_codes_match(built, name):
    idx, jidx = built[name]
    np.testing.assert_allclose(idx.pq.codebooks, jidx.pq.codebooks,
                               rtol=1e-5, atol=1e-5)
    codes, jcodes = _codes(idx), _codes(jidx)
    assert codes.keys() == jcodes.keys() and len(codes) == 720
    for i in codes:
        np.testing.assert_array_equal(codes[i], jcodes[i])


@pytest.mark.parametrize("n_probe", [3, 6])
@pytest.mark.parametrize("name", NAMES)
def test_search_matches_reference(built, data, name, n_probe):
    idx, jidx = built[name]
    _, Q = data
    idx.stats.reset()
    jidx.stats.reset()
    for q in Q:
        ids, d = idx.search(q, k=10, n_probe=n_probe)
        jids, jd = jidx.search(q, k=10, n_probe=n_probe)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-5)
        assert ids.dtype == np.int64 and d.dtype == np.float32
    for f in ("distance_ops", "disk_loads", "disk_bytes"):
        assert getattr(idx.stats, f) == getattr(jidx.stats, f), f
    assert idx.ram_bytes() == jidx.ram_bytes()
    if name.endswith("DISK"):
        assert idx.stats.disk_loads == n_probe * len(Q)


@pytest.mark.parametrize("name", ["IVF", "IVF-DISK"])
def test_insert_delete_parity(data, name):
    X, _ = data
    idx = make_index(name, 24, device="cpu", **KW[name]).build(X)
    jidx = j_make_index(name, 24, **KW[name]).build(X)
    for i in (idx, jidx):
        i.insert(50_000, X[0] + 0.001)
        i.insert(50_001, X[300] - 0.001)
    for q in (X[0], X[300]):
        ids, d = idx.search(q, k=5, n_probe=6)
        jids, jd = jidx.search(q, k=5, n_probe=6)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-5)
    assert 50_000 in set(map(int, idx.search(X[0], k=5, n_probe=6)[0]))
    for i in (idx, jidx):
        i.delete(50_000)
        i.delete(7)
    ids, _ = idx.search(X[0], k=10, n_probe=6)
    np.testing.assert_array_equal(ids, jidx.search(X[0], k=10, n_probe=6)[0])
    assert not {50_000, 7} & set(map(int, ids))
    assert idx.ram_bytes() == jidx.ram_bytes()
    for a, b in zip(idx.lists, jidx.lists):
        np.testing.assert_array_equal(a, b)


def test_ivfpq_disk_insert_leaves_list_files(data):
    """The reference's IVFPQ-DISK insert (IVFPQ's) updates the in-RAM id
    list but never rewrites the list file, so search does not find the
    new id; the port mirrors it (ROADMAP Queue C, F6)."""
    X, _ = data
    idx = make_index("IVFPQ-DISK", 24, device="cpu",
                     **KW["IVFPQ-DISK"]).build(X)
    jidx = j_make_index("IVFPQ-DISK", 24, **KW["IVFPQ-DISK"]).build(X)
    for i in (idx, jidx):
        i.insert(50_000, X[0] + 0.001)
        assert 50_000 not in set(map(int, i.search(X[0], k=5,
                                                   n_probe=12)[0]))
    assert idx.ram_bytes() == jidx.ram_bytes()


@pytest.mark.parametrize("name", PQ_NAMES)
def test_pq_delete_mirrors_reference(built, name):
    """The reference's IVFPQ.delete reaches IVF.delete, which pops
    `self.vecs`, an attribute IVFPQ never sets; the port mirrors it
    (ROADMAP Queue C, F6)."""
    for idx in built[name]:
        with pytest.raises(AttributeError):
            idx.delete(10**9)


def test_pq_adc_scores_with_reference_codebooks(data):
    """encode / adc_table / adc_scores / decode with the reference's
    codebooks copied into the port's PQ (independent of training)."""
    X, Q = data
    jpq = JPQ(24, 4).train(X[:400], iters=4)
    pq = PQ(24, 4, device="cpu")
    pq.codebooks = jpq.codebooks.copy()
    codes = pq.encode(X)
    np.testing.assert_array_equal(codes, jpq.encode(X))
    np.testing.assert_array_equal(pq.decode(codes), jpq.decode(codes))
    np.testing.assert_array_equal(pq.adc_table(Q[0]), jpq.adc_table(Q[0]))
    before = ops.launch_counts()["pq_adc"]
    np.testing.assert_allclose(pq.adc_scores(Q[0], codes),
                               jpq.adc_scores(Q[0], codes),
                               rtol=1e-5, atol=1e-5)
    assert ops.launch_counts()["pq_adc"] == before   # CPU: plain version
    assert pq.memory_bytes(720) == jpq.memory_bytes(720)


@pytest.mark.parametrize("nbits,iters", [(8, 8), (4, 3)])
def test_pq_train_matches_reference(nbits, iters):
    """Training where no k-means cluster empties (more points per
    centroid than the reseed path needs): codebooks within 1e-5."""
    x = np.random.default_rng(nbits).standard_normal(
        (2048, 16)).astype(np.float32)
    pq = PQ(16, 2, nbits, device="cpu").train(x, iters=iters)
    jpq = JPQ(16, 2, nbits).train(x, iters=iters)
    np.testing.assert_allclose(pq.codebooks, jpq.codebooks, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(pq.encode(x[:300]), jpq.encode(x[:300]))


def test_list_files_cross_package(tmp_path):
    ids = np.arange(5, dtype=np.int64)
    vecs = np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    jstore.dump_obj(a, (ids, vecs), kind="ivf.list")
    store.dump_obj(b, (ids, vecs), kind="ivf.list")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    for load, path in ((store.load_obj, a), (jstore.load_obj, b)):
        got_ids, got_vecs = load(path, kind="ivf.list")
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_array_equal(got_vecs, vecs)
    with pytest.raises(store.CorruptSegmentError):
        store.load_obj(a, kind="other")
    blob = bytearray(open(a, "rb").read())
    blob[-3] ^= 0x40
    with open(a, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(store.CorruptSegmentError, match="CRC"):
        store.load_obj(a, kind="ivf.list")
    assert not os.path.exists(b + ".tmp")


@pytest.mark.parametrize("name", ["HNSW", "HNSWPQ", "IVF-HNSW", "EcoVector"])
def test_unported_indexes_raise(name, data):
    """The graph indexes build through `make_index` as the reference's
    do (same class names) and answer a search with k ids; their parity
    is in test_torch_graph_baselines.py."""
    X, Q = data
    graph = dict(M=8, ef_construction=32)
    kw = {"HNSW": graph, "HNSWPQ": dict(graph, m_pq=4),
          "IVF-HNSW": dict(n_clusters=12),
          "EcoVector": dict(graph, n_clusters=12)}[name]
    idx = make_index(name, 24, device="cpu", **kw).build(X[:240])
    jidx = j_make_index(name, 24, **kw)
    assert type(idx).__name__ == type(jidx).__name__
    ids, dists = idx.search(Q[0], k=5)
    assert len(ids) == len(dists) == 5 and ids[0] == 0


def test_synthetic_vectors_identical():
    for port, ref, kw in ((sift_like, j_sift_like, dict(n=500, nq=20)),
                          (nytimes_like, j_nytimes_like,
                           dict(n=400, nq=10, seed=3))):
        for a, b in zip(port(**kw), ref(**kw)):
            np.testing.assert_array_equal(a, b)


def test_pq_adc_wrapper_rejects_bad_inputs():
    lut = torch.zeros(1, 4, 256)
    with pytest.raises(TypeError):
        ops.pq_adc(lut, torch.zeros(3, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.pq_adc(torch.zeros(1, 4, 300), torch.zeros(3, 4,
                                                       dtype=torch.uint8))
    with pytest.raises(ValueError):
        ops.pq_adc(lut, torch.zeros(3, 5, dtype=torch.uint8))
