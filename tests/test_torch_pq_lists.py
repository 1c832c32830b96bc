"""IVFPQ's device pack and `pq_adc` over segments of it, against the JAX
package on the CPU, on the data of tests/test_baselines.py (720 x 24, 12
clusters) at m_pq 8 and 12, where numpy's pairwise sum order differs from
an in-order sum: the port's IVFPQ and IVFPQ-DISK return the reference's
ids and distances bit for bit (ROADMAP Queue C, F9); `ref.pq_adc` is
numpy's row sum bit for bit; the segment call equals the flat call on
the stacked codes; insert and delete keep the pack in step with the
reference; IVFPQ-DISK keeps no pack and the reference's stats."""
import numpy as np
import pytest
import torch

from repro.core.baselines import make_index as j_make_index
from repro_torch.core.baselines import make_index
from repro_torch.kernels import ops, ref

PQ_NAMES = ["IVFPQ", "IVFPQ-DISK"]
M_PQ = [8, 12]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(6, 24)) * 5
    X = np.concatenate([c + rng.normal(size=(120, 24))
                        for c in centers]).astype(np.float32)
    Q = X[:10] + 0.01 * rng.normal(size=(10, 24)).astype(np.float32)
    return X, Q


def _pair(name, m_pq, X):
    kw = dict(n_clusters=12, m_pq=m_pq)
    return (make_index(name, 24, device="cpu", **kw).build(X),
            j_make_index(name, 24, **kw).build(X))


@pytest.fixture(scope="module")
def built(data):
    X, _ = data
    return {(n, m): _pair(n, m, X) for n in PQ_NAMES for m in M_PQ}


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("n_probe", [3, 6])
@pytest.mark.parametrize("m_pq", M_PQ)
@pytest.mark.parametrize("name", PQ_NAMES)
def test_search_bit_equal_to_reference(built, data, name, m_pq, n_probe):
    """F9: the ADC sums in numpy's order give the reference's distances
    bit for bit, and so its ids."""
    idx, jidx = built[(name, m_pq)]
    np.testing.assert_array_equal(idx.pq.codebooks, jidx.pq.codebooks)
    for q in data[1]:
        ids, d = idx.search(q, k=10, n_probe=n_probe)
        jids, jd = jidx.search(q, k=10, n_probe=n_probe)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(_bits(d), _bits(jd))


@pytest.mark.parametrize("M", [4, 5, 8, 12, 16, 130])
def test_ref_pq_adc_is_numpy_sum(M):
    """Bit-equal to the reference's `tabs[arange(M)[None], codes]
    .sum(axis=1)`, numpy's pairwise order (M 130: past its 128 block)."""
    rng = np.random.default_rng(M)
    tabs = rng.random((2, M, 256), dtype=np.float32) * 100
    codes = rng.integers(0, 256, (700, M)).astype(np.uint8)
    codes[0], codes[-1] = 255, 0
    got = ops.pq_adc(torch.tensor(tabs), torch.tensor(codes)).numpy()
    for b in range(2):
        want = tabs[b][np.arange(M)[None], codes.astype(np.int64)].sum(axis=1)
        np.testing.assert_array_equal(_bits(got[b]), _bits(want))


def test_ref_pq_adc_code_past_table_adds_nan():
    lut = torch.rand(1, 5, 16)
    codes = torch.randint(0, 16, (6, 5), dtype=torch.uint8)
    codes[2, 3] = 16
    got = ref.pq_adc(lut, codes)[0]
    assert torch.isnan(got[2]) and not torch.isnan(got[[0, 1, 3, 4, 5]]).any()


SEGMENTS = {
    "probes": ([5, 0, 30, 31, 12], [4, 0, 1, 9, 7]),  # empty, one row, odd
    "one segment": ([0], [64]),
    "all empty": ([3, 40, 0], [0, 0, 0]),
}


@pytest.mark.parametrize("layout", SEGMENTS)
@pytest.mark.parametrize("M,K", [(8, 256), (5, 16)])
def test_segments_equal_flat_call(layout, M, K):
    """The segment call equals the flat call on the stacked rows, for B 1
    and 3 queries."""
    starts, lens = (np.array(v, np.int32) for v in SEGMENTS[layout])
    rng = np.random.default_rng(1)
    codes = torch.tensor(rng.integers(0, K, (64, M)).astype(np.uint8))
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                           dtype=torch.int32)
    rows = np.concatenate([np.arange(s, s + n) for s, n in zip(starts, lens)]
                          ).astype(np.int64)
    for B in (1, 3):
        lut = torch.tensor(rng.random((B, M, K), dtype=np.float32))
        got = ops.pq_adc(lut, codes, torch.tensor(starts), offsets,
                         rows=int(lens.sum()))
        assert got.shape == (B, int(lens.sum()))
        assert torch.equal(got, ops.pq_adc(lut, codes[rows]))


def test_segment_rows_outside_the_codes_score_nan():
    lut = torch.rand(1, 4, 256)
    codes = torch.randint(0, 256, (10, 4), dtype=torch.uint8)
    got = ref.pq_adc_segments(lut, codes, torch.tensor([8], dtype=torch.int32),
                              torch.tensor([0, 4], dtype=torch.int32))[0]
    assert not torch.isnan(got[:2]).any() and torch.isnan(got[2:]).all()


def test_segment_wrapper_rejects_bad_segments():
    lut, codes = torch.rand(1, 4, 256), torch.zeros(9, 4, dtype=torch.uint8)
    st = torch.tensor([0, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="rows"):
        ops.pq_adc(lut, codes, st, torch.tensor([0, 2, 5], dtype=torch.int32))
    with pytest.raises(ValueError, match="offsets"):
        ops.pq_adc(lut, codes, st, torch.tensor([0, 2], dtype=torch.int32),
                   rows=2)
    for bad in ([1, 2, 5], [0, 4, 2], [0, 2, 5]):
        with pytest.raises(ValueError, match="rise"):
            ops.pq_adc(lut, codes, st, torch.tensor(bad, dtype=torch.int32),
                       rows=6)
    with pytest.raises(TypeError):
        ops.pq_adc(lut, codes, st.long(), torch.tensor([0, 2, 5]), rows=5)


@pytest.mark.parametrize("m_pq", M_PQ)
def test_pack_holds_the_reference_lists(built, m_pq):
    """pack[pack_offsets[c]:pack_offsets[c+1]] is list c's codes in its
    id order, as the reference's codes dict holds them."""
    idx, jidx = built[("IVFPQ", m_pq)]
    assert idx.pack.dtype == torch.uint8 and idx.pack.shape == (720, m_pq)
    assert idx.pack_offsets[0] == 0 and idx.pack_offsets[-1] == 720
    pack = idx.pack.numpy()
    for c, ids in enumerate(jidx.lists):
        a, b = idx.pack_offsets[c], idx.pack_offsets[c + 1]
        want = (np.stack([jidx.codes[int(i)] for i in ids]) if len(ids)
                else np.zeros((0, m_pq), np.uint8))
        np.testing.assert_array_equal(pack[a:b], want)


class _NoLookups(dict):
    def __getitem__(self, key):
        raise AssertionError("search read a code id by id")


def test_search_is_one_call_over_the_pack(built, data, monkeypatch):
    """IVFPQ.search reads no code from the dict and makes one `pq_adc`
    call, with segments, over the pack."""
    idx, jidx = built[("IVFPQ", 8)]
    calls = []
    real = ops.pq_adc

    def spy(lut, codes, *seg, **kw):
        calls.append((codes is idx.pack, len(seg)))
        return real(lut, codes, *seg, **kw)
    monkeypatch.setattr(ops, "pq_adc", spy)
    monkeypatch.setattr(idx, "codes", _NoLookups(idx.codes))
    q = data[1][0]
    ids, d = idx.search(q, k=10, n_probe=6)
    assert calls == [(True, 2)]
    jids, jd = jidx.search(q, k=10, n_probe=6)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(_bits(d), _bits(jd))


def test_insert_and_delete_keep_the_pack_in_step(data):
    """After inserts the pack is rebuilt before the next search: the new
    ids are found, ids and distances bit-equal to the reference's. A
    delete raises in both (F6) after editing the lists; the next search
    still agrees."""
    X, Q = data
    idx, jidx = _pair("IVFPQ", 8, X)
    for i in (idx, jidx):
        i.insert(50_000, X[0] + 0.001)
        i.insert(50_001, X[300] - 0.001)
    queries = (X[0], X[300], Q[3])
    for q in queries:
        ids, d = idx.search(q, k=5, n_probe=6)
        jids, jd = jidx.search(q, k=5, n_probe=6)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(_bits(d), _bits(jd))
    assert idx.pack.shape[0] == 722 and idx.pack_offsets[-1] == 722
    assert 50_000 in set(map(int, idx.search(X[0], k=5, n_probe=6)[0]))
    assert 50_001 in set(map(int, idx.search(X[300], k=5, n_probe=6)[0]))
    for i in (idx, jidx):
        with pytest.raises(AttributeError):
            i.delete(7)
    for q in queries:
        ids, d = idx.search(q, k=10, n_probe=12)
        jids, jd = jidx.search(q, k=10, n_probe=12)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(_bits(d), _bits(jd))
    assert 7 not in set(map(int, ids)) and idx.pack.shape[0] == 721


@pytest.mark.parametrize("m_pq", M_PQ)
def test_disk_keeps_no_pack_and_the_reference_stats(built, data, m_pq):
    idx, jidx = built[("IVFPQ-DISK", m_pq)]
    assert idx.pack is None and not idx.codes
    idx.stats.reset()
    jidx.stats.reset()
    for n_probe in (3, 6):
        for q in data[1]:
            idx.search(q, k=10, n_probe=n_probe)
            jidx.search(q, k=10, n_probe=n_probe)
    for f in ("distance_ops", "disk_loads", "disk_bytes"):
        assert getattr(idx.stats, f) == getattr(jidx.stats, f), f
    assert idx.stats.disk_loads == 9 * len(data[1])
    assert idx.ram_bytes() == jidx.ram_bytes()


def test_a_query_with_only_empty_lists_returns_empty(data):
    """Every probed list empty: no launch, the reference's empty result."""
    X, _ = data
    far = np.full(24, 1e6, np.float32)
    results = []
    for idx in _pair("IVFPQ", 8, X):
        idx.lists = [np.zeros(0, np.int64) if c < 3 else l
                     for c, l in enumerate(idx.lists)]
        idx.centroids[:3] = far + np.arange(3, dtype=np.float32)[:, None]
        idx._pack_stale = True             # the port's pack follows lists
        results.append(idx.search(far, k=5, n_probe=3))
    for ids, d in results:
        assert ids.shape == d.shape == (0,)
        assert ids.dtype == np.int64 and d.dtype == np.float32
