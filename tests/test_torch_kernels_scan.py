"""The port's retrieval-scan kernel functions (ecoscan, route_topk,
kmeans_assign) against the JAX package's Pallas kernels (interpret mode)
and pure-jnp oracles, on the sweeps and edge cases of
tests/test_kernels.py. On the CPU the port's wrappers run their plain
PyTorch versions; chip_smoke.py holds the CUDA kernels to those versions
on the card. Inputs are numpy arrays from a seed, fed to both packages.

Tolerances: ids, probes and slots exact; ecoscan/route values 2e-5 (f32
sums in another order); kmeans_assign sqdist 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ecoscan import ecoscan as j_ecoscan
from repro.kernels.ecoscan import route_topk as j_route_topk
from repro.kernels.kmeans_assign import kmeans_assign as j_kmeans_assign
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref


def _rng(i):
    return np.random.default_rng(i)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eco_inputs(B, d, NC, CAP, P, lo=None, seed=0):
    r = _rng(seed)
    q = r.standard_normal((B, d)).astype(np.float32)
    data = r.standard_normal((NC, CAP, d)).astype(np.float32)
    lens = r.integers(CAP // 2 if lo is None else lo, CAP + 1,
                      NC).astype(np.int32)
    probes = np.stack([r.permutation(NC)[:P] for _ in range(B)]).astype(
        np.int32)
    return q, data, lens, probes


def _eco_check(q, data, lens, probes, k, block_map=None):
    bm_t = None if block_map is None else _t(block_map)
    dt, it = ops.ecoscan(_t(q), _t(data), _t(lens), _t(probes), k,
                         block_map=bm_t)
    bm_j = None if block_map is None else jnp.asarray(block_map)
    dk, ik = j_ecoscan(jnp.asarray(q), jnp.asarray(data), jnp.asarray(lens),
                       jnp.asarray(probes), k=k, block_map=bm_j)
    dr, ir = jref.ecoscan(jnp.asarray(q), jnp.asarray(data),
                          jnp.asarray(lens), jnp.asarray(probes), k,
                          block_map=bm_j)
    for d_j, i_j in ((dk, ik), (dr, ir)):
        np.testing.assert_allclose(dt.numpy(), np.asarray(d_j),
                                   rtol=2e-5, atol=2e-5)
        assert (it.numpy() == np.asarray(i_j)).all()
    return dt.numpy(), it.numpy()


@pytest.mark.parametrize("B,d,NC,CAP,P,K", [
    (2, 32, 8, 64, 2, 5),
    (4, 128, 16, 128, 4, 10),
    (1, 64, 5, 96, 5, 8),
])
def test_ecoscan_sweep(B, d, NC, CAP, P, K):
    _eco_check(*_eco_inputs(B, d, NC, CAP, P), K)


def test_ecoscan_exhausted_empty_and_padded_probes():
    q = np.zeros((1, 16), np.float32)
    data = np.zeros((4, 32, 16), np.float32)
    _, ids = _eco_check(q, data, np.asarray([3, 0, 0, 0], np.int32),
                        np.asarray([[0, 1]], np.int32), 6)
    assert sorted(ids[0, :3]) == [0, 1, 2] and (ids[0, 3:] == -1).all()
    q, data, _, _ = _eco_inputs(2, 16, 4, 32, 2, seed=1)
    _, ids = _eco_check(q, data, np.asarray([0, 5, 0, 0], np.int32),
                        np.asarray([[0, 2], [2, 3]], np.int32), 4)
    assert (ids == -1).all()
    full = np.full(4, 32, np.int32)
    _, ids = _eco_check(q, data, full, -np.ones((2, 3), np.int32), 4)
    assert (ids == -1).all()
    _eco_check(q, data, full, np.asarray([[1, -1, 2], [0, 3, -1]], np.int32),
               4)


def test_ecoscan_duplicate_probes_and_block_map():
    q, data, lens, _ = _eco_inputs(2, 16, 4, 32, 2, seed=2)
    lens[:] = 32
    _, ids = _eco_check(q, data, lens,
                        np.asarray([[1, 1, 2], [3, 0, 3]], np.int32), 6)
    assert len(set(ids[0])) < 6        # a probed-twice row surfaces twice
    # cluster -> scan-row indirection; -1 masks cluster 2 entirely
    bmap = np.asarray([3, 0, -1, 1, 2], np.int32)
    probes = np.asarray([[0, 2, 4], [2, 1, 3]], np.int32)
    _eco_check(q, data, lens, probes, 5, block_map=bmap)


def test_ecoscan_tie_keeps_flat_order():
    """Identical rows tie exactly: the lower flat candidate index wins."""
    q = np.ones((1, 8), np.float32)
    data = np.zeros((3, 4, 8), np.float32)
    lens = np.full(3, 4, np.int32)
    _, ids = _eco_check(q, data, lens, np.asarray([[2, 0, 1]], np.int32), 5)
    assert ids[0].tolist() == [8, 9, 10, 11, 0]


@pytest.mark.parametrize("n_probe", [1, 3, 8])
def test_route_topk_matches_jax(n_probe):
    r = _rng(3)
    q = r.standard_normal((4, 32)).astype(np.float32)
    cent = r.standard_normal((8, 32)).astype(np.float32)
    cent[5] = cent[2]                  # exact tie: lower centroid id first
    pt = tref.route_topk(_t(q), _t(cent), n_probe)
    pj = j_route_topk(jnp.asarray(q), jnp.asarray(cent), n_probe)
    assert (pt.numpy() == np.asarray(pj)).all()


@pytest.mark.parametrize("N,d,NC", [(100, 16, 5), (513, 64, 33),
                                    (1024, 128, 64)])
def test_kmeans_assign_sweep(N, d, NC):
    r = _rng(4)
    x = r.standard_normal((N, d)).astype(np.float32)
    c = r.standard_normal((NC, d)).astype(np.float32)
    at, dt = ops.kmeans_assign(_t(x), _t(c))
    for aj, dj in (j_kmeans_assign(jnp.asarray(x), jnp.asarray(c)),
                   jref.kmeans_assign(jnp.asarray(x), jnp.asarray(c))):
        assert (at.numpy() == np.asarray(aj)).all()
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj),
                                   rtol=1e-4, atol=1e-4)


def test_kmeans_assign_tie_takes_lower_centroid():
    x = np.zeros((3, 4), np.float32)
    c = np.stack([np.full(4, 2.0), np.ones(4), np.ones(4)]).astype(np.float32)
    a, _ = ops.kmeans_assign(_t(x), _t(c))
    assert a.tolist() == [1, 1, 1]
