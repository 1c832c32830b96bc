"""The tile walk of the port's `ecoscan` kernel (`ref.ecoscan_tiled`: each
probed list cut into tiles, a sorted top min(k, tile) a tile, then the
chunked merge of each query's lists) against the JAX package's Pallas
kernel (interpret mode), its jnp oracle and the port's plain version, at
the kernel's tile and merge chunk (`ref.ECOSCAN_TILE`, `ref.ECOSCAN_
CHUNK`, which must be the ones the CUDA source is built with) and at a
small tile and chunk that cut these small inputs at many boundaries; and
the port's `scr_select` against the JAX kernel where the CUDA kernel
splits a pair's windows across warps. Inputs are numpy arrays from a
seed, fed to both packages. The CUDA kernels themselves are held to
their plain versions on the card by chip_smoke.py and
tools/retrieval_probe.py.

Tolerance: ids equal; distances and scores 2e-5 (f32 sums in another
order).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ecoscan import ecoscan as j_ecoscan
from repro.kernels.scr_select import scr_select as j_scr_select
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

WALKS = [pytest.param(tref.ECOSCAN_TILE, tref.ECOSCAN_CHUNK, id="kernel"),
         pytest.param(4, 8, id="small")]
CSRC = Path(ops.__file__).parent / "csrc"


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_all(q, data, lens, probes, k, tile, chunk, block_map=None):
    """The tiled walk against the Pallas kernel, the jnp oracle and the
    port's plain version; returns its (dists, ids)."""
    bm_t = None if block_map is None else _t(block_map)
    dt, it = tref.ecoscan_tiled(_t(q), _t(data), _t(lens), _t(probes), k,
                                block_map=bm_t, tile=tile, chunk=chunk)
    outs = [tuple(x.numpy() for x in tref.ecoscan(
        _t(q), _t(data), _t(lens), _t(probes), k, block_map=bm_t))]
    args = (jnp.asarray(q), jnp.asarray(data), jnp.asarray(lens),
            jnp.asarray(probes))
    bm_j = None if block_map is None else jnp.asarray(block_map)
    for dj, ij in (j_ecoscan(*args, k=k, block_map=bm_j),
                   jref.ecoscan(*args, k, block_map=bm_j)):
        outs.append((np.asarray(dj), np.asarray(ij)))
    for d_, i_ in outs:
        assert (it.numpy() == i_).all()
        np.testing.assert_allclose(dt.numpy(), d_, rtol=2e-5, atol=2e-5)
    return dt.numpy(), it.numpy()


@pytest.mark.parametrize("tile,chunk", WALKS)
@pytest.mark.parametrize("B,d,NC,CAP,P,k", [
    (2, 32, 8, 64, 2, 5),       # CAP a whole number of tiles
    (3, 16, 6, 70, 3, 10),      # a ragged last tile
    (1, 24, 5, 33, 5, 3),       # one row past a 32-row tile
    (4, 8, 12, 9, 4, 7),        # lists shorter than a tile
])
def test_tiled_walk_matches_reference(B, d, NC, CAP, P, k, tile, chunk):
    r = np.random.default_rng(B * 1000 + CAP + k)
    q = r.standard_normal((B, d)).astype(np.float32)
    data = r.standard_normal((NC, CAP, d)).astype(np.float32)
    lens = r.integers(0, CAP + 1, NC).astype(np.int32)
    probes = np.stack([r.permutation(NC)[:P] for _ in range(B)]).astype(
        np.int32)
    _check_all(q, data, lens, probes, k, tile, chunk)


@pytest.mark.parametrize("tile,chunk", WALKS)
@pytest.mark.parametrize("at", ["tile", "probe"])
def test_exact_ties_across_boundaries_keep_flat_order(tile, chunk, at):
    """Rows equal to q's nearest row sit on both sides of a tile boundary
    (rows tile-1 and tile of one list) or in two probed lists; small
    integers make every distance exact in every package, so the tie is
    exact and must go to the lower flat index p*CAP + j."""
    r = np.random.default_rng(tile)
    CAP, d = 2 * tile + 3, 12
    data = r.integers(-3, 4, (4, CAP, d)).astype(np.float32)
    q = r.integers(-3, 4, (1, d)).astype(np.float32)
    lens = np.full(4, CAP, np.int32)
    if at == "tile":
        data[2, tile - 1] = data[2, tile] = data[2, 2 * tile] = q[0]
        want = [2 * CAP + tile - 1, 2 * CAP + tile, 2 * CAP + 2 * tile]
    else:
        data[1, tile + 1] = data[3, 0] = data[3, tile] = q[0]
        # probe order 3 then 1: flat order puts list 3's rows first
        want = [3 * CAP, 3 * CAP + tile, 1 * CAP + tile + 1]
    probes = np.asarray([[3, 2, 1] if at == "probe" else [0, 2, 1]],
                        np.int32)
    dist, ids = _check_all(q, data, lens, probes, 3, tile, chunk)
    assert ids[0].tolist() == want and (dist[0] == 0).all()


@pytest.mark.parametrize("tile,chunk", WALKS)
def test_duplicate_padded_and_masked_probes(tile, chunk):
    """A probe repeated (its rows surface twice, the first copy first), a
    padded probe (-1), clusters masked by block_map (-1) and mapped to
    another row, and a list with lens 0."""
    r = np.random.default_rng(7)
    q = r.standard_normal((2, 16)).astype(np.float32)
    data = r.standard_normal((6, 20, 16)).astype(np.float32)
    lens = np.asarray([20, 0, 3, 20, 5, 9], np.int32)
    probes = np.asarray([[1, 1, -1, 2], [5, 3, 4, 0]], np.int32)
    bm = np.asarray([0, 2, 5, -1, 4, 1], np.int32)
    for k in (3, 20):
        _, ids = _check_all(q, data, lens, probes, k, tile, chunk,
                            block_map=bm)
    # query 0: cluster 1 (row 2, 3 rows) twice and cluster 2 (row 5, 9
    # rows): 15 candidates; query 1: row 1 empty, cluster 3 masked
    got = ids[0][ids[0] >= 0].tolist()
    assert sorted(got) == sorted([40, 41, 42] * 2 + list(range(100, 109)))
    assert (ids[0, 15:] == -1).all() and (ids[1] // 20 != 1).all()
    _, ids = _check_all(q, data, lens, -np.ones((2, 4), np.int32), 5, tile,
                        chunk)
    assert (ids == -1).all()


@pytest.mark.parametrize("tile,chunk", WALKS)
@pytest.mark.parametrize("k", [40, 90])
def test_k_past_a_tile_and_past_all_candidates(tile, chunk, k):
    """k above the tile (a tile keeps all its rows) and, at 90, above the
    query's 57 candidates: the tail pads with (NEG, -1)."""
    r = np.random.default_rng(k)
    q = r.standard_normal((2, 8)).astype(np.float32)
    data = r.standard_normal((5, 40, 8)).astype(np.float32)
    lens = np.asarray([40, 0, 17, 40, 33], np.int32)
    probes = np.asarray([[0, 2, 1], [4, 3, 1]], np.int32)
    dist, ids = _check_all(q, data, lens, probes, k, tile, chunk)
    if k == 90:
        assert (ids[0, 57:] == -1).all() and (ids[0, :57] >= 0).all()
        assert (dist[0, 57:] == np.float32(tref.NEG)).all()


def test_model_tile_and_chunk_are_the_kernels():
    src = (CSRC / "ecoscan.cu").read_text()
    const = {name: int(re.search(rf"^constexpr int {name} = (\d+);", src,
                                 re.M).group(1))
             for name in ("kTile", "kWarps")}
    assert const["kTile"] == tref.ECOSCAN_TILE
    assert const["kWarps"] * 32 == tref.ECOSCAN_CHUNK


def test_cpu_call_counts_no_launch_and_takes_no_map():
    ops.reset_launch_counts()
    r = np.random.default_rng(3)
    q = _t(r.standard_normal((3, 16)).astype(np.float32))
    data = _t(r.standard_normal((5, 40, 16)).astype(np.float32))
    lens = _t(np.asarray([40, 3, 0, 21, 40], np.int32))
    probes = _t(np.asarray([[0, 1], [2, 3], [4, 0]], np.int32))
    d, i = ops.ecoscan(q, data, lens, probes, 6)
    assert ops.launch_counts()["ecoscan"] == 0
    dt, it = tref.ecoscan_tiled(q, data, lens, probes, 6)
    assert torch.equal(i, it)
    torch.testing.assert_close(d, dt, rtol=2e-5, atol=2e-5)


def _scr_check(q, data, lens, ids):
    st, wt = ops.scr_select(_t(q), _t(data), _t(lens), _t(ids))
    args = (jnp.asarray(q), jnp.asarray(data), jnp.asarray(lens),
            jnp.asarray(ids))
    for sj, wj in (j_scr_select(*args, interpret=True),
                   jref.scr_select(*args)):
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2e-5,
                                   atol=2e-5)
        assert (wt.numpy() == np.asarray(wj)).all()
    return st.numpy(), wt.numpy()


@pytest.mark.parametrize("CAPW,first,second", [
    (10, 2, 7),      # one warp a window: two warps
    (40, 3, 20),     # 16 warps a pair: warps 3 and 4
    (40, 5, 21),     # the same warp, its first and second window
    (40, 1, 39),     # warps 1 and 7, the last window
])
def test_scr_select_first_max_across_warps(CAPW, first, second):
    """Two equal windows hold the maximum score; the CUDA kernel puts
    window w on warp w % min(CAPW, 16), so these ties are decided across
    warps or across a warp's windows. The first maximum must win."""
    r = np.random.default_rng(CAPW + first)
    d = 32
    data = r.standard_normal((3, CAPW, d)).astype(np.float32)
    data[1, first] = data[1, second] = 4.0 * r.standard_normal(d)
    q = data[1, first][None] / np.linalg.norm(data[1, first])
    lens = np.asarray([CAPW, CAPW, 5], np.int32)
    _, w = _scr_check(q.astype(np.float32), data, lens,
                      np.asarray([[1, 0, 2]], np.int32))
    assert w[0, 0] == first


@pytest.mark.parametrize("B,d,ND,CAPW,K", [
    (2, 48, 9, 40, 4),          # CAPW above 32: several windows a warp
    (3, 20, 7, 33, 10),         # d % 4 != 0, top_k 10
])
def test_scr_select_wide_blocks(B, d, ND, CAPW, K):
    r = np.random.default_rng(CAPW * d)
    q = r.standard_normal((B, d)).astype(np.float32)
    data = r.standard_normal((ND, CAPW, d)).astype(np.float32)
    lens = r.integers(0, CAPW + 1, ND).astype(np.int32)
    lens[0] = CAPW
    ids = r.integers(-1, ND, (B, K)).astype(np.int32)
    ids[0, 0] = 0
    _scr_check(q, data, lens, ids)
