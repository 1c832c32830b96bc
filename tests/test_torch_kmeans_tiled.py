"""The tile walk of the port's `kmeans_assign` kernel (`ref.kmeans_assign_
tiled`: norms once, bm-row blocks over bn-wide centroid tiles, a running
(min, lower id) per row) against the JAX package's Pallas kernel
(interpret mode), its jnp oracle and the port's plain version, at the
kernel's tile (`ref.KMEANS_TILE`, which must be the one the CUDA source
is built with) and at a small tile that cuts these small inputs at many
boundaries. Inputs are numpy arrays from a seed, fed to both packages.
The CUDA kernel itself is held to `ref.kmeans_assign` on the card by
chip_smoke.py and tools/kmeans_probe.py.

Tolerance: ids equal; sqdist 1e-4 (f32 sums in another order).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.kmeans_assign import kmeans_assign as j_kmeans_assign
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TILES = [pytest.param(*tref.KMEANS_TILE, id="kernel"),
         pytest.param(16, 32, id="small")]


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_all(x, c, bm, bn):
    """The tiled walk against the Pallas kernel, the jnp oracle and the
    port's plain version; returns its ids."""
    at, dt = tref.kmeans_assign_tiled(_t(x), _t(c), bm, bn)
    ap, dp = tref.kmeans_assign(_t(x), _t(c))
    outs = [(ap.numpy(), dp.numpy())]
    for aj, dj in (j_kmeans_assign(jnp.asarray(x), jnp.asarray(c)),
                   jref.kmeans_assign(jnp.asarray(x), jnp.asarray(c))):
        outs.append((np.asarray(aj), np.asarray(dj)))
    for a, d in outs:
        assert (at.numpy() == a).all()
        np.testing.assert_allclose(dt.numpy(), d, rtol=1e-4, atol=1e-4)
    return at.numpy()


@pytest.mark.parametrize("bm,bn", TILES)
@pytest.mark.parametrize("N,d,NC", [
    (300, 16, 390),      # the PQ width; NC 390: a ragged last tile
    (200, 50, 390),      # d 50: a ragged feature chunk (4-byte copies)
    (129, 128, 256),     # N one past a 128-row block
    (70, 128, 390),      # N short of one 128-row block, ragged tiles
    (65, 50, 1),         # a single centroid
])
def test_tiled_walk_matches_reference(N, d, NC, bm, bn):
    r = np.random.default_rng(N * 1000 + d + NC)
    x = r.standard_normal((N, d)).astype(np.float32)
    c = r.standard_normal((NC, d)).astype(np.float32)
    _check_all(x, c, bm, bn)


@pytest.mark.parametrize("bm,bn", TILES)
@pytest.mark.parametrize("lower", ["first", "last"])
def test_tie_across_tile_boundary_takes_lower_id(bm, bn, lower):
    """Centroid bn (the second tile's first) equals centroid 0 (the first
    tile's first) or centroid bn-1 (its last); rows equal to them must
    take the lower id. Small-integer data makes every d2 exact, so the
    tie is exact in every package."""
    r = np.random.default_rng(bn)
    lo = 0 if lower == "first" else bn - 1
    c = r.integers(-4, 5, (2 * bn + 7, 24)).astype(np.float32)
    c[bn] = c[lo]
    x = r.integers(-4, 5, (bm + 9, 24)).astype(np.float32)
    x[:5] = c[lo]
    ids = _check_all(x, c, bm, bn)
    assert (ids[:5] == lo).all()


def test_model_tile_is_the_kernels():
    src = (Path(ops.__file__).parent / "csrc" / "kmeans_assign.cu").read_text()
    tile = tuple(int(re.search(rf"^constexpr int {name} = (\d+);", src,
                               re.M).group(1)) for name in ("kBM", "kBN"))
    assert tile == tref.KMEANS_TILE


def test_cpu_call_counts_no_launch():
    ops.reset_launch_counts()
    r = np.random.default_rng(3)
    x = _t(r.standard_normal((100, 16)).astype(np.float32))
    c = _t(r.standard_normal((7, 16)).astype(np.float32))
    a, d = ops.kmeans_assign(x, c)
    assert ops.launch_counts()["kmeans_assign"] == 0
    at, dt = tref.kmeans_assign_tiled(x, c, *tref.KMEANS_TILE)
    assert torch.equal(a, at)
    torch.testing.assert_close(d, dt, rtol=1e-4, atol=1e-4)
