"""The port's Lloyd update (`core.kmeans.cluster_sums`, `lloyd`) on the
CPU. Each cluster's rows are added in row order, so the sums equal a
row-by-row accumulation bit for bit (as `index_add_` adds on the CPU)
and do not depend on the device; `lloyd` one step at a time walks the
same centroids as `lloyd` over all steps (chip_smoke's F8 phase steps
the card build so, against the CPU); and an empty cluster is re-seeded
at the row farthest from the updated centroids, as in the reference.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.kmeans import (cluster_sums, kmeans, kmeans_pp_init,
                                     lloyd)
from repro_torch.kernels import ref as tref


@pytest.mark.parametrize("n,d,k", [(500, 16, 7), (64, 384, 100), (1, 3, 4)])
def test_cluster_sums_add_rows_in_order(n, d, k):
    r = np.random.default_rng(n)
    x = torch.from_numpy(r.standard_normal((n, d)).astype(np.float32))
    assign = torch.from_numpy(r.integers(0, max(1, k // 2), n)
                              .astype(np.int32))
    sums, cnt = cluster_sums(x, assign, k)
    want = torch.zeros(k, d)
    for i in range(n):
        want[assign[i]] += x[i]
    assert torch.equal(sums, want)
    assert torch.equal(sums, torch.zeros(k, d).index_add_(0, assign.long(),
                                                          x))
    assert cnt.tolist() == np.bincount(assign.numpy(), minlength=k).tolist()
    assert (sums[k // 2 + 1:] == 0).all()         # empty clusters sum to 0


def test_lloyd_steps_walk_the_build():
    r = np.random.default_rng(4)
    x = r.standard_normal((400, 8)).astype(np.float32)
    xt = torch.from_numpy(x)
    init = torch.from_numpy(kmeans_pp_init(x, 12, 1))
    cent, assign = lloyd(xt, init, 6)
    step = init
    for _ in range(6):
        step, _ = lloyd(xt, step, 1)
    assert torch.equal(step, cent)
    c_np, a_np = kmeans(x, 12, 6, seed=1, device="cpu")
    np.testing.assert_array_equal(c_np, cent.numpy())
    np.testing.assert_array_equal(a_np, assign.numpy())


def test_lloyd_reseeds_an_empty_cluster_at_the_farthest_point():
    r = np.random.default_rng(5)
    xt = torch.from_numpy(r.standard_normal((200, 6)).astype(np.float32))
    init = torch.cat([xt[:5], torch.full((1, 6), 1e3)])    # 5 gets no row
    cent, _ = lloyd(xt, init, 1)
    a0, _ = tref.kmeans_assign(xt, init)
    sums, cnt = cluster_sums(xt, a0, 6)
    assert cnt[5] == 0
    new = sums[:5] / cnt[:5, None].float()
    _, dist = tref.kmeans_assign(xt, torch.cat([new, torch.zeros(1, 6)]))
    assert torch.equal(cent[:5], new)
    assert torch.equal(cent[5], xt[int(torch.argmax(dist))])
