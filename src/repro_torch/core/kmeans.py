"""Batched k-means for cluster partitioning (EcoVector §3.1.1).

Same k-means++ seeding (numpy, same seed -> same centroids) and the same
Lloyd iterations as `repro.core.kmeans`; the assignment step runs through
the `kmeans_assign` kernel and the update step sums each cluster's rows
in a fixed order (`cluster_sums`), so a build is the same on every run.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops


def kmeans_pp_init(x: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    centroids = [x[rng.integers(n)]]
    d2 = None
    for _ in range(1, k):
        c = np.asarray(centroids[-1])
        nd = np.sum((x - c) ** 2, axis=1)
        d2 = nd if d2 is None else np.minimum(d2, nd)
        p = d2 / max(d2.sum(), 1e-12)
        centroids.append(x[rng.choice(n, p=p)])
    return np.stack(centroids).astype(np.float32)


def cluster_sums(x: torch.Tensor, assign: torch.Tensor, k: int):
    """x [N, d], assign [N] ids < k -> (sums [k, d], counts [k] int64).
    Each cluster's rows are added in row order on every device: a stable
    sort by cluster, then a segment sum (`index_add_` adds with atomics
    in no fixed order on CUDA, so two builds could differ)."""
    idx = assign.long()
    order = torch.argsort(idx, stable=True)
    cnt = torch.bincount(idx, minlength=k)
    return torch.segment_reduce(x[order], "sum", lengths=cnt, axis=0), cnt


def lloyd(xt: torch.Tensor, cent: torch.Tensor, iters: int):
    """`iters` Lloyd iterations over xt [N, d] from cent [k, d] (f32, one
    device) -> (centroids [k, d], assign [N] i32) tensors."""
    k = cent.shape[0]
    for _ in range(iters):
        assign, _ = ops.kmeans_assign(xt, cent)
        sums, cnt = cluster_sums(xt, assign, k)
        new = sums / torch.clamp(cnt[:, None], min=1).float()
        # re-seed empty clusters at the farthest points
        empty = cnt == 0
        if bool(empty.any()):
            _, dist = ops.kmeans_assign(xt, new)
            far = np.argsort(-dist.cpu().numpy())
            eidx = torch.nonzero(empty)[:, 0]
            new[eidx] = xt[torch.as_tensor(far[: len(eidx)],
                                           device=xt.device)]
        cent = new
    assign, _ = ops.kmeans_assign(xt, cent)
    return cent, assign


def kmeans(x, k: int, iters: int = 10, seed: int = 0, device="cuda"):
    """x: [N, d] -> (centroids [k, d] f32, assign [N] i32) after `iters`
    Lloyd iterations, as numpy."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    k = min(k, x.shape[0])
    cent, assign = lloyd(torch.tensor(x, device=dev),
                         torch.tensor(kmeans_pp_init(x, k, seed), device=dev),
                         iters)
    return cent.cpu().numpy(), assign.cpu().numpy()
