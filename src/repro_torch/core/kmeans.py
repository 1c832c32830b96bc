"""Batched k-means for cluster partitioning (EcoVector §3.1.1).

Same k-means++ seeding (numpy, same seed -> same centroids) and the same
Lloyd iterations as `repro.core.kmeans`; the assignment step runs through
the `kmeans_assign` kernel and the update step is an `index_add_`.
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


def kmeans(x, k: int, iters: int = 10, seed: int = 0, device="cuda"):
    """x: [N, d] -> (centroids [k, d] f32, assign [N] i32) after `iters`
    Lloyd iterations, as numpy."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float32)
    n, d = x.shape
    k = min(k, n)
    xt = torch.tensor(x, device=dev)
    cent = torch.tensor(kmeans_pp_init(x, k, seed), device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    for _ in range(iters):
        assign, _ = ops.kmeans_assign(xt, cent)
        idx = assign.long()
        sums = torch.zeros(k, d, device=dev).index_add_(0, idx, xt)
        cnt = torch.zeros(k, device=dev).index_add_(0, idx, ones)
        new = sums / torch.clamp(cnt[:, None], min=1.0)
        # re-seed empty clusters at the farthest points
        empty = cnt == 0
        if bool(empty.any()):
            _, dist = ops.kmeans_assign(xt, new)
            far = np.argsort(-dist.cpu().numpy())
            eidx = torch.nonzero(empty)[:, 0]
            new[eidx] = xt[torch.as_tensor(far[: len(eidx)], device=dev)]
        cent = new
    assign, _ = ops.kmeans_assign(xt, cent)
    return cent.cpu().numpy(), assign.cpu().numpy()
