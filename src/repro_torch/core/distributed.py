"""EcoVector sharded over a mesh (the port of `repro.core.distributed`):
cluster shards across every rank.

The paper's asymmetry (a tiny routing structure in the fast tier, the
bulk index in the slow tier, only probed clusters touched) spread over
devices:

  * centroids and the query batch: replicated (the small tier),
  * the packed cluster payload [NC, CAP, d]: split on NC across every
    mesh axis (each rank holds NC / ndev clusters, rank-major),
  * each rank routes on the centroids and scans only its *resident*
    probes with the `ecoscan` kernel (`kernels.ops.ecoscan`; the other
    probes are passed as -1, which the kernel skips): no cluster moves,
  * each rank's top k are all-gathered (k * ndev candidates, a few KB)
    and merged: the only collective of the search.

`reference_retrieval` is the single-host numpy oracle.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.dist import collectives as C
from repro_torch.dist.sharding import (NamedSharding, local_index,
                                       mesh_size, placements_for)
from repro_torch.kernels import ops, ref


def _flat_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _local(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a [NC, ...] input: a DTensor's own part, or the
    rank-major slice of a whole tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.to_local()
    idx, n = local_index(mesh, _flat_axes(mesh))
    rows = t.shape[0] // n
    return t[idx * rows:(idx + 1) * rows]


def _whole(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_sharded_retrieval(mesh, *, k: int = 10, n_probe: int = 8):
    """Returns retrieve(q, centroids, data, lens, slot_ids) -> (dists,
    ids), the same on every rank.

    q: [B, d] f32; centroids: [NC, d] f32; data: [NC, CAP, d] f32; lens:
    [NC] i32; slot_ids: [NC, CAP] i32 global ids. data, lens and
    slot_ids are DTensors placed by `retrieval_shardings` or whole
    tensors (each rank then keeps its rows); the device count must
    divide NC. Routing is `ref.route_topk` (nearest first, lower id on
    ties); each rank's candidates are ecoscan's order (distance, then
    probe position and slot), the merge keeps the k smallest of the
    rank-major concatenation, lower index first on ties, as
    `lax.top_k`. Past the valid candidates: (inf, -1).
    """
    axes = _flat_axes(mesh)
    ndev = mesh_size(mesh)

    def retrieve(q, centroids, data, lens, slot_ids):
        q, cent = _whole(q), _whole(centroids)
        data_l, lens_l, sid_l = (_local(t, mesh) for t in
                                 (data, lens, slot_ids))
        nc_loc, cap, _ = data_l.shape
        if nc_loc * ndev != cent.shape[0]:
            raise ValueError(f"{cent.shape[0]} clusters over {ndev} ranks")
        didx, _ = local_index(mesh, axes)
        lo = didx * nc_loc
        probes = ref.route_topk(q, cent, n_probe)              # [B, P]
        local_p = probes - lo
        resident = (local_p >= 0) & (local_p < nc_loc)
        local_p = torch.where(resident, local_p, torch.full_like(local_p, -1))
        dists, slots = ops.ecoscan(q, data_l, lens_l, local_p, k)
        ok = slots >= 0
        gid = torch.where(ok, sid_l.reshape(-1)[slots.clamp(min=0).long()],
                          torch.full_like(slots, -1))
        dists = torch.where(ok, dists, torch.full_like(dists, float("inf")))
        all_d = C.all_gather(dists, mesh, axes, 1)             # [B, k*ndev]
        all_i = C.all_gather(gid, mesh, axes, 1)
        fd, order = torch.sort(all_d, dim=1, stable=True)
        return fd[:, :k], torch.gather(all_i, 1, order[:, :k])

    return retrieve


def retrieval_input_structs(*, B: int, NC: int, CAP: int, d: int):
    """(shape, dtype) of each input of `make_sharded_retrieval`'s
    retrieve: q, centroids, data, lens, slot_ids."""
    f32, i32 = torch.float32, torch.int32
    return (((B, d), f32), ((NC, d), f32), ((NC, CAP, d), f32),
            ((NC,), i32), ((NC, CAP), i32))


def retrieval_shardings(mesh):
    """The placements (`dist.sharding.NamedSharding`) of retrieve's
    inputs on `mesh`: q and centroids replicated; data, lens and
    slot_ids split on NC over every mesh axis (rank-major)."""
    axes = _flat_axes(mesh)
    split = (axes if len(axes) > 1 else axes[0],)

    def named(spec):
        return NamedSharding(mesh, spec, placements_for(mesh, spec))
    return (named(()), named(()), named(split), named(split), named(split))


def reference_retrieval(q, centroids, data, lens, slot_ids, *, k, n_probe):
    """Single-host oracle for the sharded step (numpy)."""
    q = np.asarray(q)
    d2 = (np.sum(q ** 2, 1)[:, None] - 2 * q @ np.asarray(centroids).T
          + np.sum(np.asarray(centroids) ** 2, 1)[None, :])
    probes = np.argsort(d2, 1)[:, :n_probe]
    B = q.shape[0]
    data = np.asarray(data)
    lens = np.asarray(lens)
    slot_ids = np.asarray(slot_ids)
    out_d = np.zeros((B, k), np.float32)
    out_i = np.zeros((B, k), np.int64)
    for b in range(B):
        ds, ids = [], []
        for c in probes[b]:
            m = lens[c]
            diff = data[c, :m] - q[b]
            ds.append(np.einsum("nd,nd->n", diff, diff))
            ids.append(slot_ids[c, :m])
        ds = np.concatenate(ds)
        ids = np.concatenate(ids)
        o = np.argsort(ds)[:k]
        out_d[b] = ds[o]
        out_i[b] = ids[o]
    return out_d, out_i
