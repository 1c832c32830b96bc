"""The dry run of the paper's technique at fleet scale: the sharded
EcoVector retrieval step (`core.distributed.make_sharded_retrieval`,
whose local scan is the `ecoscan` kernel) traced on fake tensors on the
production meshes and priced at one H100's peaks (`roofline.hardware`).
The port of `repro.launch.retrieval_dryrun`.

  PYTHONPATH=src python -m repro_torch.launch.retrieval_dryrun [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.retrieval_dryrun --both

The index is sized as the reference sizes it, to `hbm_frac` (0.6) of a
device's HBM, now 80e9 bytes: a cluster of CAP 1,024 vectors of d 128 in
f32 with its slot ids and length is 528,388 bytes, so a device holds
90,842 clusters (47.6 GB of lists) and the 16 x 16 mesh 23,255,552
clusters, 23.8 billion vectors; two pods twice that. Each rank holds its
clusters' lists, the centroids whole and the query batch; it routes on
every centroid (`ref.route_topk`, a [B, NC] f32 product and a sort),
scans its resident probes with `ecoscan` (counted from shapes: every
probe distinct, every list full) and all-gathers its top k. The count
says what that costs and what does not fit: the replicated centroids and
the route's [B, NC] distances, and global slot ids past int32.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import torch

from repro_torch.core.distributed import (make_sharded_retrieval,
                                          retrieval_input_structs,
                                          retrieval_shardings)
from repro_torch.launch.dryrun import fake_world, placed, production_mesh
from repro_torch.roofline import graph
from repro_torch.roofline import hardware as hw


def cluster_bytes(cap: int, d: int) -> int:
    """A cluster's lists (f32), slot ids (i32) and length (i32)."""
    return cap * d * 4 + cap * 4 + 4


def clusters_per_device(cap: int = 1024, d: int = 128,
                        hbm_frac: float = 0.6) -> int:
    return int(hw.HBM_BYTES * hbm_frac / cluster_bytes(cap, d))


def trace(mesh, *, B: int, NC: int, cap: int, d: int, n_probe: int, k: int):
    """The cost dict (`graph.trace_cost`) of one retrieve call of B
    queries over NC clusters on `mesh`, as rank 0 (inputs placed by
    `retrieval_shardings`, each rank's part alone)."""
    mode = graph.fake_mode()
    structs = retrieval_input_structs(B=B, NC=NC, CAP=cap, d=d)
    with mode:
        args = [placed(torch.empty(shape, dtype=dt, device="meta"), s)
                for (shape, dt), s in zip(structs, retrieval_shardings(mesh))]
    fn = make_sharded_retrieval(mesh, k=k, n_probe=n_probe)
    return graph.trace_cost(fn, *args, mode=mode)


def card_mesh():
    """A (1, 1) mesh on a fake one-rank group: one card's share."""
    from repro_torch.launch.mesh import make_test_mesh
    fake_world(1)
    return make_test_mesh(1, 1, device_type="cpu")


def run(multi_pod: bool, B: int = 1024, d: int = 128, cap: int = 1024,
        n_probe: int = 16, k: int = 10, hbm_frac: float = 0.6,
        out: str = "results/dryrun", mesh=None, tag_mesh=None):
    """Trace and price one cell; write its JSON to `out` (when given) and
    print the terms and the QPS bound. `mesh`: another mesh than the
    production one (chip_smoke's one card), named `tag_mesh`."""
    if mesh is None:
        mesh = production_mesh(multi_pod)
        tag_mesh = "pod2" if multi_pod else "pod1"
    ndev = math.prod(mesh.shape)
    nc_dev = clusters_per_device(cap, d, hbm_frac)
    NC = nc_dev * ndev
    t0 = time.time()
    c = trace(mesh, B=B, NC=NC, cap=cap, d=d, n_probe=n_probe, k=k)
    res = {
        "cell": "ecovector_retrieval", "mesh": tag_mesh, "chips": ndev,
        "n_vectors": NC * cap, "n_clusters": NC,
        "clusters_per_device": nc_dev, "batch_queries": B,
        "n_probe": n_probe, "k": k,
        "flops_per_device": c["flops"],
        "flops_f32_per_device": c["flops_f32"],
        "hbm_bytes_per_device": c["bytes"],
        "collective_bytes_per_device": c["collective_total"],
        "t_compute_s": c["t_compute_s"], "t_memory_s": c["t_memory_s"],
        "t_collective_s": c["t_collective_s"],
        "peak_bytes_per_device": c["peak_bytes"],
        "fits_hbm_80g": bool(c["peak_bytes"] <= hw.HBM_BYTES),
        "lists_bytes_per_device": nc_dev * cap * d * 4,
        "centroid_bytes_per_device": NC * d * 4,
        "route_bytes_per_device": B * NC * 4,
        "global_ids_past_int32": NC * cap >= 2 ** 31,
        "ecoscan": c["kernels"].get("ecoscan"),
        "card": f"{hw.NAME}, {hw.POWER_W} W (datasheet peaks, modelled)",
        "wall_s": time.time() - t0, "status": "ok",
    }
    res["dominant"] = graph.dominant(res["t_compute_s"], res["t_memory_s"],
                                     res["t_collective_s"])
    res["qps_bound"] = B / max(res["t_compute_s"], res["t_memory_s"],
                               res["t_collective_s"])
    tag = f"ecovector_retrieval.{tag_mesh}"
    if out:
        Path(out).mkdir(parents=True, exist_ok=True)
        (Path(out) / f"{tag}.json").write_text(json.dumps(res, indent=2))
    print(f"[{tag}] {res['n_vectors'] / 1e9:.2f}B vectors in "
          f"{NC / 1e6:.2f}M clusters across {ndev} devices, {nc_dev:,} "
          f"clusters a device ({res['lists_bytes_per_device'] / 1e9:.1f} GB "
          f"of lists); centroids {res['centroid_bytes_per_device'] / 1e9:.2f}"
          f" GB and the route's [B, NC] distances "
          f"{res['route_bytes_per_device'] / 1e9:.2f} GB a device; peak "
          f"{res['peak_bytes_per_device'] / 1e9:.1f} GB (fits 80 GB: "
          f"{res['fits_hbm_80g']}); global ids past int32: "
          f"{res['global_ids_past_int32']}")
    print(f"[{tag}] terms on {hw.NAME} peaks: compute="
          f"{res['t_compute_s'] * 1e3:.3f}ms memory="
          f"{res['t_memory_s'] * 1e3:.3f}ms collective="
          f"{res['t_collective_s'] * 1e3:.3f}ms dominant={res['dominant']} "
          f"-> bound ~{res['qps_bound']:,.0f} qps at batch {B}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--n-probe", type=int, default=16)
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    from repro_torch.launch.dryrun import release
    for mp in ((False, True) if args.both else (args.multi_pod,)):
        run(mp, B=args.batch, n_probe=args.n_probe, out=args.out)
    release()


if __name__ == "__main__":
    main()
