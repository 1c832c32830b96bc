"""The dry run on an H100 cost model: every (architecture x input shape)
cell of the port traced on fake tensors on the production meshes
(`roofline.graph.trace_cost`), its FLOPs, HBM bytes, collective bytes
and peak bytes a device priced at one H100's peaks
(`roofline.hardware`), written as JSON. The port of
`repro.launch.dryrun`, which lowers and compiles each cell with XLA for
a TPU v5e; here nothing is compiled and nothing runs on a card.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
      h2o_danube_1_8b --shape train_4k [--multi-pod] [--out results/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_72b \
      --shape decode_32k --one-device     # the whole cell on one device

What a cell traces, as rank 0 of a fake process group (backend "fake")
of the mesh's world size:

- train cells: the port's mesh step (`trainer.make_train_step` under
  `use_mesh`), its masters and AdamW state DTensors placed by
  `trainer.state_shardings` (FSDP on "data", and on "pod" too for a
  config past 300 B parameters on two pods), MoE configs past 60 B
  parameters with int8 weight gathers. The model's own weights are not
  counted: the step reads only the masters.
- serving cells (prefill, decode): a rank runs its rows of "batch"
  (over ("pod", "data")), in bf16. A dense config is built under the
  mesh, so the rank holds its tensor-parallel part (`models.model.
  tp_layout` on "model": its query heads and their kv heads, its FFN
  columns and rows, its vocabulary range) and its cache holds its kv
  heads; the all-reduces after the attention, the FFN and the embedding
  and the logits' all-gather over "model" are counted at the group's
  link rate. The other families serve whole: their "model" ranks repeat
  the work, which `useful_flops_ratio` shows. Dense configs past 10 B
  parameters decode from an int8 KV cache. The decode is the contiguous
  `decode_step` over a cache of the cell's length (the paged step's
  `torch.nonzero` cannot be traced), as the reference's is.
  `--one-device` traces a cell whole on a (1, 1) mesh of a one-rank
  group (mesh tag "dev1"): the work the production meshes split.

A cell that fails is recorded with status "error" and its traceback.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.config import SHAPES, MeshConfig, RunConfig
from repro_torch.configs import ARCH_IDS, cells, get_config
from repro_torch.convert import tree_map
from repro_torch.dist import sharding as sh
from repro_torch.models import dense
from repro_torch.models import model as model_mod
from repro_torch.models.encdec import DEC_RATIO
from repro_torch.models.mamba2 import dims as mamba_dims
from repro_torch.roofline import graph
from repro_torch.roofline import hardware as hw
from repro_torch.train import trainer

# the size past which a MoE config gathers its experts in int8 (train) and
# a dense config decodes from an int8 cache (serving)
INT8_GATHER_PARAMS = 60e9
INT8_KV_PARAMS = 10e9
FSDP_PODS_PARAMS = 3e11


def fake_world(world: int):
    """The default process group as a fake one of `world` ranks, this
    process rank 0 (a group of another size or backend is replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized() and (dist.get_world_size() != world
                                  or dist.get_backend() != "fake"):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


def release() -> None:
    """Destroy the fake process group, if one is up."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def production_mesh(multi_pod: bool):
    """The production mesh (`launch.mesh.make_production_mesh`) on a fake
    process group of its 256 or 512 ranks."""
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(MeshConfig(multi_pod).num_devices)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def one_device_mesh():
    """A (1, 1) mesh of a one-rank fake group: a cell traced whole."""
    from repro_torch.launch.mesh import make_test_mesh
    fake_world(1)
    return make_test_mesh(1, 1, device_type="cpu")


def input_specs(arch: str, shape_name: str):
    """Meta tensors of every model input of a cell (global shapes)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return model_mod.batch_struct(cfg, shape)
    if shape.kind == "prefill":
        b = model_mod.batch_struct(cfg, shape)
        b.pop("labels", None)
        return b
    return {"token": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                 device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def fake_model(cfg):
    """The config's model on fake weights (its dtype; F32_KEEP in f32):
    under a mesh with a "model" axis a dense config's tensor-parallel
    part of this rank. Call under a fake mode."""
    mesh, layout = sh.get_mesh(), None
    if model_mod.FAMILIES[cfg.family].TENSOR_PARALLEL and \
            "model" in sh.mesh_shape(mesh):
        layout = model_mod.tp_layout(cfg, sh.mesh_shape(mesh)["model"],
                                     sh.local_index(mesh, ("model",))[0])
    params = {n: torch.empty(s, dtype=torch.float32 if dense.keeps_f32(n)
                             else cfg.torch_dtype)
              for n, s in model_mod.param_shapes(cfg, layout).items()}
    return model_mod.build_model(cfg, device="cpu", params=params)


def decode_cache(cfg, b: int, seq_len: int, kv_heads=None):
    """A decode cache of `cfg`'s family for b rows of seq_len positions,
    as each family's prefill lays it out (zeros; the reference's
    `init_cache`; a dense or MoE cache of `kv_heads`, a tensor-parallel
    rank's, when given). Call under a fake mode."""
    dt, G, hd = cfg.torch_dtype, max(cfg.num_kv_heads, 1), \
        cfg.resolved_head_dim

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype)
    if cfg.family in ("dense", "moe"):
        return dense.init_cache(cfg, b, seq_len, device="cpu",
                                kv_heads=kv_heads)
    if cfg.family == "encdec":
        Ld, F_ = cfg.encdec.decoder_layers, cfg.encdec.cross_kv_len
        return {"k": z(Ld, b, seq_len, G, hd), "v": z(Ld, b, seq_len, G, hd),
                "cross_k": z(Ld, b, F_, G, hd), "cross_v": z(Ld, b, F_, G, hd)}
    if cfg.family == "mamba2":
        d_in, H, P, N = mamba_dims(cfg)
        L_, K = cfg.num_layers, cfg.mamba.conv_width
        return {"h": z(L_, b, H, N, P, dtype=torch.float32),
                "conv": z(L_, b, K - 1, d_in + 2 * N)}
    pat = cfg.rglru.pattern
    NB, rem = divmod(cfg.num_layers, len(pat))
    w, K = cfg.rglru.lru_width or cfg.d_model, cfg.rglru.conv_width
    win = min(cfg.rglru.local_window, seq_len)
    cache = {}
    for prefix, c, lead in ([(f"s{i}_", c, (NB,)) for i, c in enumerate(pat)]
                            + [(f"tail{j}_", pat[j], ()) for j in
                               range(rem)]):
        if c == "r":
            cache[prefix + "h"] = z(*lead, b, w, dtype=torch.float32)
            cache[prefix + "conv"] = z(*lead, b, K - 1, w)
        else:
            cache[prefix + "k"] = z(*lead, b, win, G, hd)
            cache[prefix + "v"] = z(*lead, b, win, G, hd)
    return cache


def placed(meta: torch.Tensor, sharding) -> torch.Tensor:
    """A DTensor of `meta`'s global shape placed by `sharding`, built from
    this rank's part alone (a fake tensor of the local shape)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = sharding.mesh
    local = list(meta.shape)
    for md, p in enumerate(sharding.placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(md)
    t = torch.empty(local, dtype=meta.dtype)
    return DTensor.from_local(t, mesh, sharding.placements, run_check=False,
                              shape=meta.shape,
                              stride=torch.empty(meta.shape,
                                                 device="meta").stride())


def batch_rows(mesh, global_batch: int) -> int:
    """A serving rank's rows: the global batch split on "batch" as far as
    it divides (`sharding.batch_part`)."""
    lo, hi, _ = sh.batch_part(mesh, global_batch)
    return hi - lo


def serving_cfg(cfg, kind: str):
    """A serving cell's config: int8 KV for a dense decode past 10 B."""
    if kind == "decode" and cfg.family == "dense" and \
            cfg.param_count() > INT8_KV_PARAMS:
        return dataclasses.replace(cfg, kv_quant=True)
    return cfg


def trace_cell(arch: str, shape_name: str, mesh):
    """Trace one cell's step on `mesh` (train) or on one rank's rows and
    tensor-parallel part (serving). Returns (cost dict of `trace_cost`,
    extra fields)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mode = graph.fake_mode()
    if shape.kind == "train":
        if cfg.family == "moe" and cfg.param_count() > INT8_GATHER_PARAMS:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, int8_gather=True))
        run = RunConfig(model=cfg, shape=shape)
        with mode:
            lm = fake_model(cfg)
        with sh.use_mesh(mesh):
            step, nmb, mdtype = trainer.make_train_step(run, lm)
            psh, osh, _ = trainer.state_shardings(run, mesh)
            masters_s, opt_s = trainer.state_structs(run)
            with mode:
                masters = tree_map(placed, masters_s, psh)
                opt_state = tree_map(placed, opt_s, osh)
                batch = {n: torch.zeros(t.shape, dtype=t.dtype) for n, t in
                         input_specs(arch, shape_name).items()}
            res = graph.trace_cost(step, masters, opt_state, batch, mode=mode)
        return res, {"microbatches": nmb, "moments": mdtype}
    cfg = serving_cfg(cfg, shape.kind)
    rows = batch_rows(mesh, shape.global_batch)
    S = shape.seq_len
    with sh.use_mesh(mesh), mode:
        lm = fake_model(cfg)
        weights = list(lm.parameters())
        if shape.kind == "prefill":
            if cfg.family == "encdec":
                args = (torch.zeros((rows, S, cfg.d_model),
                                    dtype=torch.bfloat16),
                        torch.zeros((rows, S // DEC_RATIO), dtype=torch.long))
            else:
                args = (torch.zeros((rows, S), dtype=torch.long),)
                if cfg.modality == "vision":
                    args += (torch.zeros((rows, dense.N_IMG, cfg.d_model),
                                         dtype=torch.bfloat16),)
            fn = lm.prefill
        else:
            args = (decode_cache(cfg, rows, S, getattr(lm, "kv_heads",
                                                       None)),
                    torch.zeros((rows, 1), dtype=torch.long), S - 1)
            fn = lm.decode_step
    res = graph.trace_cost(fn, *args, live=weights, mode=mode)
    tp = getattr(lm, "tp", None)
    return res, {"rows_per_device": rows, "kv_quant": cfg.kv_quant,
                 "tp": None if tp is None else {
                     "tp": tp.tp, "attn": tp.attn, "heads": tp.heads,
                     "kv_heads": tp.kv_heads, "ffn": tp.ffn,
                     "vocab": tp.vocab}}


def analyze(cost: dict, chips: int, cfg, shape) -> dict:
    """The three-term roofline of a traced cell (per device)."""
    flops, nbytes = cost["flops"], cost["bytes"]
    t_compute, t_memory = cost["t_compute_s"], cost["t_memory_s"]
    t_coll = cost["t_collective_s"]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        model_flops = 6 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * n_active * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * n_active * shape.global_batch
    total = flops * chips
    coll = {"total": cost["collective_total"], "ops": cost["collective_ops"]}
    coll.update({k: v for k, v in cost.items()
                 if k.startswith(("coll_", "n_"))})
    peak = cost["peak_bytes"]
    return {
        "chips": int(chips),
        "flops_per_device": flops,
        "flops_bf16_per_device": cost["flops_bf16"],
        "flops_f32_per_device": cost["flops_f32"],
        "hbm_bytes_per_device": nbytes,
        "collective_bytes_per_device": cost["collective_total"],
        "collectives": coll,
        "peak_bytes_per_device": peak,
        "fits_hbm_80g": bool(peak <= hw.HBM_BYTES),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": graph.dominant(t_compute, t_memory, t_coll),
        "model_flops": model_flops,
        "flops_total": total,
        "useful_flops_ratio": model_flops / total if total else None,
        "roofline_fraction": graph.roofline_fraction(
            model_flops, chips, (t_compute, t_memory, t_coll)),
        "kernel_nodes": cost["kernel_nodes"],
        "card": f"{hw.NAME}, {hw.POWER_W} W (datasheet peaks, modelled)",
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: Path,
             one_device: bool = False) -> dict:
    mesh_tag = "dev1" if one_device else "pod2" if multi_pod else "pod1"
    tag = f"{arch}.{shape_name}.{mesh_tag}"
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    t0 = time.time()
    try:
        mesh = one_device_mesh() if one_device else production_mesh(
            multi_pod)
        # 400B+ on two pods: ZeRO state spans the pods too
        sh.set_fsdp_spans_pods(multi_pod and cfg.param_count() >
                               FSDP_PODS_PARAMS)
        cost, extra = trace_cell(arch, shape_name, mesh)
        chips = 1 if one_device else MeshConfig(multi_pod).num_devices
        res = analyze(cost, chips, cfg, shape)
        res.update(extra)
        res.update({"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                    "status": "ok", "trace_s": time.time() - t0})
        print(f"[{tag}] cost: flops/dev={res['flops_per_device']:.3e} "
              f"bytes/dev={res['hbm_bytes_per_device']:.3e} "
              f"coll/dev={res['collective_bytes_per_device']:.3e} "
              f"peak/dev={res['peak_bytes_per_device'] / 1e9:.2f} GB")
        print(f"[{tag}] roofline: compute={res['t_compute_s']:.4f}s "
              f"memory={res['t_memory_s']:.4f}s "
              f"collective={res['t_collective_s']:.4f}s "
              f"dominant={res['dominant']} "
              f"frac={res['roofline_fraction']:.4g}")
    except Exception as e:  # recorded: a fault to fix
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(f"[{tag}] FAILED: {res['error']}")
    finally:
        sh.set_fsdp_spans_pods(False)
    res["wall_s"] = time.time() - t0
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / f"{tag}.json").write_text(json.dumps(res, indent=2,
                                                   default=str))
    return res


SUMMARY_KEYS = ("status", "dominant", "t_compute_s", "t_memory_s",
                "t_collective_s", "roofline_fraction", "flops_per_device",
                "hbm_bytes_per_device", "collective_bytes_per_device",
                "peak_bytes_per_device", "fits_hbm_80g",
                "useful_flops_ratio")


def write_summary(outdir: Path) -> Path:
    """Fold every cell's JSON in `outdir` into one summary.json keyed by
    cell tag (the reference's keys, `fits_hbm_80g` for its
    `fits_hbm_16g`), the file `tools/roofline_diff.py` compares."""
    cells_d = {}
    for p in sorted(outdir.glob("*.json")):
        if p.name == "summary.json":
            continue
        r = json.loads(p.read_text())
        if "arch" not in r or "shape" not in r:
            continue
        cells_d[f"{r['arch']}.{r['shape']}.{r['mesh']}"] = {
            k: r.get(k) for k in SUMMARY_KEYS}
    summary = {"cells": cells_d,
               "n_ok": sum(c["status"] == "ok" for c in cells_d.values()),
               "n_error": sum(c["status"] != "ok"
                              for c in cells_d.values())}
    out = outdir / "summary.json"
    out.write_text(json.dumps(summary, indent=2, default=str))
    print(f"summary: {len(cells_d)} cells -> {out}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--one-device", action="store_true",
                    help="trace each cell whole on one device (tag dev1)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)
    outdir = Path(args.out)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    if args.one_device:
        meshes = (False,)
    if args.all:
        jobs = [(arch, s.name, mp) for mp in meshes for arch in ARCH_IDS
                for s in cells(arch)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        jobs = [(args.arch, args.shape, mp) for mp in meshes]
    ok = bad = 0
    for arch, shape_name, mp in jobs:
        mesh_tag = "dev1" if args.one_device else "pod2" if mp else "pod1"
        tag = f"{arch}.{shape_name}.{mesh_tag}"
        if args.skip_done and (outdir / f"{tag}.json").exists():
            prev = json.loads((outdir / f"{tag}.json").read_text())
            if prev.get("status") == "ok":
                ok += 1
                continue
        res = run_cell(arch, shape_name, mp, outdir, args.one_device)
        ok += res["status"] == "ok"
        bad += res["status"] != "ok"
    release()
    write_summary(outdir)
    print(f"dryrun: {ok} ok, {bad} failed")
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
