"""The multi-rank cases of tests/test_torch_sharding.py, run by every
rank of one spawned 4-rank gloo group on the CPU (a 2 x 2 mesh over
("data", "model"), and a 1 x 4 one of the same ranks). Each case raises
on a mismatch; `run_rank` records each case's outcome ("ok" or the
traceback) in <out>/rank<r>.json, so the test process reports each case
as its own test. Imports torch and the port only: the training cases
hold the port to its single-device results, which the other test files
hold to the reference; the tensor-parallel serving cases (`TP_CASES`)
to the reference's single-device outputs, which the test process
computes before the group starts and leaves in <out>/tp_<name>.npz."""
import dataclasses
import json
import os
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
from repro_torch.configs import get_reduced
from repro_torch.convert import (state_from_tree, state_tree, tree_leaves,
                                 tree_map)
from repro_torch.core import distributed as cd
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import sharding as sh
from repro_torch.dist.fault import reshard_restore
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.dist import collectives as C
from repro_torch.models import model as tm
from repro_torch.models import moe
from repro_torch.models.dense import DenseLM
from repro_torch.serving.engine import Engine
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer

WORLD = 4
TIMEOUT_S = 120


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _batch(cfg, B=8, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(4, 100, (B, S)).astype(np.int32),
            "labels": rng.integers(4, 100, (B, S)).astype(np.int32)}


def sharded_retrieval(mesh, out):
    """tests/test_dist.py's SCRIPT_SHARDED_RETRIEVAL on the port: ids
    exact, distances within 1e-4 of `reference_retrieval`; the inputs
    placed by `retrieval_shardings` and, again, whole."""
    rng = np.random.default_rng(0)
    NC, CAP, d, B, k, P = 16, 32, 24, 4, 5, 6
    data = rng.normal(size=(NC, CAP, d)).astype(np.float32)
    lens = rng.integers(8, CAP + 1, NC).astype(np.int32)
    for c in range(NC):
        data[c, lens[c]:] = 0
    sid = np.arange(NC * CAP).reshape(NC, CAP).astype(np.int32)
    cent = data[:, 0, :].copy()
    q = rng.normal(size=(B, d)).astype(np.float32)
    ins = [torch.tensor(a) for a in (q, cent, data, lens, sid)]
    ret = cd.make_sharded_retrieval(mesh, k=k, n_probe=P)
    rd, ri = cd.reference_retrieval(q, cent, data, lens, sid, k=k,
                                    n_probe=P)
    placed = [sh.distribute(t, s)
              for t, s in zip(ins, cd.retrieval_shardings(mesh))]
    for args in (placed, ins):
        dists, ids = ret(*args)
        np.testing.assert_allclose(dists.numpy(), rd, rtol=1e-4, atol=1e-4)
        assert (ids.numpy() == ri).all(), (ids, ri)
    # k past the valid candidates of a probe set: (inf, -1)
    d2, i2 = cd.make_sharded_retrieval(mesh, k=200, n_probe=2)(*ins)
    n_valid = int((i2 >= 0).sum(1).min())
    assert torch.isinf(d2[:, -1]).all() and (i2[:, -1] == -1).all()
    assert n_valid >= 16


_STATES = {}


def _states(cfg, z_loss, B=8, S=32, shards=1):
    """(model, masters, f32 state, batch, single-device metrics and
    gradients) of `cfg` at B x S, made once for the cases that share them
    (the steps are functional: no case changes them). The single-device
    objective is the mean of the losses of `shards` equal row blocks
    (one: the batch's loss)."""
    key = (cfg, z_loss, B, S, shards)
    if key not in _STATES:
        run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"))
        model, masters, state = trainer.make_states(run, seed=0,
                                                    device="cpu")
        batch = tm.to_device(_batch(cfg, B, S), "cpu")
        met, grads = {}, {}
        for r in range(shards):
            rows = {k: v[r * B // shards:(r + 1) * B // shards]
                    for k, v in batch.items()}
            _, m, g = trainer.loss_and_grads(model, masters, rows, z_loss)
            for k, v in m.items():
                met[k] = met.get(k, 0) + (v if k == "ntokens"
                                          else v / shards)
            for n, t in g.items():
                grads[n] = grads.get(n, 0) + t / shards
        _STATES[key] = (model, masters, state, batch, met, grads)
    return _STATES[key]


def _step_pair(mesh, cfg, tcfg, moments=None, B=8, S=32, shards=1):
    """The single-device step and the mesh step from the same states;
    returns (single (masters, metrics, state), mesh (whole masters,
    metrics, DTensor state), the single-device gradients, lr) (the
    single-device objective: `_states`')."""
    run = RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                    train=tcfg)
    model, masters, state, batch, met, g = _states(cfg, tcfg.z_loss, B, S,
                                                   shards)
    if moments is not None:
        state = opt.init_opt_state(masters, moments)
    mdtype = moments or trainer.moments_dtype_for(cfg)
    lr_fn = opt.lr_schedule(tcfg, 10000)
    p1, s1, om = opt.adamw_update(tcfg, masters, g, state, lr_fn, mdtype)
    m1 = dict(met, **om)
    pspecs = tm.param_specs(cfg)
    ostructs = (opt.init_opt_state({n: torch.empty(t.shape, device="meta")
                                    for n, t in masters.items()}, mdtype)
                if moments else trainer.state_structs(run)[1])
    psh = sh.spec_tree_to_shardings(mesh, pspecs, masters)
    osh = sh.spec_tree_to_shardings(
        mesh, opt.opt_state_specs(pspecs, mdtype), ostructs)
    dm = tree_map(sh.distribute, masters, psh)
    ds = tree_map(sh.distribute, state, osh)
    with sh.use_mesh(mesh):
        p2, s2, m2 = trainer.mesh_step(run, model, mesh, 1, mdtype, lr_fn,
                                       dm, ds, batch)
    return (p1, m1, s1), ({n: _whole(t) for n, t in p2.items()}, m2, s2), \
        g, float(m1["lr"])


def _adam_bound(want, g, lr, eps, rel):
    """PR 27's per-element bound of a parameter after one Adam step whose
    gradients agree to `rel` of the tensor's largest: 1e-6 of the
    tensor's largest, plus lr * min(2, 2 rel gmax / (|g| + eps))."""
    g = g.abs()
    return 1e-6 * want.abs().max() + lr * torch.clamp(
        2 * rel * g.max() / (g + eps), max=2.0)


def train_step_bf16(mesh, out):
    """tests/test_dist.py's SCRIPT_TRAIN_PARITY bounds on reduced
    h2o-danube (bf16 compute): loss within 5e-3, parameters within 5e-2
    of the single-device step."""
    cfg = get_reduced("h2o_danube_1_8b")
    (p1, m1, _), (p2, m2, _), _, _ = _step_pair(
        mesh, cfg, TrainConfig(grad_clip=0.0, warmup_steps=0))
    assert abs(m1["loss"].item() - m2["loss"].item()) < 5e-3
    worst = max(float((p1[n] - p2[n]).abs().max()) for n in p1)
    assert worst < 5e-2, worst


def train_step_f32(mesh, out):
    """The same in f32, held tighter: loss and grad_norm within 1e-6
    relative, every parameter within the Adam first-step bound at a
    1e-5 gradient agreement (the data ranks' sum against one batch's)."""
    cfg = get_reduced("h2o_danube_1_8b").reduced(dtype="float32")
    (p1, m1, _), (p2, m2, _), g, lr = _step_pair(
        mesh, cfg, TrainConfig(grad_clip=0.0, warmup_steps=0))
    for k in ("loss", "grad_norm", "nll", "lr"):
        a, b = m1[k].item(), m2[k].item()
        assert abs(a - b) <= 1e-6 * abs(a), (k, a, b)
    assert int(m2["ntokens"]) == int(m1["ntokens"]) == 8 * 32
    for n in p1:
        bad = (p1[n] - p2[n]).abs() > _adam_bound(p1[n], g[n], lr, 1e-8,
                                                   1e-5)
        assert not bad.any(), n


def train_step_int8_moments(mesh, out):
    """int8 moments on the mesh (a row split over "model" takes its scale
    from the max over the ranks): the step's state equals the
    single-device update's (the m codes to one step of rounding, v in
    bf16), the parameters within the Adam bound, with a clipped global
    norm."""
    cfg = get_reduced("h2o_danube_1_8b").reduced(dtype="float32")
    tcfg = TrainConfig(grad_clip=0.5, warmup_steps=0)
    (p1, m1, s1), (p2, m2, s2), g, lr = _step_pair(mesh, cfg, tcfg, "int8")
    assert abs(m1["grad_norm"].item() - m2["grad_norm"].item()) <= \
        1e-6 * m1["grad_norm"].item()
    assert m1["grad_norm"].item() > tcfg.grad_clip
    for n in p1:
        mq, ms = _whole(s2["m"][n]["q"]), _whole(s2["m"][n]["s"])
        assert ms.shape == s1["m"][n]["s"].shape
        torch.testing.assert_close(ms, s1["m"][n]["s"], rtol=1e-5, atol=0)
        assert (mq.int() - s1["m"][n]["q"].int()).abs().max() <= 1, n
        assert _whole(s2["v"][n]).dtype == torch.bfloat16
        bad = (p1[n] - p2[n]).abs() > _adam_bound(p1[n], g[n], lr, 1e-8,
                                                   1e-5)
        assert not bad.any(), n


def _moe_losses(mesh, int8_gather):
    cfg = get_reduced("granite_moe_1b_a400m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, int8_gather=int8_gather))
    model = tm.build_model(cfg, device="cpu", seed=0)
    masters = tm.masters(model)
    batch = tm.to_device(_batch(cfg, 4, 32), "cpu")
    with torch.no_grad():
        l1, _ = tm.loss_fn(model, masters, batch)
        with sh.use_mesh(mesh):
            idx, n = sh.local_index(mesh, ("data",))
            mb = {k: v[idx * 4 // n:(idx + 1) * 4 // n]
                  for k, v in batch.items()}
            l2, _ = tm.loss_fn(model, masters, mb)
    l2 = l2.clone()
    dist.all_reduce(l2, group=mesh.get_group("data"))
    return l1.item(), l2.item() / sh.mesh_shape(mesh)["data"]


def moe_ep_loss_plain_gather(mesh, out):
    """tests/test_dist.py's SCRIPT_MOE_PARITY: the expert-parallel loss
    (rows split on "data", experts on "model", bf16 all-gathers) within
    0.05 of the local path's (capacity drops differ with the rows)."""
    l1, l2 = _moe_losses(mesh, False)
    assert abs(l1 - l2) < 0.05, (l1, l2)


def moe_ep_loss_int8_gather(mesh, out):
    """The same with `int8_gather`: the FSDP gathers move int8 values
    and per-row scales."""
    l1, l2 = _moe_losses(mesh, True)
    assert abs(l1 - l2) < 0.05, (l1, l2)


def moe_ep_step(mesh, out):
    """Without capacity drops (factor 8) expert parallelism computes the
    local path's function, but for the aux loss, which each data rank
    takes over its own rows (as the reference's shard_map does): the f32
    mesh step of reduced granite-moe (its router and experts as shards,
    gathered in the layer, their gradients reduce-scattered; x's and the
    router's summed over "model") equals the single-device step of the
    same objective, the mean of the two row halves' losses: loss, nll,
    aux and grad_norm within 1e-6 relative, parameters within the Adam
    bound."""
    cfg = get_reduced("granite_moe_1b_a400m").reduced(dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    (p1, m1, _), (p2, m2, _), g, lr = _step_pair(
        mesh, cfg, TrainConfig(grad_clip=0.0, warmup_steps=0), B=4,
        shards=sh.mesh_shape(mesh)["data"])
    for k in ("loss", "nll", "moe_aux", "grad_norm"):
        a, b = m1[k].item(), m2[k].item()
        assert abs(a - b) <= 1e-6 * abs(a), (k, a, b)
    for n in p1:
        bad = (p1[n] - p2[n]).abs() > _adam_bound(p1[n], g[n], lr, 1e-8,
                                                   1e-5)
        assert not bad.any(), n


def moe_ep_ffn(mesh, out):
    """`ep_ffn` with whole weights computes `train_ffn`'s function: each
    model rank's experts' slots (capacity and drops as on one device),
    summed over "model", equal the one-device FFN of the same rows, and
    the aux loss, averaged over ranks that route the same tokens, is the
    one-device one."""
    cfg = get_reduced("granite_moe_1b_a400m").reduced(dtype="float32")
    model = tm.build_model(cfg, device="cpu", seed=0)
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator(
    ).manual_seed(1))
    w = (model.router[0], model.we1[0], model.we2[0], model.we3[0])
    with torch.no_grad():
        y, aux = moe.ep_ffn(cfg, x, *w, mesh)
        want, want_aux = moe.train_ffn(cfg, x.reshape(-1, cfg.d_model), *w)
    torch.testing.assert_close(y, want.reshape(y.shape), rtol=1e-5,
                               atol=1e-5)
    assert abs(aux.item() - want_aux.item()) <= 1e-6 * abs(want_aux.item())


def q8_all_gather(mesh, out):
    """`Q8AllGather` over "data": each rank's [4, 16] shard quantised per
    row, the gathered [8, 16] within half a step of its row scale (and
    bf16's rounding) of the whole weight; the backward reduce-scatters
    the gradient straight through (each rank gets the sum of the ranks'
    bf16 upstream gradients over its rows)."""
    g = torch.Generator().manual_seed(5)
    whole = torch.randn(8, 16, generator=g)
    r = torch.randn(8, 16, generator=g)
    idx, n = sh.local_index(mesh, ("data",))
    w = whole[idx * 4:(idx + 1) * 4].clone().requires_grad_(True)
    y = moe.Q8AllGather.apply(w, mesh, ("data",), 0, 1)
    assert y.dtype == torch.bfloat16 and y.shape == (8, 16)
    step = whole.abs().amax(1, keepdim=True) / 127.0
    err = (y.float() - whole).abs()
    assert bool((err <= 0.5 * step + 2 ** -8 * whole.abs() + 1e-6).all())
    (y.float() * r).sum().backward()
    want = n * r.to(torch.bfloat16).float()[idx * 4:(idx + 1) * 4]
    assert torch.equal(w.grad, want)


def elastic(mesh, out):
    """tests/test_elastic.py on the port: two steps on the 2 x 2 mesh, a
    checkpoint, `reshard_restore` onto a 2-rank (2 x 1) mesh, every
    master and moment bit-equal (ranks 2 and 3 are lost), then one
    finite step there."""
    cfg = get_reduced("h2o_danube_1_8b")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                    train=TrainConfig(warmup_steps=0))
    model, masters, state, batch, _, _ = _states(cfg, run.train.z_loss)
    step, _, _ = trainer.make_train_step(run, model, microbatches=1)
    with sh.use_mesh(mesh):
        pm, ps = trainer.place_states(run, mesh, masters, state)
        for _ in range(2):
            pm, ps, _ = step(pm, ps, batch)
    ckdir = os.path.join(out, "elastic")
    ckpt.save(ckdir, 2, state_tree(pm, ps))
    want = [_whole(t) for t in tree_leaves(state_tree(pm, ps))]
    from torch.distributed.device_mesh import DeviceMesh
    mesh2 = DeviceMesh("cpu", torch.tensor([[0], [1]]),
                       mesh_dim_names=("data", "model"))
    if mesh2.get_coordinate() is None:
        return
    like = state_tree(*trainer.state_structs(run))
    pspecs = tm.param_specs(cfg)
    specs = state_tree(pspecs, opt.opt_state_specs(pspecs, "float32"))
    tree, start = reshard_restore(ckdir, like, mesh2, specs)
    assert start == 3
    got = [t.full_tensor() for t in tree_leaves(tree)]
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pm2, ps2 = state_from_tree(tree)
    assert pm2["wq"].placements[0].is_shard(1)
    with sh.use_mesh(mesh2):
        _, _, m2 = step(pm2, ps2, batch)
    assert np.isfinite(m2["loss"].item())


def dtensor_layout(mesh, out):
    """A dimension split over ("pod", "data") on a (2, 2, 1) mesh: DTensor
    cuts it pod-major as the PartitionSpec tuple does, `local_slice`
    agrees with the DTensor's own part, and `shard` redistributes."""
    mesh3 = make_test_mesh(data=2, tp=1, pod=2, device_type="cpu")
    t = torch.arange(8 * 3.0).reshape(8, 3)
    s = sh.sharding_for(mesh3, "batch", shape=t.shape)
    assert s.spec == (("pod", "data"), None), s.spec
    dt = sh.distribute(t, s)
    coord = dict(zip(mesh3.mesh_dim_names, mesh3.get_coordinate()))
    i = coord["pod"] * 2 + coord["data"]
    assert torch.equal(dt.to_local(), t[2 * i:2 * i + 2])
    assert torch.equal(sh.local_slice(t, mesh3, s.spec), dt.to_local())
    assert sh.spec_of(dt) == s.spec
    assert torch.equal(dt.full_tensor(), t)
    # `shard` moves a DTensor to its logical placement on the ambient mesh
    with sh.use_mesh(mesh3):
        rep = sh.shard(dt, None, None)
        assert all(p.is_replicate() for p in rep.placements)
        assert torch.equal(rep.to_local(), t)
        assert sh.spec_of(sh.shard(rep, "batch")) == s.spec
    assert sh.shard(dt, None) is dt                 # off-mesh: as it is


# tensor-parallel serving: name -> (arch, reduced overrides, prompt
# length, rows); the reduced dense configs (H 4, G 2, d 128) in f32, one
# wave of equal-length prompts. The ring's 80 positions wrap h2o's
# 64-position window.
TP_CASES = {
    "qwen": ("qwen25_0_5b", {}, 21, 4),
    "h2o_ring": ("h2o_danube_1_8b", {}, 80, 4),
    "qwen_int8": ("qwen25_0_5b", {"kv_quant": True}, 21, 4),
}
TP_MAX_NEW = 5          # the prefill's token, then 4 greedy decode steps
TP_MAX_LEN = 96
TP_SEED = 0
_MESHES = {}


def tp_config(name):
    arch, over, _, _ = TP_CASES[name]
    return get_reduced(arch).reduced(dtype="float32", **over)


def tp_prompts(name):
    """The case's prompts [rows, length] int32, made from its seed."""
    _, _, S, B = TP_CASES[name]
    rng = np.random.default_rng(TP_SEED)
    return rng.integers(4, 500, (B, S)).astype(np.int32)


def _mesh(shape):
    """The (data, model) mesh of the four ranks, made once a shape."""
    if shape not in _MESHES:
        _MESHES[shape] = make_test_mesh(*shape, device_type="cpu")
    return _MESHES[shape]


def whole_cache(cache, lm, mesh, axes):
    """The wave cache of every rank of `mesh` re-assembled: each plane's
    kv heads gathered over "model" (the tp / G copies of a kv head that
    ranks share checked bit-equal, one kept), its rows over the batch
    `axes`."""
    tp = lm.tp
    out = {}
    for n, t in cache.items():
        if t.ndim == 4:                         # scales [L, b, Sc, G]
            t = t[..., None]
        g = C.all_gather(t, mesh, ("model",), 3) if tp.attn else t
        if tp.attn and tp.kv_heads * tp.tp > lm.cfg.num_kv_heads:
            rep = tp.tp // lm.cfg.num_kv_heads
            parts = g.unflatten(3, (lm.cfg.num_kv_heads, rep))
            assert all(torch.equal(parts[:, :, :, :, j], parts[:, :, :, :, 0])
                       for j in range(rep)), n
            g = parts[:, :, :, :, 0]
        if axes:
            g = C.all_gather(g, mesh, axes, 1)
        out[n] = g[..., 0] if cache[n].ndim == 4 else g
    return out


def _tp_case(name, shape):
    """A TP_CASES case on the (data, model) mesh `shape`: every rank
    builds the dense model under the mesh from the reference's converted
    params (its part: `tp_layout`), prefills its rows (a "batch" part,
    `batch_part`) and decodes greedily through the wave Engine under the
    mesh. Held to the reference's single-device prefill and Engine: the
    logits within 1e-5, the cache re-assembled from the ranks within
    1e-5 (int8 planes bit-equal, their scales within 1e-5 relative),
    every rank's tokens equal."""
    def case(mesh, out):
        ref = np.load(os.path.join(out, f"tp_{name}.npz"))
        params = {k[2:]: torch.tensor(ref[k]) for k in ref.files
                  if k.startswith("p/")}
        cfg = tp_config(name)
        toks = tp_prompts(name)
        m = mesh if tuple(sh.mesh_shape(mesh).values()) == shape \
            else _mesh(shape)
        with sh.use_mesh(m):
            lm = DenseLM(cfg, device="cpu", params=params)
            assert lm.tp.tp == shape[1]
            lo, hi, axes = sh.batch_part(m, len(toks))
            logits, cache = lm.prefill(torch.tensor(toks[lo:hi]).long())
            np.testing.assert_allclose(logits.numpy(), ref["logits"][lo:hi],
                                       rtol=1e-5, atol=1e-5)
            whole = whole_cache(cache, lm, m, axes)
            for n, t in whole.items():
                want = ref["c/" + n]
                if t.dtype == torch.int8:
                    np.testing.assert_array_equal(t.numpy(), want, err_msg=n)
                elif n.endswith("_s"):
                    # max |k| / 127 of k's that differ in the last bits
                    np.testing.assert_allclose(t.numpy(), want, rtol=1e-5,
                                               atol=0, err_msg=n)
                else:
                    np.testing.assert_allclose(t.numpy(), want, rtol=1e-5,
                                               atol=1e-5, err_msg=n)
            res = Engine(lm, max_len=TP_MAX_LEN).generate(
                list(toks), max_new=TP_MAX_NEW, continuous=False)
        got = [r.tokens for r in res]
        want = json.loads(str(ref["gen"]))
        assert got == want, (got, want)
    case.__name__ = f"tp_{name}_{shape[0]}x{shape[1]}"
    return case


CASES = {f.__name__: f for f in (
    sharded_retrieval, dtensor_layout, train_step_bf16, train_step_f32,
    train_step_int8_moments, moe_ep_loss_plain_gather,
    moe_ep_loss_int8_gather, moe_ep_step, moe_ep_ffn, q8_all_gather,
    elastic) + tuple(_tp_case(n, s) for n in TP_CASES
                     for s in ((2, 2), (1, 4)))}


def run_rank(rank: int, store: str, out: str) -> None:
    """One rank of the group: every case in turn, each outcome recorded
    as soon as it is known."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    mesh = make_test_mesh(2, 2, device_type="cpu")
    results = {}
    for name, case in CASES.items():
        t0 = time.perf_counter()
        try:
            case(mesh, out)
            results[name] = "ok"
        except Exception:  # noqa: BLE001 - reported by the test process
            results[name] = traceback.format_exc()
        results[name + ":s"] = time.perf_counter() - t0
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
    dist.destroy_process_group()


def spawn(out: str) -> dict:
    """Run the group; every rank is joined within TIMEOUT_S in all and
    killed past it. Returns rank -> its recorded outcomes."""
    import multiprocessing as mp
    # a fork server that imports this module once (and what the ranks
    # would each import at their first DTensor op and remat layer) and
    # forks the ranks from it: they start without importing torch four
    # times, and without the caller's JAX threads (a plain fork would
    # copy them)
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload([__name__, "torch.distributed.tensor",
                                "torch._dynamo"])
    procs = [ctx.Process(target=run_rank,
                         args=(r, os.path.join(out, "store"), out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = {}
    for r in range(WORLD):
        path = os.path.join(out, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                results[r] = json.load(f)
        else:
            results[r] = {}
    return results
