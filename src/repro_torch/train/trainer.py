"""The training step (the port of `repro.train.trainer`): gradients of
`models.model.loss_fn` by autograd in f32, accumulated over
microbatches, optionally through the int8 round trip, then AdamW. Remat
is the models' (`cfg.remat`).

The step is functional, as the reference's: `train_step(masters,
opt_state, batch)` returns new masters and state and leaves its inputs
as they were.

On a mesh (`dist.sharding.use_mesh`; the reference's jit under
`state_shardings`), masters and AdamW state are DTensors placed by
`state_shardings`: FSDP on "data", tensor and expert dimensions on
"model" (`place_states`). A step gathers the masters whole (ZeRO-3),
runs this rank's rows of the batch (split on "batch"), sums the
gradients over the data ranks (each microbatch's loss weighted by its
share of the valid labels, so the sum is the global mean's gradient),
and each rank updates its own shards: the result is the single-device
step's up to reduction order. Under expert parallelism (a "model" axis;
`models.moe.ep_ffn`) the MoE layers take their expert and router shards
as they are and gather them themselves. The compute is not split over
"model" (no column- or row-parallel matmuls): those ranks repeat the
dense layers, and the activations stay whole. So the reference's
`seq_sp` (the residual stream split on the sequence, the MoE output
reduce-scattered onto it) has no counterpart yet, and its `shard`
constraints only change placements, which plain tensors do not carry.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.convert import tree_map
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as sh
from repro_torch.models import model as model_mod
from repro_torch.models.dense import LM
from repro_torch.train import optimizer as opt
from repro_torch.train.grad_compress import compress_decompress


def moments_dtype_for(cfg: ModelConfig) -> str:
    """int8 moments past 60 B parameters (see `optimizer`)."""
    return "int8" if cfg.param_count() > 60e9 else "float32"


def microbatches_for(cfg: ModelConfig, global_batch: int,
                     seq_len: int = 4096, mesh=None) -> int:
    """The reference's microbatch count: 8 past 60 B parameters, 4 past 5
    B, else 1; at least enough that a microbatch holds <= 256k tokens;
    halved until it divides the batch into microbatches that the data
    ranks of `mesh` ("data" x "pod") divide."""
    dp = sh.mesh_shape(mesh).get("data", 1) * \
        sh.mesh_shape(mesh).get("pod", 1)
    n = cfg.param_count()
    want = 8 if n > 60e9 else (4 if n > 5e9 else 1)
    want = max(want, (global_batch * seq_len) // (256 * 1024))
    while want > 1 and (global_batch % want or (global_batch // want) % dp):
        want //= 2
    return max(want, 1)


def loss_and_grads(model: LM, masters, batch, z_coef: float,
                   scale: Optional[float] = None):
    """(loss, metrics, f32 gradients name -> tensor) of one batch: the
    masters' gradients by autograd (zeros for a tensor the loss does not
    reach), of loss * `scale` when given."""
    leaves = {n: t.detach().requires_grad_(True) for n, t in masters.items()}
    loss, metrics = model_mod.loss_fn(model, leaves, batch, z_coef=z_coef)
    target = loss if scale is None else loss * scale
    gs = torch.autograd.grad(target, list(leaves.values()),
                             allow_unused=True)
    grads = {n: torch.zeros_like(t) if g is None else g.float()
             for (n, t), g in zip(leaves.items(), gs)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def accumulate(model: LM, params, batch, nmb: int, z_coef: float,
               part=(0, 1)):
    """(loss, metrics, f32 gradients) of `batch` in `nmb` equal
    microbatches, of which this process takes part `part` = (index,
    count) of each: the whole microbatch by default, its rows on one of
    the data ranks on a mesh. A part's loss is weighted by its share of
    the microbatch's valid labels, so the parts' weighted losses sum over
    the ranks to the microbatch's. The gradients sum in f32 (bf16 past
    300 B parameters) and, as the loss, are divided by `nmb`. The
    metrics are `loss_fn`'s (weighted likewise; "ntokens" the whole
    microbatch's) with one microbatch, else the loss alone."""
    idx, n = part
    B = next(iter(batch.values())).shape[0]
    if B % nmb or (B // nmb) % n:
        raise ValueError(f"batch {B} in {nmb} microbatches of {n} parts")
    bmb, rows = B // nmb, B // nmb // n
    acc_dtype = torch.bfloat16 if model.cfg.param_count() > 3e11 \
        else torch.float32
    ok = batch["labels"] != model_mod.IGNORE_LABEL if n > 1 else None
    grads, lsum, metrics = None, torch.zeros((), device=model.device), {}
    for j in range(nmb):
        lo = j * bmb + idx * rows
        mb = {k: t.narrow(0, lo, rows) for k, t in batch.items()}
        share = None
        if n > 1:
            n_all = ok[j * bmb:(j + 1) * bmb].sum().clamp(min=1)
            share = (ok[lo:lo + rows].sum() / n_all).item()
        loss_j, met_j, g = loss_and_grads(model, params, mb, z_coef,
                                          scale=share)
        lsum = lsum + (loss_j if share is None else loss_j * share)
        if nmb == 1:
            grads = g
            metrics = met_j if share is None else dict(
                {k: v * share for k, v in met_j.items() if k != "ntokens"},
                ntokens=n_all)
        else:
            g = {k: v.to(acc_dtype) for k, v in g.items()}
            grads = g if grads is None else {k: grads[k] + g[k]
                                             for k in grads}
    if nmb > 1:
        grads = {k: v.float() / nmb for k, v in grads.items()}
    loss = lsum / nmb
    return loss, dict(metrics, loss=loss), grads


def make_train_step(run: RunConfig, model: LM, *, max_steps: int = 10000,
                    microbatches: Optional[int] = None):
    """Returns (train_step, microbatch count, moment type) for `model`
    (built from `run.model`; its own weights are not read). The step runs
    on the mesh installed when it is called (DTensor states placed by
    `place_states`), else on the model's device; the microbatch count
    divides the batch among the data ranks of the mesh installed now.

    train_step(masters, opt_state, batch) -> (masters, opt_state,
    metrics): `batch` is a dict of arrays (numpy or tensors) with the
    global batch on the leading axis, moved to the model's device. The
    gradients and loss are `accumulate`'s; then "int8_ef" compression if
    the config asks, and AdamW (adding "grad_norm" and "lr")."""
    cfg, tcfg = run.model, run.train
    if model.cfg != cfg:
        raise ValueError(f"the model runs {model.cfg.name}, the run "
                         f"{cfg.name}")
    nmb = microbatches if microbatches is not None else \
        microbatches_for(cfg, run.shape.global_batch, run.shape.seq_len,
                         sh.get_mesh())
    mdtype = moments_dtype_for(cfg)
    lr_fn = opt.lr_schedule(tcfg, max_steps)

    def train_step(masters, opt_state, batch):
        mesh = sh.get_mesh()
        if mesh is not None:
            return mesh_step(run, model, mesh, nmb, mdtype, lr_fn, masters,
                             opt_state, batch)
        batch = model_mod.to_device(batch, model.device)
        _, metrics, grads = accumulate(model, masters, batch, nmb,
                                       tcfg.z_loss)
        if tcfg.grad_compression == "int8_ef":
            grads = compress_decompress(grads)
        masters2, opt_state2, om = opt.adamw_update(
            tcfg, masters, grads, opt_state, lr_fn, mdtype)
        metrics.update(om)
        return masters2, opt_state2, metrics

    return train_step, nmb, mdtype


def make_states(run: RunConfig, seed: int = 0, device="cuda"):
    """(model, masters, opt_state) of `run.model` on `device`: the model
    with random weights from `seed` (the port's draw, in the config's
    dtype), f32 masters copied from them (so the model serves what the
    masters hold), and zeroed AdamW state of `moments_dtype_for`."""
    model = model_mod.build_model(run.model, device=device, seed=seed)
    m = model_mod.masters(model)
    return model, m, opt.init_opt_state(m, moments_dtype_for(run.model))


# ------------------------------------------------------------ on a mesh


def state_structs(run: RunConfig):
    """(masters, opt_state) as meta tensors (shapes and dtypes, no
    storage), the reference's `make_states(abstract=True)`."""
    mdtype = moments_dtype_for(run.model)

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    shapes = model_mod.param_shapes(run.model)
    masters = {n: meta(s) for n, s in shapes.items()}
    if mdtype == "int8":
        m = {n: {"q": meta(s, torch.int8), "s": meta(tuple(s[:-1]) + (1,))}
             for n, s in shapes.items()}
        v = {n: meta(s, torch.bfloat16) for n, s in shapes.items()}
    else:
        m = dict(masters)
        v = dict(masters)
    return masters, {"m": m, "v": v, "step": meta((), torch.int32)}


def state_shardings(run: RunConfig, mesh):
    """NamedShardings (`dist.sharding`) for (masters, opt_state, batch)
    under `mesh`, pruned per tensor against the actual shapes."""
    cfg = run.model
    pspecs = model_mod.param_specs(cfg)
    ospecs = opt.opt_state_specs(pspecs, moments_dtype_for(cfg))
    masters_s, opt_s = state_structs(run)
    batch_s = model_mod.batch_struct(cfg, run.shape)
    return (sh.spec_tree_to_shardings(mesh, pspecs, masters_s),
            sh.spec_tree_to_shardings(mesh, ospecs, opt_s),
            sh.spec_tree_to_shardings(mesh, model_mod.batch_specs(cfg),
                                      batch_s))


def place_states(run: RunConfig, mesh, masters, opt_state):
    """(masters, opt_state), whole tensors the same on every rank, as
    DTensors placed by `state_shardings`."""
    psh, osh, _ = state_shardings(run, mesh)
    return (tree_map(sh.distribute, masters, psh),
            tree_map(sh.distribute, opt_state, osh))


def mesh_step(run: RunConfig, model: LM, mesh, nmb: int, mdtype: str,
              lr_fn, masters, opt_state, batch):
    """One train step on `mesh` (see the module's docstring). `batch` is
    the global batch (numpy or tensors), the same on every rank; the
    states are DTensors. Returns (masters, opt_state, metrics) placed as
    they came, the metrics global (the same on every rank)."""
    from torch.distributed.tensor import DTensor
    tcfg = run.train
    bad = [n for n, t in masters.items() if not isinstance(t, DTensor)]
    if bad:
        raise TypeError(f"on a mesh the masters are DTensors "
                        f"(trainer.place_states); not: {bad[:3]}")
    ep = model.local_weights(mesh)     # name -> its gathered dimension
    batch = model_mod.to_device(batch, model.device)
    B = next(iter(batch.values())).shape[0]
    baxes = sh.spec_axes(sh.logical_to_spec(mesh, ("batch",),
                                            (B // nmb,))[0])

    def fsdp_axes(n):          # the mesh axes of an EP weight's FSDP dim
        return sh.spec_axes(sh.spec_of(masters[n])[ep[n]])
    for n in ep:
        if not set(fsdp_axes(n)) <= set(baxes):
            raise ValueError(f"{n}: FSDP axes {fsdp_axes(n)} do not "
                             f"split the batch ({baxes})")
    params = {n: t.to_local() if n in ep else t.full_tensor()
              for n, t in masters.items()}
    _, mets, grads = accumulate(model, params, batch, nmb, tcfg.z_loss,
                                sh.local_index(mesh, baxes))

    # the sums over the data ranks: whole gradients in one flat buffer;
    # the expert-parallel shards were reduce-scattered over their FSDP
    # axes by the backward pass and sum over the other batch axes here
    names = [n for n in grads if n not in ep]
    if names and baxes:
        flat = C.all_reduce(torch.cat([grads[n].reshape(-1) for n in names]),
                            mesh, baxes)
        for n, part in zip(names, flat.split([grads[n].numel()
                                              for n in names])):
            grads[n] = part.view_as(grads[n])
    for n in ep:
        rest = [a for a in baxes if a not in fsdp_axes(n)]
        if rest:
            C.all_reduce(grads[n], mesh, rest)
    # the metrics: each rank's weighted by its share, summed
    vals = {k: v for k, v in mets.items() if k != "ntokens"}
    keys = sorted(vals)
    vec = torch.stack([vals[k].float().reshape(()) for k in keys])
    if baxes:
        C.all_reduce(vec, mesh, baxes)
    metrics = dict(zip(keys, vec.unbind()))
    if "ntokens" in mets:
        metrics["ntokens"] = mets["ntokens"]
    if tcfg.grad_compression == "int8_ef":
        grads = compress_decompress(grads)

    # the global norm: whole gradients are the same on every rank; the
    # expert-parallel shards sum their squares over the axes that split
    # them
    sq = sum(torch.sum(torch.square(grads[n])) for n in names) \
        if names else torch.zeros((), device=model.device)
    for n in ep:
        part = torch.sum(torch.square(grads[n]))
        split = [a for e in sh.spec_of(masters[n]) for a in sh.spec_axes(e)]
        sq = sq + (C.all_reduce(part, mesh, split) if split else part)
    gnorm = torch.sqrt(sq)

    local_g, row_max = {}, {}
    for n, t in masters.items():
        spec = sh.spec_of(t)
        local_g[n] = grads[n] if n in ep else sh.local_slice(grads[n], mesh,
                                                              spec)
        last = sh.spec_axes(spec[-1]) if spec else ()
        if mdtype == "int8" and last:
            row_max[n] = (lambda mx, ax=last: C.all_reduce(
                mx, mesh, ax, op=torch.distributed.ReduceOp.MAX))

    new_p, new_s, om = opt.adamw_update(
        tcfg, tree_map(lambda t: t.to_local(), masters), local_g,
        tree_map(lambda t: t.to_local(), opt_state), lr_fn, mdtype,
        gnorm=gnorm, row_max=row_max)
    metrics.update(om)
    return (tree_map(sh.from_local, new_p, masters),
            tree_map(sh.from_local, new_s, opt_state), metrics)
