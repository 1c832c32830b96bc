"""The training step (the port of `repro.train.trainer` on one device):
gradients of `models.model.loss_fn` by autograd in f32, accumulated over
microbatches, optionally through the int8 round trip, then AdamW. Remat
is the models' (`cfg.remat`); sharding waits for the mesh.

The step is functional, as the reference's: `train_step(masters,
opt_state, batch)` returns new masters and state and leaves its inputs
as they were.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import model as model_mod
from repro_torch.models.dense import LM
from repro_torch.train import optimizer as opt
from repro_torch.train.grad_compress import compress_decompress


def moments_dtype_for(cfg: ModelConfig) -> str:
    """int8 moments past 60 B parameters (see `optimizer`)."""
    return "int8" if cfg.param_count() > 60e9 else "float32"


def microbatches_for(cfg: ModelConfig, global_batch: int,
                     seq_len: int = 4096) -> int:
    """The reference's microbatch count at one data-parallel replica: 8
    past 60 B parameters, 4 past 5 B, else 1; at least enough that a
    microbatch holds <= 256k tokens; halved until it divides the batch."""
    n = cfg.param_count()
    want = 8 if n > 60e9 else (4 if n > 5e9 else 1)
    want = max(want, (global_batch * seq_len) // (256 * 1024))
    while want > 1 and global_batch % want:
        want //= 2
    return max(want, 1)


def loss_and_grads(model: LM, masters, batch, z_coef: float):
    """(loss, metrics, f32 gradients name -> tensor) of one batch: the
    masters' gradients by autograd (zeros for a tensor the loss does not
    reach)."""
    leaves = {n: t.detach().requires_grad_(True) for n, t in masters.items()}
    loss, metrics = model_mod.loss_fn(model, leaves, batch, z_coef=z_coef)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {n: torch.zeros_like(t) if g is None else g.float()
             for (n, t), g in zip(leaves.items(), gs)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(run: RunConfig, model: LM, *, max_steps: int = 10000,
                    microbatches: Optional[int] = None):
    """Returns (train_step, microbatch count, moment type) for `model`
    (built from `run.model`; its own weights are not read).

    train_step(masters, opt_state, batch) -> (masters, opt_state,
    metrics): `batch` is a dict of arrays (numpy or tensors) with the
    global batch on the leading axis, moved to the model's device. With
    one microbatch the metrics are `loss_fn`'s; with more, the batch
    splits into equal microbatches whose gradients sum in f32 (bf16 past
    300 B parameters) and are divided by their count, and the loss is
    their mean. Then "int8_ef" compression if the config asks, and AdamW
    (adding "grad_norm" and "lr")."""
    cfg, tcfg = run.model, run.train
    if model.cfg != cfg:
        raise ValueError(f"the model runs {model.cfg.name}, the run "
                         f"{cfg.name}")
    nmb = microbatches if microbatches is not None else \
        microbatches_for(cfg, run.shape.global_batch, run.shape.seq_len)
    mdtype = moments_dtype_for(cfg)
    lr_fn = opt.lr_schedule(tcfg, max_steps)

    def train_step(masters, opt_state, batch):
        batch = model_mod.to_device(batch, model.device)
        if nmb == 1:
            loss, metrics, grads = loss_and_grads(model, masters, batch,
                                                  tcfg.z_loss)
        else:
            acc_dtype = torch.bfloat16 if cfg.param_count() > 3e11 \
                else torch.float32
            grads = {n: torch.zeros(t.shape, dtype=acc_dtype,
                                    device=t.device)
                     for n, t in masters.items()}
            lsum = torch.zeros((), device=model.device)
            for j in range(nmb):
                mb = {n: t.reshape((nmb, t.shape[0] // nmb) + t.shape[1:])[j]
                      for n, t in batch.items()}
                loss_j, _, g = loss_and_grads(model, masters, mb,
                                              tcfg.z_loss)
                grads = {n: grads[n] + g[n].to(acc_dtype) for n in grads}
                lsum = lsum + loss_j
            grads = {n: g.float() / nmb for n, g in grads.items()}
            loss = lsum / nmb
            metrics = {"loss": loss}
        if tcfg.grad_compression == "int8_ef":
            grads = compress_decompress(grads)
        masters2, opt_state2, om = opt.adamw_update(
            tcfg, masters, grads, opt_state, lr_fn, mdtype)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
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
