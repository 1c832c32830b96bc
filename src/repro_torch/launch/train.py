"""Training driver (the port of `repro.launch.train`; the same flags and
output lines, plus `--device`): real training of a reduced (default) or
full-size config on one device.

  python -m repro_torch.launch.train --arch gte_small --steps 200 \
      --batch 8 --seq 128 --ckpt-dir /tmp/run1

  # on the CPU (the plain versions)
  python -m repro_torch.launch.train --device cpu --arch gte_small \
      --steps 14 --batch 2 --seq 32

Exercises the data pipeline with its prefetcher, microbatch accumulation,
AdamW (int8 moments past 60 B parameters), remat, checkpoint/restart
(`RestartManager` survives kill -9 between steps; the checkpoints are
the reference's format, `convert.state_tree`, so a run resumes from the
reference's) and the step watchdog. A resumed run takes the batches of
its steps (`LMBatcher.batch_at(step)`), as the unbroken run does; the
reference's launcher starts its prefetcher at batch 0 on a resume.
`--kill-at N` ends the process with code 42 after step N (the
fault-injection hook of the tests).
"""
from __future__ import annotations

import argparse
import os

from repro_torch import resolve_device
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import state_from_tree, state_tree
from repro_torch.data.pipeline import LMBatcher, Prefetcher
from repro_torch.data.synthetic import lm_token_stream
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.dist.fault import RestartManager, StepWatchdog
from repro_torch.models import model
from repro_torch.train import trainer


def run(arch: str, *, reduced: bool = True, steps: int = 100, batch: int = 8,
        seq: int = 128, ckpt_dir: str = "", ckpt_interval: int = 50,
        lr: float = 3e-4, microbatches: int = 1, log_every: int = 10,
        seed: int = 0, kill_at: int = -1, device="cuda"):
    """Train `steps` steps (resuming from `ckpt_dir`'s latest checkpoint
    when there is one) and return the losses of the steps run."""
    dev = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if cfg.family == "encdec":
        raise SystemExit("use examples/train_embedder.py families for LM "
                         "training; encdec has its own batch layout")
    shape = ShapeConfig("custom", seq, batch, "train")
    run_cfg = RunConfig(model=cfg, shape=shape,
                        train=TrainConfig(learning_rate=lr,
                                          warmup_steps=min(20, steps // 5)))
    tok = HashTokenizer(cfg.vocab_size)
    stream = lm_token_stream(tok, n_tokens=max(200_000, batch * seq * 4),
                             seed=seed)
    batcher = LMBatcher(stream, batch, seq, seed=seed)

    lm, params, opt_state = trainer.make_states(run_cfg, seed, dev)
    train_step, nmb, mdtype = trainer.make_train_step(
        run_cfg, lm, max_steps=steps, microbatches=microbatches)
    n_params = model.count_params(params)
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"microbatches={nmb}, moments={mdtype}")

    start = 0
    rm = None
    if ckpt_dir:
        rm = RestartManager(ckpt_dir, interval=ckpt_interval, device=dev)
        tree, start = rm.maybe_restore(state_tree(params, opt_state))
        params, opt_state = state_from_tree(tree)
        if start:
            print(f"[train] restored checkpoint, resuming at step {start}")
    # batches are a function of their step: a resumed run goes on with
    # the batches the unbroken run would have taken
    prefetch = Prefetcher(batcher.batch_at, start=start)
    wd = StepWatchdog()
    losses = []
    for step in range(start, steps):
        b = prefetch.next()
        wd.start()
        params, opt_state, metrics = train_step(params, opt_state, b)
        loss = float(metrics["loss"])
        rep = wd.stop(step)
        losses.append(loss)
        if rep.is_straggler:
            print(f"[watchdog] step {step} straggler: {rep.step_time_s:.2f}s"
                  f" vs mean {rep.mean_s:.2f}s")
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step} loss={loss:.4f} "
                  f"gnorm={float(metrics.get('grad_norm', 0)):.2f} "
                  f"({rep.step_time_s:.2f}s)")
        if rm:
            rm.on_step(step, state_tree(params, opt_state))
        if kill_at == step:  # fault-injection hook for tests
            print(f"[train] simulated crash at step {step}", flush=True)
            os._exit(42)
    prefetch.stop()
    if rm:
        rm.finalize(steps - 1, state_tree(params, opt_state))
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen25_0_5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--kill-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    losses = run(args.arch, reduced=args.reduced, steps=args.steps,
                 batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                 ckpt_interval=args.ckpt_interval, lr=args.lr,
                 microbatches=args.microbatches, kill_at=args.kill_at,
                 seed=args.seed, device=args.device)
    print(f"[train] final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()
