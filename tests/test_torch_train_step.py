"""The port's optimizer, gradient compression, train step and LM data
pipeline against the reference's (`repro.train`, `repro.data`) on the
same inputs: the int8 row code, AdamW with f32 and int8 moments, the
learning-rate schedule, both compression functions, `make_train_step`
at 1 and 4 microbatches, `LMBatcher`, `lm_token_stream` and the
prefetcher's straggler path; then a port-only memorising run."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import RunConfig as JRunConfig
from repro.config import ShapeConfig as JShapeConfig
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.data.tokenizer import HashTokenizer as JHashTokenizer
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.convert import flat_names
from repro_torch.data import pipeline, synthetic
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import model as tm
from repro_torch.train import grad_compress as gc
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer
from torch_parity import assert_close, j_loss_and_grads, one_thread, pair

pytestmark = pytest.mark.usefixtures(one_thread.__name__)

SHAPES = {"w": (6, 40), "stack": (2, 5, 24), "norm": (24,)}


def _tensors(rng, scale=1.0):
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def test_quantize_rows_matches_reference():
    """q bit-equal (round half to even: 0.5 -> 0, 1.5 and 2.5 -> 2), s
    and the decoded rows equal, a zero row included."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 300)).astype(np.float32)
    x[3] = 0.0
    x[5, :5] = [127.0, 0.5, 1.5, 2.5, -2.5]
    x[5, 5:] = 0.0
    qt, jqt = opt.quantize_rows(torch.tensor(x)), jopt.quantize_rows(
        jnp.asarray(x))
    assert qt["q"].dtype == torch.int8 and qt["s"].shape == (8, 1)
    assert np.array_equal(qt["q"].numpy(), np.asarray(jqt["q"]))
    assert np.array_equal(qt["s"].numpy(), np.asarray(jqt["s"]))
    assert qt["q"][5, :5].tolist() == [127, 0, 2, 2, -2]
    assert np.array_equal(opt.dequantize_rows(qt).numpy(),
                          np.asarray(jopt.dequantize_rows(jqt)))


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_adamw_matches_reference(moments):
    """Three steps on the same parameters and gradients (clipped: the
    global norm is above grad_clip), 1e-6 relative: parameters, moments
    (int8 m's codes exactly), step, grad_norm and lr."""
    rng = np.random.default_rng(1)
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2)
    jtcfg = JTrainConfig(learning_rate=1e-2, warmup_steps=2)
    p0 = _tensors(rng)
    params, jparams = ({n: torch.tensor(v) for n, v in p0.items()},
                       {n: jnp.asarray(v) for n, v in p0.items()})
    state, jstate = (opt.init_opt_state(params, moments),
                     jopt.init_opt_state(jparams, moments))
    lr_fn, jlr_fn = opt.lr_schedule(tcfg, 20), jopt.lr_schedule(jtcfg, 20)
    for _ in range(3):
        g = _tensors(rng, 3.0)
        params, state, met = opt.adamw_update(
            tcfg, params, {n: torch.tensor(v) for n, v in g.items()}, state,
            lr_fn, moments)
        jparams, jstate, jmet = jopt.adamw_update(
            jtcfg, jparams, {n: jnp.asarray(v) for n, v in g.items()},
            jstate, jlr_fn, moments)
        for k in ("grad_norm", "lr"):
            assert_close(met[k].item(), float(jmet[k]), k, rtol=1e-6)
        assert float(jmet["grad_norm"]) > tcfg.grad_clip
    assert int(state["step"]) == int(jstate["step"]) == 3
    for n in SHAPES:
        assert_close(params[n].numpy(), jparams[n], n, rtol=1e-6)
        m, jm = state["m"][n], jstate["m"][n]
        if moments == "int8":
            assert np.array_equal(m["q"].numpy(), np.asarray(jm["q"])), n
            m, jm = m["s"], jm["s"]
            assert state["v"][n].dtype == torch.bfloat16
        assert_close(m.numpy(), jm, f"m {n}", rtol=1e-6)
        assert_close(state["v"][n].float().numpy(),
                     np.asarray(jstate["v"][n], np.float32), f"v {n}",
                     rtol=1e-6)


def test_lr_schedule_matches_reference():
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10)
    lr = opt.lr_schedule(tcfg, 100)
    jlr = jopt.lr_schedule(JTrainConfig(learning_rate=1e-3,
                                        warmup_steps=10), 100)
    for step in (0, 5, 10, 55, 100, 130):
        assert_close(lr(step).item(), float(jlr(step)), f"lr({step})",
                     rtol=1e-6)
    assert lr(0).item() == 0.0
    assert lr(100).item() < lr(50).item() < lr(10).item()


def test_grad_compression_matches_reference():
    """compress_decompress, and compress_with_feedback over three steps
    (the residual carried), against the reference's; a 0-d gradient
    passes as it is."""
    rng = np.random.default_rng(2)
    g = _tensors(rng)
    t = {n: torch.tensor(v) for n, v in g.items()}
    t["scalar"], g["scalar"] = torch.tensor(0.7), np.float32(0.7)
    j = {n: jnp.asarray(v) for n, v in g.items()}
    out, jout = gc.compress_decompress(t), jgc.compress_decompress(j)
    for n in g:
        assert np.array_equal(out[n].numpy(), np.asarray(jout[n])), n
    ef, jef = gc.init_ef_state(t), jgc.init_ef_state(j)
    for _ in range(3):
        sent, ef = gc.compress_with_feedback(t, ef)
        jsent, jef = jgc.compress_with_feedback(j, jef)
        for n in g:
            assert_close(sent[n].numpy(), jsent[n], f"sent {n}", rtol=1e-6)
            assert_close(ef[n].numpy() if n != "scalar" else 0.0,
                         jef[n] if n != "scalar" else 0.0, f"ef {n}",
                         rtol=1e-6)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_plan_matches_reference(arch):
    """param_count, moments_dtype_for and microbatches_for (one replica)
    equal the reference's."""
    for size in ("full", "reduced"):
        cfg, jcfg = get_config(arch), j_get_config(arch)
        if size == "reduced":
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        assert cfg.param_count() == jcfg.param_count(), size
        assert trainer.moments_dtype_for(cfg) == \
            jtrainer.moments_dtype_for(jcfg)
        for gb, seq in ((8, 512), (256, 4096), (6, 4096), (1, 524288)):
            assert trainer.microbatches_for(cfg, gb, seq) == \
                jtrainer.microbatches_for(jcfg, gb, None, seq), (size, gb)


def test_train_step_microbatches_match_reference():
    """make_train_step on reduced h2o-danube (f32) at B 8, S 16, as the
    reference's test_microbatch_accumulation_matches_full_batch: with 1
    and with 4 microbatches each step equals the reference's at the same
    count: loss and grad_norm at 1e-6; each parameter within 1e-6 of the
    tensor's largest plus what the gradients' 1e-5 agreement allows
    through Adam's first step (u = g / (|g| + eps) moves by at most
    min(2, 2 delta / (|g| + eps)) for a gradient delta off, delta 1e-5 of
    the tensor's largest gradient), times lr. Then 1 and 4 agree within
    the reference's 5e-3."""
    jcfg, jparams, cfg, lm = pair("h2o_danube_1_8b")
    shape, jshape = (ShapeConfig("t", 16, 8, "train"),
                     JShapeConfig("t", 16, 8, "train"))
    run = RunConfig(model=cfg, shape=shape,
                    train=TrainConfig(grad_clip=0.0, warmup_steps=0))
    jrun = JRunConfig(model=jcfg, shape=jshape,
                      train=JTrainConfig(grad_clip=0.0, warmup_steps=0))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(4, 100, (8, 16)).astype(np.int32),
             "labels": rng.integers(4, 100, (8, 16)).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jg = j_loss_and_grads(jcfg, jparams, jbatch)
    jg = {k: np.abs(np.asarray(v)) for k, v in flat_names(jg).items()}
    masters = tm.masters(lm)
    state = opt.init_opt_state(masters)
    out = {}
    for nmb in (1, 4):
        step, n, mdtype = trainer.make_train_step(run, lm, microbatches=nmb)
        assert (n, mdtype) == (nmb, "float32")
        jstep, _, _ = jtrainer.make_train_step(jrun, microbatches=nmb,
                                               seq_sp=False)
        jp, _, jm = jax.jit(jstep)(jparams, jopt.init_opt_state(jparams),
                                   jbatch)
        p, st, m = step(masters, state, batch)
        assert int(st["step"]) == 1
        for k in ("loss", "grad_norm", "lr"):
            assert_close(m[k].item(), float(jm[k]), f"{nmb} {k}", rtol=1e-6)
        lr = float(jm["lr"])
        for name, want in flat_names(jp).items():
            want, got = np.asarray(want), p[name].numpy()
            g = jg[name]
            tol = 1e-6 * np.abs(want).max() + lr * np.minimum(
                2.0, 2e-5 * g.max() / (g + run.train.eps))
            bad = np.abs(got - want) > tol
            assert not bad.any(), (nmb, name, np.abs(got - want)[bad].max())
        out[nmb] = p
    assert max(float((out[1][n] - out[4][n]).abs().max())
               for n in out[1]) < 5e-3
    # the int8 round trip of the gradients before AdamW
    run8 = dataclasses.replace(run, train=dataclasses.replace(
        run.train, grad_compression="int8_ef"))
    step8, _, _ = trainer.make_train_step(run8, lm, microbatches=1)
    p8, _, _ = step8(masters, state, batch)
    _, _, grads = trainer.loss_and_grads(
        lm, masters, tm.to_device(batch, "cpu"), 0.0)
    want8, _, _ = opt.adamw_update(run.train, masters,
                                   gc.compress_decompress(grads), state,
                                   opt.lr_schedule(run.train, 10000))
    for n in masters:
        assert torch.equal(p8[n], want8[n]), n


def test_memorising_run_lowers_loss():
    """Port only: reduced qwen2.5 memorises one batch in 10 steps of
    make_train_step (the reference's TrainConfig of
    test_training_reduces_loss: lr 1e-3, 5 warmup steps); the loss falls
    by more than 0.5 and every step's metrics are finite."""
    cfg = get_reduced("qwen25_0_5b")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 8, "train"),
                    train=TrainConfig(learning_rate=1e-3, warmup_steps=5))
    model, masters, state = trainer.make_states(run, seed=0, device="cpu")
    step, nmb, _ = trainer.make_train_step(run, model, max_steps=60)
    assert nmb == 1
    data = np.random.default_rng(0).integers(4, cfg.vocab_size, (8, 33))
    batch = {"tokens": data[:, :-1].astype(np.int32),
             "labels": data[:, 1:].astype(np.int32)}
    before = {n: t.clone() for n, t in masters.items()}
    losses = []
    for _ in range(10):
        masters, state, met = step(masters, state, batch)
        assert all(np.isfinite(v.item()) for v in met.values())
        losses.append(met["loss"].item())
    assert losses[-1] < losses[0] - 0.5, losses
    # the step is functional: the first masters are as they were
    for n, t in tm.masters(model).items():
        assert torch.equal(t, before[n]), n


def test_lm_stream_and_batches_match_reference():
    """lm_token_stream and LMBatcher.batch_at equal the reference's byte
    for byte, over two host shards too."""
    tok, jtok = HashTokenizer(vocab_size=512), JHashTokenizer(vocab_size=512)
    for n in (3000, 9000):
        s, js = (synthetic.lm_token_stream(tok, n, seed=2),
                 jsyn.lm_token_stream(jtok, n, seed=2))
        assert s.dtype == js.dtype and s.tobytes() == js.tobytes()
    for shard in ((0, 1), (0, 2), (1, 2)):
        b = pipeline.LMBatcher(s, 6, 32, pipeline.ShardSpec(*shard))
        jb = jpipe.LMBatcher(js, 6, 32, jpipe.ShardSpec(*shard))
        for step in (0, 1, 7):
            got, want = b.batch_at(step), jb.batch_at(step)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes(), (shard, step)


def test_prefetcher_straggler_path():
    """A producer that is late: `next` recomputes the expected step's
    batch itself (steps 0 and 1, in order); once the producer runs, its
    batches follow; `stop` ends the thread."""
    s = synthetic.lm_token_stream(HashTokenizer(vocab_size=512), 3000)
    b = pipeline.LMBatcher(s, 4, 16)
    gate = threading.Event()
    main = threading.current_thread()

    def batch_fn(step):
        if threading.current_thread() is not main:
            assert gate.wait(10.0)
        return b.batch_at(step)
    pf = pipeline.Prefetcher(batch_fn, depth=2, timeout_s=0.05)
    try:
        for step in (0, 1):
            got = pf.next()
            assert np.array_equal(got["tokens"], b.batch_at(step)["tokens"])
        gate.set()
        pf.timeout_s = 10.0
        got = pf.next()
        # the producer started at step 0: its first batch is step 0's
        assert np.array_equal(got["tokens"], b.batch_at(0)["tokens"])
    finally:
        gate.set()
        assert pf.stop()
