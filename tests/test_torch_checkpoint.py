"""Checkpoints, restart and the train launcher of the port
(`repro_torch.dist.checkpoint`, `dist.fault`, `launch.train`): the
counterparts of tests/test_checkpoint.py (the round trip, partial writes,
the async save and its writer's error, `RestartManager`, the kill -9
resume through the real launcher, the watchdog), then the on-disk format
across packages: the reference's checkpoints of a reduced qwen2.5
`(params, opt_state)`, with f32 and with int8 moments (bf16 v), restore
in the port bit for bit and the reference's `restore_host` reads the
port's; and the port's launcher resumes a reference checkpoint and
continues the reference's own run."""
import functools
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.dist import checkpoint as jckpt
from repro.launch import train as jlaunch
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.convert import (flat_names, nest_names,
                                 params_from_reference, state_from_tree,
                                 state_tree, tree_leaves)
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.fault import RestartManager, StepWatchdog
from repro_torch.launch import train as launch
from repro_torch.models import model as tm
from repro_torch.train import optimizer as opt
from torch_parity import one_thread

pytestmark = pytest.mark.usefixtures(one_thread.__name__)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def bits(x) -> np.ndarray:
    """The raw bytes of a tensor or an array (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.contiguous().numpy().reshape(-1).view(np.uint8)
    x = np.asarray(x)
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def assert_same_bits(got, want, what):
    assert got.shape == tuple(np.shape(want)), (what, got.shape)
    assert np.array_equal(bits(got), bits(want)), what


# ------------------------------------- counterparts of test_checkpoint.py


def test_save_restore_roundtrip(tmp_path):
    t = tree()
    ckpt.save(str(tmp_path), 3, t)
    like = {"params": {"w": torch.zeros(3, 4),
                       "b": torch.zeros(4, dtype=torch.bfloat16)},
            "step": torch.tensor(0, dtype=torch.int32)}
    r = ckpt.restore(str(tmp_path), 3, like, device="cpu")
    for a, b in zip(tree_leaves(t), tree_leaves(r)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_host(str(tmp_path), 3, {"params": {
            "w": torch.zeros(4, 3), "b": torch.zeros(4)}, "step": 0})


def test_latest_step_ignores_partial_writes(tmp_path):
    ckpt.save(str(tmp_path), 1, tree())
    # a crashed write: a tmp dir never renamed, a dir without manifest
    os.makedirs(tmp_path / "step_00000009.tmp" / "arrays")
    os.makedirs(tmp_path / "step_00000005")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.available_steps(str(tmp_path)) == [1]


def test_async_save(tmp_path):
    """The thread comes back started; the snapshot was taken before save
    returned (an in-place write after it does not reach the disk); a
    writer's failure is raised again by join()."""
    t = tree()
    th = ckpt.save(str(tmp_path), 2, t, blocking=False)
    t["params"]["w"].add_(100.0)
    th.join()
    assert ckpt.latest_step(str(tmp_path)) == 2
    r = ckpt.restore_host(str(tmp_path), 2, t)
    assert torch.equal(r["params"]["w"], torch.arange(12.0).reshape(3, 4))
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    th = ckpt.save(str(blocker), 4, tree(), blocking=False)
    with pytest.raises(OSError):
        th.join()


def test_restart_manager_resume(tmp_path):
    rm = RestartManager(str(tmp_path), interval=2, async_save=False,
                        device="cpu")
    state = tree()
    s, start = rm.maybe_restore(state)
    assert start == 0 and s is state
    rm.on_step(2, state)
    state2 = {"params": {k: v + 1 for k, v in state["params"].items()},
              "step": state["step"]}
    rm.on_step(4, state2)
    zeros = {"params": {k: torch.zeros_like(v)
                        for k, v in state["params"].items()},
             "step": torch.zeros_like(state["step"])}
    restored, start = rm.maybe_restore(zeros)
    assert start == 5
    assert torch.equal(restored["params"]["w"], state2["params"]["w"])
    assert restored["params"]["b"].dtype == torch.bfloat16


def test_kill9_resume_end_to_end(tmp_path, monkeypatch, capsys):
    """The real launcher killed mid-run (`python -m
    repro_torch.launch.train`, os._exit at step 8) resumes from its
    step-5 checkpoint and finishes: the reference test's settings on the
    CPU. The resumed run is the launcher's `main` in this process (the
    same entry point, without a second interpreter's start-up)."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    args = ["--device", "cpu", "--arch", "gte_small", "--steps", "14",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
            "--ckpt-interval", "5"]
    p1 = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                        + args + ["--kill-at", "8"], env=env,
                        capture_output=True, text=True, timeout=300)
    assert p1.returncode == 42, p1.stdout + p1.stderr
    assert "simulated crash at step 8" in p1.stdout
    assert ckpt.latest_step(str(tmp_path)) == 5
    monkeypatch.setattr(sys, "argv", ["train"] + args)
    launch.main()
    out = capsys.readouterr().out
    assert "resuming at step 6" in out
    assert "step 13" in out
    assert ckpt.latest_step(str(tmp_path)) == 13


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(factor=3.0, warmup=2)
    for _ in range(3):
        wd.start()
        time.sleep(0.01)
        assert not wd.stop(0).is_straggler
    wd.start()
    time.sleep(0.2)
    rep = wd.stop(3)
    assert rep.is_straggler and rep.step == 3


# ------------------------------------------------ across the two packages


@functools.lru_cache(maxsize=None)
def reference_state(moments):
    """A reduced qwen2.5's reference (params, opt_state) tree with random
    values (the reference's structure and dtypes: int8 moments by its own
    `quantize_rows`, v in bf16) at step 5 (JAX arrays are immutable: the
    tests share one)."""
    jcfg = j_get_config("qwen25_0_5b").reduced()
    rng = np.random.default_rng(1)

    def rand(s, scale=1.0):
        return jnp.asarray((rng.standard_normal(s.shape) * scale).astype(
            np.float32))
    shapes = jmodel.param_shapes(jcfg)
    params = jax.tree.map(lambda s: rand(s, 0.02), shapes)
    m = jax.tree.map(rand, shapes)
    v = jax.tree.map(lambda s: jnp.abs(rand(s)), shapes)
    if moments == "int8":
        # one compile for the tree (eager ops compile a shape at a time)
        m, v = jax.jit(lambda m, v: (
            jax.tree.map(jopt.quantize_rows, m),
            jax.tree.map(lambda x: x.astype(jnp.bfloat16), v)))(m, v)
    return params, {"m": m, "v": v, "step": jnp.int32(5)}


def port_like(moments):
    """The port's state of the same model (its own random draw) as the
    restore's `like`."""
    cfg = get_config("qwen25_0_5b").reduced()
    masters = tm.masters(tm.build_model(cfg, device="cpu"))
    return masters, opt.init_opt_state(masters, moments)


def test_state_tree_leaf_order_is_the_reference_order():
    """The nesting of every family's flat names and the state's leaf
    order equal the reference's `jax.tree.leaves` of (params,
    opt_state)."""
    from repro_torch.configs import ARCH_IDS
    for arch in ARCH_IDS:
        jshapes = jmodel.param_shapes(j_get_config(arch).reduced())
        shapes = tm.param_shapes(get_config(arch).reduced())
        assert nest_names(shapes) == jax.tree.map(
            lambda s: tuple(s.shape), jshapes), arch
    params, jopt_state = reference_state("int8")
    masters, state = port_like("int8")
    got = [tuple(t.shape) for t in tree_leaves(state_tree(masters, state))]
    assert got == [tuple(x.shape) for x in
                   jax.tree.leaves((params, jopt_state))]


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_reference_checkpoint_restores_bit_equal(tmp_path, moments):
    params, jstate = reference_state(moments)
    jckpt.save(str(tmp_path), 5, (params, jstate))
    tree = ckpt.restore(str(tmp_path), 5, state_tree(*port_like(moments)),
                        device="cpu")
    masters, state = state_from_tree(tree)
    want = params_from_reference(jax.tree.map(np.asarray, params), "cpu")
    assert masters.keys() == want.keys()
    for n in want:
        assert_same_bits(masters[n], want[n], n)
    assert int(state["step"]) == 5 and state["step"].dtype == torch.int32
    jm, jv = flat_names(jstate["m"]), flat_names(jstate["v"])
    for n in want:
        if moments == "int8":
            assert_same_bits(state["m"][n]["q"], jm[n]["q"], f"m.q {n}")
            assert_same_bits(state["m"][n]["s"], jm[n]["s"], f"m.s {n}")
            assert state["v"][n].dtype == torch.bfloat16
        else:
            assert_same_bits(state["m"][n], jm[n], f"m {n}")
        assert_same_bits(state["v"][n], jv[n], f"v {n}")


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_reference_restore_host_reads_port_checkpoint(tmp_path, moments):
    masters, state = port_like(moments)
    # moments of their own, not zeros
    g = torch.Generator().manual_seed(3)
    for n, p in masters.items():
        m = torch.randn(p.shape, generator=g)
        v = torch.randn(p.shape, generator=g).abs()
        state["m"][n] = opt.quantize_rows(m) if moments == "int8" else m
        state["v"][n] = v.to(torch.bfloat16) if moments == "int8" else v
    ckpt.save(str(tmp_path), 9, state_tree(masters, state))
    like = reference_state(moments)
    (jp, jstate) = jckpt.restore_host(str(tmp_path), 9, like)
    for n, a in flat_names(jp).items():
        assert_same_bits(masters[n], a, n)
    for n, a in flat_names(jstate["v"]).items():
        assert_same_bits(state["v"][n], a, f"v {n}")
        assert a.dtype.name == ("bfloat16" if moments == "int8"
                                else "float32")
    for n, a in flat_names(jstate["m"]).items():
        if moments == "int8":
            assert_same_bits(state["m"][n]["q"], a["q"], f"m.q {n}")
            assert_same_bits(state["m"][n]["s"], a["s"], f"m.s {n}")
        else:
            assert_same_bits(state["m"][n], a, f"m {n}")
    assert int(jstate["step"]) == 0


def test_launcher_resumes_reference_checkpoint(tmp_path, monkeypatch):
    """The reference's `launch.train.run` trains reduced qwen2.5 (f32) 7
    steps unbroken, checkpointing at step 3; the port's launcher resumes
    from that checkpoint alone at step 4 and its losses of steps 4-6 are
    the reference's, at the 1e-6 the f32 step tests hold a step's loss
    to."""
    monkeypatch.setattr(jlaunch, "get_reduced", lambda a: j_get_config(
        a).reduced(dtype="float32"))
    monkeypatch.setattr(launch, "get_reduced", lambda a: get_config(
        a).reduced(dtype="float32"))
    kw = dict(steps=7, batch=2, seq=32, ckpt_interval=3, log_every=100)
    jl = jlaunch.run("qwen25_0_5b", ckpt_dir=str(tmp_path / "ref"), **kw)
    os.makedirs(tmp_path / "port")
    shutil.copytree(tmp_path / "ref" / "step_00000003",
                    tmp_path / "port" / "step_00000003")
    pl = launch.run("qwen25_0_5b", ckpt_dir=str(tmp_path / "port"),
                    device="cpu", **kw)
    assert len(pl) == 3
    for step, (got, want) in enumerate(zip(pl, jl[4:]), start=4):
        assert abs(got - want) <= 1e-6 * abs(want), (step, got, want)
