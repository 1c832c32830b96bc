"""Sharding on torch.distributed (`repro_torch.dist.sharding`,
`launch.mesh`, the spec trees, `core.distributed`, the mesh train step,
MoE expert parallelism, `fault.reshard_restore`).

The pure logic is held to the reference's (`repro.dist.sharding`): the
counterparts of tests/test_sharding_specs.py, `logical_to_spec` against
the reference's over a grid of axes, shapes and mesh shapes (both read
only `mesh.shape`, so a stub stands in for meshes one CPU cannot make),
and the spec builders against the reference's for every config.

The multi-rank cases (tests/torch_mesh_cases.py) run in one spawned
4-rank gloo group (2 x 2 over ("data", "model")), joined within 120 s
and killed past it; each case is reported as its own test. The
reference's own mesh tests (tests/test_dist.py, tests/test_elastic.py)
compile 8-device meshes and fail at the seed, so the training cases
hold the port to its single-device results, which the other test files
hold to the reference's, at those tests' bounds. The tensor-parallel
serving cases (`torch_mesh_cases.TP_CASES`) are held to the reference's
single-device prefill and wave Engine, which this process runs before
the group starts (`tp_references`)."""
import json
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_cases
from repro.configs import get_config as j_get_config
from repro.core import distributed as jcd
from repro.dist import sharding as jsh
from repro.models import model as jmodel
from repro.serving.engine import Engine as JEngine
from repro.train import optimizer as jopt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import flat_names
from repro_torch.core import distributed as cd
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.fault import RestartManager
from repro_torch.dist.sharding import (axis_size, fsdp_spans_pods, get_mesh,
                                       logical_to_spec, set_fsdp_spans_pods,
                                       shard, sharding_for,
                                       spec_tree_to_shardings, use_mesh)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as tm
from repro_torch.train import optimizer as opt


class FakeMesh:
    """Shape-only stand-in (the reference test's), so the mapping logic
    is testable for meshes (4 x 2, multi-pod) one CPU cannot make."""

    def __init__(self, **shape):
        self._shape = dict(shape)

    @property
    def shape(self):
        return dict(self._shape)

    @property
    def axis_names(self):
        return tuple(self._shape)


@pytest.fixture(scope="module")
def mesh_1x1(tmp_path_factory):
    """A (1, 1) mesh over a one-rank gloo group of this process."""
    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        yield make_test_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ mesh context


def test_no_mesh_is_default_and_nesting_restores():
    assert get_mesh() is None
    m1, m2 = FakeMesh(data=2), FakeMesh(data=4)
    with use_mesh(m1):
        assert get_mesh() is m1
        with use_mesh(m2):
            assert get_mesh() is m2
        assert get_mesh() is m1
    assert get_mesh() is None


def test_shard_is_identity_without_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert shard(x, "batch", "tp") is x
    assert shard(x) is x


def test_shard_is_identity_on_single_device_mesh(mesh_1x1):
    x = torch.arange(8.0).reshape(2, 4)
    with use_mesh(mesh_1x1):
        assert shard(x, "batch", "tp") is x


# ------------------------------------------------------- logical -> spec


def test_axis_size_off_mesh_and_on_mesh():
    assert axis_size(None, "tp") == 1
    m = FakeMesh(data=4, model=2)
    assert axis_size(m, "tp") == 2
    assert axis_size(m, "fsdp") == 4
    assert axis_size(m, "batch") == 4          # no pod axis on this mesh
    assert axis_size(FakeMesh(pod=2, data=4, model=2), "batch") == 8
    assert axis_size(m, None) == 1


def test_logical_to_spec_basic_mapping():
    m = FakeMesh(data=4, model=2)
    assert logical_to_spec(m, ("batch", None, "tp")) == \
        ("data", None, "model")
    assert logical_to_spec(m, ("fsdp", "tp")) == ("data", "model")
    assert logical_to_spec(m, ("expert", "fsdp", None)) == \
        ("model", "data", None)


def test_logical_to_spec_fsdp_spans_pods_toggle():
    m = FakeMesh(pod=2, data=4, model=2)
    try:
        assert logical_to_spec(m, ("fsdp",)) == ("data",)
        set_fsdp_spans_pods(True)
        assert fsdp_spans_pods()
        assert logical_to_spec(m, ("fsdp",)) == (("pod", "data"),)
    finally:
        set_fsdp_spans_pods(False)
    assert logical_to_spec(m, ("batch",)) == (("pod", "data"),)


def test_logical_to_spec_prunes_indivisible_dims():
    m = FakeMesh(data=4, model=2)
    assert logical_to_spec(m, ("batch", "tp"), shape=(6, 5)) == (None, None)
    assert logical_to_spec(m, ("batch", "tp"), shape=(8, 4)) == \
        ("data", "model")
    mp = FakeMesh(pod=2, data=4, model=2)
    assert logical_to_spec(mp, ("batch",), shape=(2,)) == ("pod",)


def test_logical_to_spec_never_reuses_a_mesh_axis():
    m = FakeMesh(data=4, model=2)
    assert logical_to_spec(m, ("tp", "expert")) == ("model", None)


def test_unknown_logical_axis_raises():
    with pytest.raises(ValueError, match="unknown logical axis"):
        logical_to_spec(FakeMesh(data=2), ("bogus",))


AXES = [None, "batch", "fsdp", "tp", "expert", "seq_sp", "pod", "data",
        "model"]
MESHES = [dict(data=4, model=2), dict(data=2, model=2), dict(data=1, model=1),
          dict(pod=2, data=4, model=2), dict(pod=2, data=2, model=1),
          dict(data=8), dict(model=4)]


@pytest.mark.parametrize("spans", [False, True])
def test_logical_to_spec_matches_reference_grid(spans):
    """Every pair of logical axes (and single ones) over seven mesh
    shapes, with no shape and with shapes that divide, half divide and do
    not divide: the port's entries are the reference's PartitionSpec."""
    rng = np.random.default_rng(0)
    shapes = [None, (8, 8), (6, 4), (2, 16), (1, 3), (16, 2, 4)]
    try:
        set_fsdp_spans_pods(spans)
        jsh.set_fsdp_spans_pods(spans)
        for ms in MESHES:
            m = FakeMesh(**ms)
            for a in AXES:
                for b in AXES:
                    for shp in shapes:
                        axes = (a, b) if shp is None or len(shp) == 2 else \
                            (a, b, AXES[rng.integers(len(AXES))])
                        want = tuple(jsh.logical_to_spec(m, axes, shp))
                        assert logical_to_spec(m, axes, shp) == want, \
                            (ms, axes, shp)
                assert axis_size(m, a) == jsh.axis_size(m, a)
    finally:
        set_fsdp_spans_pods(False)
        jsh.set_fsdp_spans_pods(False)


# ------------------------------------------------- tree-level shardings


def test_spec_tree_to_shardings_round_trips_a_pytree(mesh_1x1):
    from repro_torch.convert import tree_leaves, tree_map
    from repro_torch.dist.sharding import distribute
    tree = {"params": {"w": torch.arange(32.0).reshape(4, 8),
                       "b": torch.ones(8, dtype=torch.bfloat16)},
            "step": torch.tensor(3, dtype=torch.int32)}
    specs = {"params": {"w": ("fsdp", "tp"), "b": ("tp",)}, "step": ()}
    sh = spec_tree_to_shardings(mesh_1x1, specs, tree)
    assert sh.keys() == tree.keys() and sh["params"].keys() == \
        tree["params"].keys()
    placed = tree_map(distribute, tree, sh)
    for a, b in zip(tree_leaves(tree), tree_leaves(placed)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b.full_tensor())


def test_spec_shorter_or_longer_than_rank_is_padded(mesh_1x1):
    x = torch.ones(2, 3, 4)
    s = sharding_for(mesh_1x1, "batch", shape=x.shape)
    assert s.spec == logical_to_spec(mesh_1x1, ("batch", None, None),
                                     shape=x.shape)
    assert len(s.placements) == 2
    s2 = sharding_for(mesh_1x1, "batch", None, "tp", None, None,
                      shape=(2, 3))
    assert len(s2.spec) <= 2


# ---------------------------------------------------------- spec builders


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_builders_match_reference(arch):
    """param_specs, cache_specs, batch_specs and opt_state_specs (f32 and
    int8 moments) of the reduced and full configs are the reference's,
    flattened to the port's names."""
    for size in ("reduced", "full"):
        cfg, jcfg = get_config(arch), j_get_config(arch)
        if size == "reduced":
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        jp = jmodel.param_specs(jcfg)
        assert tm.param_specs(cfg) == flat_names(jp), size
        jc = jmodel.cache_specs(jcfg)
        assert tm.cache_specs(cfg) == (jc if cfg.family == "rglru"
                                       else flat_names(jc)), size
        assert tm.batch_specs(cfg) == jmodel.batch_specs(jcfg)
        for moments in ("float32", "int8"):
            want = jopt.opt_state_specs(jp, moments)
            got = opt.opt_state_specs(tm.param_specs(cfg), moments)
            assert got["step"] == want["step"]
            for k in ("m", "v"):
                assert got[k] == flat_names(want[k]), (size, moments, k)


def test_reference_retrieval_oracles_agree():
    """The port's numpy oracle is the reference's."""
    rng = np.random.default_rng(3)
    NC, CAP, d = 8, 16, 12
    data = rng.normal(size=(NC, CAP, d)).astype(np.float32)
    lens = rng.integers(4, CAP + 1, NC).astype(np.int32)
    sid = rng.permutation(NC * CAP).reshape(NC, CAP).astype(np.int32)
    q = rng.normal(size=(5, d)).astype(np.float32)
    args = (q, data[:, 0], data, lens, sid)
    for got, want in zip(cd.reference_retrieval(*args, k=7, n_probe=3),
                         jcd.reference_retrieval(*args, k=7, n_probe=3)):
        assert np.array_equal(got, want)
    shapes = [s for s, _ in cd.retrieval_input_structs(B=4, NC=NC, CAP=CAP,
                                                       d=d)]
    assert shapes == [tuple(s.shape) for s in jcd.retrieval_input_structs(
        B=4, NC=NC, CAP=CAP, d=d)]


# ------------------------------------------------------- restart manager


def test_restart_manager_resumes_after_simulated_crash(tmp_path):
    state = {"w": torch.arange(4.0), "n": torch.tensor(7, dtype=torch.int32)}
    rm = RestartManager(str(tmp_path), interval=3, device="cpu")
    rm.on_step(1, state)                     # below interval: no save
    assert ckpt.latest_step(str(tmp_path)) is None
    rm.on_step(3, state)
    # the manager object is lost; a fresh process builds a new one
    rm2 = RestartManager(str(tmp_path), interval=3, device="cpu")
    restored, start = rm2.maybe_restore({k: torch.zeros_like(v)
                                         for k, v in state.items()})
    assert start == 4
    assert torch.equal(restored["w"], torch.arange(4.0))
    assert restored["n"].dtype == torch.int32


def test_restart_manager_async_save_commits_on_flush(tmp_path):
    rm = RestartManager(str(tmp_path), interval=2, async_save=True,
                        device="cpu")
    rm.on_step(2, {"w": torch.ones(3)})
    rm.flush()
    assert ckpt.latest_step(str(tmp_path)) == 2


# ------------------------------------------------------------ multi-rank


def tp_references(out):
    """For each tensor-parallel case: the reference's params (converted
    to the port's flat names), its single-device prefill logits and
    cache of the case's prompts, and its wave Engine's greedy tokens, in
    <out>/tp_<name>.npz."""
    for name, (arch, over, _, _) in torch_mesh_cases.TP_CASES.items():
        jcfg = j_get_config(arch).reduced(dtype="float32", **over)
        jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(
            torch_mesh_cases.TP_SEED))
        toks = torch_mesh_cases.tp_prompts(name)
        logits, cache = jmodel.prefill(jcfg, jparams,
                                       {"tokens": jnp.asarray(toks)})
        gen = JEngine(jcfg, jparams, max_len=torch_mesh_cases.TP_MAX_LEN
                      ).generate(list(toks),
                                 max_new=torch_mesh_cases.TP_MAX_NEW,
                                 continuous=False)
        arrays = {"p/" + n: np.asarray(v) for n, v in
                  flat_names(jax.tree.map(np.asarray, jparams)).items()}
        arrays.update({"c/" + n: np.asarray(v) for n, v in cache.items()})
        np.savez(f"{out}/tp_{name}.npz", logits=np.asarray(logits),
                 gen=np.array(json.dumps([r.tokens for r in gen])), **arrays)


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh"))
    tp_references(out)
    return torch_mesh_cases.spawn(out)


@pytest.mark.parametrize("case", list(torch_mesh_cases.CASES))
def test_mesh_case(mesh_results, case):
    """One case of the 4-rank group passed on every rank that ran it."""
    for rank in range(torch_mesh_cases.WORLD):
        got = mesh_results[rank].get(case)
        assert got is not None, f"rank {rank} never finished {case}"
        assert got == "ok", f"rank {rank}:\n{got}"
