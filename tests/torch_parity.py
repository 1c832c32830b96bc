"""Shared by the model-zoo parity tests of the port (tests/test_torch_
mamba2.py, _rglru.py, _encdec.py, _vision.py, _zoo.py) and the training
ones (_train_loss.py, _train_families.py, _train_step.py): a reference
model and the port's on the same converted params, and the tolerance
they are held to."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.convert import flat_names, params_from_reference
from repro_torch.models import model as tmodel
from repro_torch.models.model import build_model

# f32 parity: max |port - reference| over max |reference|, per tensor.
# The two sum in other orders (einsum contractions, the doubling scan
# against lax.associative_scan), so they agree to rounding, not bits
RTOL = 1e-5


def pair(arch, seed=0, dtype="float32", **over):
    """(reference config, its params, port config, port model) of the
    reduced `arch` with `over`, on the CPU."""
    jcfg = j_get_config(arch).reduced(dtype=dtype, **over)
    cfg = get_config(arch).reduced(dtype=dtype, **over)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, build_model(cfg, device="cpu", params=params)


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def assert_close(got, want, what, rtol=RTOL):
    err = rel_err(got, want)
    assert err <= rtol, f"{what}: relative error {err:.3g} > {rtol}"


def grow_reference(cache, names, target):
    """The reference cache with `names` zero-padded to `target` positions
    along axis 2 (as its Engine's `_grow_cache` does)."""
    out = dict(cache)
    for n in names:
        x = out[n]
        out[n] = jnp.concatenate([x, jnp.zeros(
            x.shape[:2] + (target - x.shape[2],) + x.shape[3:], x.dtype)], 2)
    return out


def prompts(seed, lens, vocab=500):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, vocab, n).astype(np.int32) for n in lens]


# the reference's prefill and decode step, compiled once per config and
# shape (eager calls retrace their layer scans on every call)
j_prefill = jax.jit(jmodel.prefill, static_argnums=0)
j_decode = jax.jit(jmodel.decode_step, static_argnums=0)


# the reference's loss and its gradients in the params, compiled once per
# config (an eager value_and_grad retraces every layer scan)
j_loss_and_grads = jax.jit(
    jax.value_and_grad(jmodel.loss_fn, argnums=1, has_aux=True),
    static_argnums=0, static_argnames=("seq_sp", "aux_coef", "z_coef"))


def loss_and_grads_pair(jcfg, jparams, lm, batch, **kw):
    """The reference's and the port's (loss, metrics, grads by the port's
    flat names) of one numpy batch, the port's from its f32 masters (the
    reference's params, converted)."""
    (jl, jmet), jg = j_loss_and_grads(
        jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()}, **kw)
    ref = (float(jl), {k: float(v) for k, v in jmet.items()},
           {k: np.asarray(v) for k, v in flat_names(jg).items()})
    leaves = {n: t.requires_grad_(True) for n, t in tmodel.masters(lm).items()}
    loss, met = tmodel.loss_fn(lm, leaves, tmodel.to_device(batch, "cpu"),
                               **kw)
    loss.backward()
    port = (loss.item(), {k: v.item() for k, v in met.items()},
            {n: t.grad.numpy() for n, t in leaves.items()})
    return ref, port


def assert_loss_and_grads(ref, port, what):
    """Loss, metrics and every gradient at RTOL (per tensor)."""
    (jl, jmet, jg), (pl, pmet, pg) = ref, port
    assert set(pmet) == set(jmet), (what, sorted(pmet), sorted(jmet))
    for k in jmet:
        assert_close(pmet[k], jmet[k], f"{what} {k}")
    assert_close(pl, jl, f"{what} loss")
    assert set(pg) == set(jg), (what, set(pg) ^ set(jg))
    for n in jg:
        assert_close(pg[n], jg[n], f"{what} grad {n}")


@pytest.fixture(scope="module", autouse=False)
def one_thread():
    """torch on one intra-op thread for a module's tests (restored after
    it): the reduced models' ops are small, and with the workers of a
    parallel run sharing the cores, a pool of threads a process waits on
    itself far longer than one thread computes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
