"""The port's training loss and its gradients against the reference's
`jax.value_and_grad(repro.models.model.loss_fn)` on the same converted
f32 params and numpy batch: the dense decoder (with and without the
z-loss), qwen2-vl's patches (their labels ignored) and the MoE family,
also with a capacity factor that drops slots. Every gradient is matched
by the port's flat parameter names at `torch_parity.RTOL`. Then remat,
and the kernel wrappers that refuse autograd inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as tm
from repro_torch.models import moe
from repro_torch.models.dense import bound
from torch_parity import (assert_close, assert_loss_and_grads,
                          loss_and_grads_pair, one_thread, pair)

pytestmark = pytest.mark.usefixtures(one_thread.__name__)


@pytest.mark.parametrize("arch,S,z_coef", [
    ("qwen25_0_5b", 32, 0.0),
    ("qwen25_0_5b", 32, 1e-4),
    ("qwen2_vl_2b", 264, 0.0),
    ("granite_moe_1b_a400m", 32, 0.0)])
def test_loss_and_grads_match_reference(arch, S, z_coef):
    jcfg, jparams, cfg, lm = pair(arch)
    batch = tm.make_sample_batch(cfg, 2, S, seed=3)
    ref_, port = loss_and_grads_pair(jcfg, jparams, lm, batch, z_coef=z_coef)
    assert_loss_and_grads(ref_, port, arch)
    if cfg.modality == "vision":
        # only the text positions count
        assert port[1]["ntokens"] == 2 * (S - 256)
    if z_coef:
        assert port[1]["z_loss"] > 0
    if cfg.family == "moe":
        assert port[1]["moe_aux"] > 0


def _with_capacity(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def reference_kept(x, router, cfg):
    """The (token, expert) slots that the reference's `_local_moe` keeps
    on one shard: its routing and slot lines (models/moe.py:115-129)."""
    m = cfg.moe
    T, k, E = x.shape[0], m.top_k, m.num_experts
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, topi = jax.lax.top_k(probs, k)
    C = max(4, int(T * k * m.capacity_factor) // E)
    eids = topi.reshape(-1)
    order = jnp.argsort(eids)
    sorted_ids = eids[order]
    counts = jnp.zeros(E, jnp.int32).at[eids].add(1)
    starts = jnp.cumsum(counts) - counts
    keep = (jnp.arange(T * k) - starts[sorted_ids]) < C
    return {(int(o) // k, int(e)) for o, e, kp in
            zip(np.asarray(order), np.asarray(sorted_ids), np.asarray(keep))
            if kp}


def test_moe_capacity_drops_match_reference():
    """capacity_factor 0.5 (C = 16 slots an expert for 128): the FFN's
    output, its aux loss and its kept slots equal the reference's
    `_local_moe`, slots are dropped, and the whole loss and its gradients
    agree."""
    jcfg, jparams, cfg, lm = pair("granite_moe_1b_a400m")
    jcfg, cfg = _with_capacity(jcfg, 0.5), _with_capacity(cfg, 0.5)
    lm = tm.build_model(cfg, device="cpu", params=dict(lm.named_parameters()))
    x = np.random.default_rng(4).standard_normal((64, cfg.d_model)).astype(
        np.float32)
    lp = {n: np.asarray(jparams["layers"][n][0])
          for n in ("router", "we1", "we2", "we3")}
    jy, jaux = jmoe._local_moe(jcfg, jnp.asarray(x), *(
        jnp.asarray(lp[n]) for n in ("router", "we1", "we2", "we3")),
        0, jcfg.moe.num_experts)
    w = {n: torch.tensor(v) for n, v in lp.items()}
    y, aux = moe.train_ffn(cfg, torch.tensor(x), w["router"], w["we1"],
                           w["we2"], w["we3"])
    assert_close(y.numpy(), jy, "train_ffn output")
    assert_close(float(aux), float(jaux), "aux loss")
    m = cfg.moe
    C = moe.capacity(64, m.top_k, m.num_experts, m.capacity_factor)
    _, _, topi = moe.topk_route(torch.tensor(x), w["router"], m.top_k)
    order, dest, keep = moe.capacity_slots(topi, m.num_experts, C)
    flat = topi.reshape(-1)
    kept = {(int(o) // m.top_k, int(flat[o])) for o in order[keep]}
    assert C == 16 and 0 < len(kept) < 64 * m.top_k
    assert kept == reference_kept(x, lp["router"], jcfg)
    assert int(keep.sum()) == len(kept) and int((dest == m.num_experts * C)
                                                .sum()) == 128 - len(kept)
    batch = tm.make_sample_batch(cfg, 2, 32, seed=5)
    ref_, port = loss_and_grads_pair(jcfg, jparams, lm, batch)
    assert_loss_and_grads(ref_, port, "granite, capacity factor 0.5")


def test_remat_does_not_change_gradients():
    """Each layer under torch.utils.checkpoint (cfg.remat, which rebinds
    the masters for the recompute) gives the gradients of the plain
    forward, bit for bit."""
    _, _, cfg, lm = pair("granite_moe_1b_a400m")
    batch = tm.to_device(tm.make_sample_batch(cfg, 2, 32, seed=6), "cpu")
    out = []
    for remat in (True, False):
        lm.cfg = dataclasses.replace(cfg, remat=remat)
        leaves = {n: t.requires_grad_(True)
                  for n, t in tm.masters(lm).items()}
        loss, _ = tm.loss_fn(lm, leaves, batch)
        loss.backward()
        out.append((loss.item(), {n: t.grad for n, t in leaves.items()}))
    assert out[0][0] == out[1][0]
    for n, g in out[0][1].items():
        assert torch.equal(g, out[1][1][n]), n


def test_attention_matches_reference():
    """`layers.attention` against the reference's `layers.attention` on
    the same inputs, at 16 keys a chunk (five chunks, the last padded):
    GQA, causal or not, a window with q_offset and kv_len, and a fully
    masked row (q 69 with window 9 sees only keys >= 61 = kv_len), where
    both average the last chunk's values as the online softmax leaves
    them; and the f32 check at the default 1,024-key chunk."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 70, 2, 32)).astype(np.float32)
            for _ in range(2))
    for kw in (dict(causal=True), dict(causal=False),
               dict(causal=True, window=9, q_offset=30, kv_len=61),
               dict(causal=True, chunk=1024)):
        kw.setdefault("chunk", 16)
        got = L.attention(*(torch.tensor(t) for t in (q, k, v)), **kw)
        want = jlayers.attention(*(jnp.asarray(t) for t in (q, k, v)), **kw)
        assert_close(got.numpy(), want, f"attention {kw}")


def _wrapper_calls(t):
    """Each attention wrapper called on CPU tensors, of which `t` is
    the one that may require grad."""
    g = torch.Generator().manual_seed(1)
    q4 = torch.randn(1, 4, 4, 32, generator=g)
    q3 = torch.randn(1, 4, 32, generator=g)
    k4 = torch.randn(1, 8, 2, 32, generator=g)
    pool = torch.randn(2, 4, 2, 32, generator=g)
    kq, ks = L.quantize_kv(k4)
    pq, ps = L.quantize_kv(pool)
    lens = torch.tensor([6], dtype=torch.int32)
    table = torch.tensor([[1, 0]], dtype=torch.int32)
    return {
        "flash_prefill": lambda: ops.flash_prefill(t(q4), k4, k4),
        "decode_attention": lambda: ops.decode_attention(t(q3), k4, k4, 6),
        "decode_attention_paged": lambda: ops.decode_attention_paged(
            t(q3), pool, pool, lens, table),
        "decode_attention_q8": lambda: ops.decode_attention_q8(
            q3, kq, t(ks), kq, ks, 6),
        "decode_attention_paged_q8": lambda: ops.decode_attention_paged_q8(
            q3, pq, ps, pq, t(ps), lens, table)}


def test_kernel_wrappers_refuse_autograd():
    """The attention kernels have no backward: under grad mode a wrapper
    refuses an input that requires grad, on the CPU as on the card; the
    same call under no_grad, or with nothing requiring grad, returns the
    plain version's result as before."""
    grad = _wrapper_calls(lambda x: x.detach().requires_grad_(True))
    plain = _wrapper_calls(lambda x: x)
    for name, call in grad.items():
        with pytest.raises(ValueError, match="no backward"):
            call()
        with torch.no_grad():
            out = call()
        assert torch.equal(out, plain[name]()), name
    # a serving block on weights that require grad is refused; the
    # training forward (layers.attention) takes them
    _, _, cfg, lm = pair("qwen25_0_5b")
    leaves = {n: t.requires_grad_(True) for n, t in tm.masters(lm).items()}
    tokens = torch.randint(0, 500, (1, 8))
    with bound(lm, leaves):
        x, pos = lm._embed_inputs(tokens)
        with pytest.raises(ValueError, match="no backward"):
            lm._full_block(0, x, pos)
        assert lm.forward_logits(tokens).requires_grad
