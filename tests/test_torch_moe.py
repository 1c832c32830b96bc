"""The port's MoE family against the JAX package on the CPU, on the
float32 reduced granite-moe-1b-a400m (4 experts, top 2) with converted
params, `dense_residual` both ways: the routing (top-k ties to the lower
expert id, as `lax.top_k`) and the drop-free expert FFN against
`moe._local_moe` at capacity T; `MoELM.prefill` / `decode_step` logits
and caches against `moe.prefill` / `decode_step`; the paged chunk
prefill and paged decode against the reference's on the same page
tables; and the FFN's bits independent of its co-batched rows."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.models import moe
from repro_torch.models.dense import init_page_pool
from repro_torch.models.moe import MoELM

RESIDUAL = [False, True]


def _cfgs(dense_residual):
    out = []
    for c in (j_get_config("granite_moe_1b_a400m"),
              get_config("granite_moe_1b_a400m")):
        c = c.reduced(dtype="float32")
        out.append(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, dense_residual=dense_residual)))
    return out


@pytest.fixture(scope="module", params=RESIDUAL,
                ids=["experts", "dense_residual"])
def models(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    assert ("w1" in tree["layers"]) == request.param
    assert ("moe_norm" in tree["layers"]) == request.param
    lm = MoELM(cfg, device="cpu", params=params_from_reference(tree, "cpu"))
    assert {n for n, _ in lm.named_parameters()} == (
        set(tree["layers"]) | set(tree) - {"layers"})
    return jcfg, jparams, cfg, lm


def test_route_breaks_ties_to_the_lower_expert():
    """Equal router probabilities: the lower expert ids win, ascending in
    the output, with the reference's renormalised weights."""
    x = torch.zeros(3, 8)
    x[1, 0] = 1.0
    router = torch.zeros(8, 6)
    router[0, 4] = router[0, 5] = 2.0       # row 1: experts 4, 5 tie on top
    eid, w = moe.route(x, router, 3)
    assert eid.tolist() == [[0, 1, 2], [0, 4, 5], [0, 1, 2]]
    probs = jax.nn.softmax(jnp.asarray(x.numpy()) @ jnp.asarray(
        router.numpy()), -1)
    topv, topi = jax.lax.top_k(probs, 3)
    assert sorted(np.asarray(topi)[1].tolist()) == eid[1].tolist()
    topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(w.sum(-1).numpy(), np.ones(3), rtol=1e-6)
    np.testing.assert_allclose(np.sort(w.numpy(), -1),
                               np.sort(np.asarray(topv), -1), rtol=1e-6)


def test_moe_ffn_matches_local_moe(models):
    jcfg, jparams, cfg, lm = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((37, cfg.d_model)).astype(np.float32)
    lp = {k: v[0] for k, v in jparams["layers"].items()}
    want, _ = jmoe._local_moe(jcfg, jnp.asarray(x), lp["router"], lp["we1"],
                              lp["we2"], lp["we3"], 0,
                              jcfg.moe.num_experts, capacity=37)
    got = moe.moe_ffn(torch.tensor(x), lm.router[0], lm.we1[0], lm.we2[0],
                      lm.we3[0], cfg.moe.top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # a row's bits do not depend on its co-batched rows
    part = moe.moe_ffn(torch.tensor(x[5:9]), lm.router[0], lm.we1[0],
                       lm.we2[0], lm.we3[0], cfg.moe.top_k)
    assert torch.equal(part, got[5:9])


def test_prefill_and_decode_step_match_reference(models):
    jcfg, jparams, cfg, lm = models
    S = 21
    rng = np.random.default_rng(0)
    toks = rng.integers(3, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill(torch.tensor(toks.astype(np.int64)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   rtol=1e-5, atol=1e-5)
    pad = 3
    jc = {n: jnp.concatenate([c, jnp.zeros(c.shape[:2] + (pad,)
                                           + c.shape[3:], c.dtype)], 2)
          for n, c in jc.items()}
    tc = {n: torch.cat([c, c.new_zeros(c.shape[:2] + (pad,) + c.shape[3:])],
                       2) for n, c in tc.items()}
    for pos in range(S, S + pad):
        tok = rng.integers(3, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jcfg, jparams, jc, jnp.asarray(tok),
                                    jnp.int32(pos))
        tl = lm.decode_step(tc, torch.tensor(tok.astype(np.int64)), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   rtol=1e-5, atol=1e-5)


def test_paged_chunks_and_decode_match_reference(models):
    jcfg, jparams, cfg, lm = models
    ps, P, C = 8, 12, 8
    jc = jmodel.init_page_pool(jcfg, P, ps, dtype=jnp.float32)
    tc = init_page_pool(cfg, P, ps, device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, cfg.vocab_size, 21).astype(np.int32)
    rows = np.asarray([[5, 2, 7, 1], [3, 9, 0, 0], [4, 6, 11, 0]], np.int32)
    for off in range(0, len(prompt), C):
        chunk = prompt[off:off + C]
        real = len(chunk)
        chunk = np.pad(chunk, (0, C - real))
        jl, jc = jmodel.prefill_chunk_paged(
            jcfg, jparams, jc, jnp.asarray(chunk[None]),
            jnp.asarray(rows[0]), jnp.int32(off), jnp.int32(off + real),
            page_size=ps)
        tl = lm.prefill_chunk_paged(
            tc, torch.tensor(chunk[None].astype(np.int64)),
            torch.tensor(rows[0]), off, off + real, page_size=ps)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    pos = np.asarray([21, 3, 5], np.int32)
    active = np.asarray([True, True, False])
    for _ in range(3):
        tok = rng.integers(3, cfg.vocab_size, (3, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step_paged(
            jcfg, jparams, jc, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(active), jnp.asarray(rows), page_size=ps)
        tl = lm.decode_step_paged(
            tc, torch.tensor(tok.astype(np.int64)),
            torch.tensor(pos.astype(np.int64)), torch.tensor(active),
            torch.tensor(rows), page_size=ps)
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   rtol=1e-4, atol=1e-4)
        pos = pos + active
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   rtol=1e-5, atol=1e-5)
