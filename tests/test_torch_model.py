"""The port's DenseLM and ContinuousEngine against the JAX package on the
CPU, on the float32 reduced qwen2.5-0.5B with the same converted params:
chunked paged prefill and paged decode logits within 1e-4 on the same
page tables, and identical greedy tokens, prefix hits, COW forks and
trace records from the two engines."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jmodel
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro.serving.trace import TraceSink as JTraceSink
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.models.dense import DenseLM, init_page_pool
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.trace import TraceSink


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("qwen25_0_5b").reduced(dtype="float32")
    cfg = get_config("qwen25_0_5b").reduced(dtype="float32")
    assert cfg.vocab_padded == jcfg.vocab_padded
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    lm = DenseLM(cfg, device="cpu", params=params_from_reference(tree, "cpu"))
    return jcfg, jparams, cfg, lm


def test_prefill_and_decode_logits_match(models):
    jcfg, jparams, cfg, lm = models
    ps, P = 8, 12
    jc = jmodel.init_page_pool(jcfg, P, ps, dtype=jnp.float32)
    tc = init_page_pool(cfg, P, ps, device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, cfg.vocab_size, 21).astype(np.int32)
    rows = np.asarray([[5, 2, 7, 1], [3, 9, 0, 0], [4, 6, 11, 0]], np.int32)
    C = 8
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
            torch.tensor(rows[0]), off, page_size=ps)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               rtol=1e-5, atol=1e-5)
    # three slots: one decoding after the prefill above, one fresh, one
    # inactive (its writes drop); per-row kv_len and unmapped tail pages
    pos = np.asarray([21, 3, 5], np.int32)
    active = np.asarray([True, True, False])
    for step in range(3):
        tok = rng.integers(3, cfg.vocab_size, (3, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step_paged(
            jcfg, jparams, jc, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(active), jnp.asarray(rows), page_size=ps)
        tl = lm.decode_step_paged(
            tc, torch.tensor(tok.astype(np.int64)),
            torch.tensor(pos.astype(np.int64)), torch.tensor(active),
            torch.tensor(rows), page_size=ps)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=1e-4, atol=1e-4)
        pos = pos + active
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               rtol=1e-5, atol=1e-5)


def _records(sink):
    return [(r.comp, r.name, r.rid, r.ph) for r in sink.records()]


def test_engine_greedy_prefix_cow_matches_reference(models):
    jcfg, jparams, cfg, lm = models
    rng = np.random.default_rng(1)
    base = rng.integers(3, cfg.vocab_size, 30).astype(np.int32)
    prompts = [base,
               np.concatenate([base[:20], rng.integers(3, 500, 9)]),  # COW
               rng.integers(3, cfg.vocab_size, 13).astype(np.int32),
               base.copy(),                                      # full hit
               np.concatenate([base[:8], rng.integers(3, 500, 17)])]
    prompts = [p.astype(np.int32) for p in prompts]
    kw = dict(slots=2, max_len=64, page_size=8, prefill_chunk=8)
    jsink, tsink = JTraceSink(), TraceSink()
    jeng = JContinuousEngine(jcfg, jparams, trace=jsink, **kw)
    teng = ContinuousEngine(lm, trace=tsink, **kw)
    jres = jeng.generate(prompts, max_new=6)
    tres = teng.generate(prompts, max_new=6)
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
    assert teng.prefix_hits == jeng.prefix_hits >= 2
    assert teng.prefix_tokens_reused == jeng.prefix_tokens_reused
    assert any(r[1] == "cow_fork" for r in _records(tsink))
    assert _records(tsink) == _records(jsink)
    with pytest.raises(NotImplementedError):
        teng.submit(base, 4, greedy=False)
