"""The port's wave path against the JAX package on the CPU, on the float32
reduced qwen2.5-0.5B and h2o-danube-1.8b (sliding window 64) with the same
converted params: `DenseLM.prefill` / `decode_step` logits within 1e-4 and
caches within 1e-5 of the reference's `model.prefill` / `decode_step`
(for h2o an 80-token prompt, so the ring wraps in prefill and decode);
greedy tokens of the wave `Engine` identical to the reference's; the
port's wave tokens equal to its continuous engine's, whose chunked
prefill runs `flash_prefill`; sliding-window configs routed to the
continuous engine (ring pages) by default; and
`SLM.encode_prompt(bucket=True)` against `ReducedSLM.encode_prompt`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as jmodel
from repro.serving.engine import Engine as JEngine
from repro.serving.slm import ReducedSLM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.models.dense import DenseLM, init_page_pool
from repro_torch.serving.engine import Engine
from repro_torch.serving.slm import SLM

ARCHS = ["qwen25_0_5b", "h2o_danube_1_8b"]


def _models(arch, seed):
    jcfg = j_get_config(arch).reduced(dtype="float32")
    cfg = get_config(arch).reduced(dtype="float32")
    assert cfg.sliding_window == jcfg.sliding_window
    assert cfg.vocab_padded == jcfg.vocab_padded
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    # qwen2.5: tied embeddings and qkv biases; h2o: an lm_head, no biases
    assert ("lm_head" in params) == (not cfg.tie_embeddings)
    assert ("bq" in params) == cfg.qkv_bias
    return jcfg, jparams, cfg, DenseLM(cfg, device="cpu", params=params)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param, 0)


def _grow(cache, target, pad):
    """Zero slots appended along the cache's position axis."""
    return {n: pad(c, target) for n, c in cache.items()}


def test_prefill_and_decode_step_match_reference(models):
    jcfg, jparams, cfg, lm = models
    S = 80 if cfg.sliding_window else 21          # 80 wraps the 64-slot ring
    rng = np.random.default_rng(0)
    toks = rng.integers(3, cfg.vocab_size, (2, S)).astype(np.int32)
    jl, jc = jmodel.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = lm.prefill(torch.tensor(toks.astype(np.int64)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   rtol=1e-5, atol=1e-5)
    if not cfg.sliding_window:                    # room to decode into
        jc = _grow(jc, S + 3, lambda c, t: jnp.concatenate(
            [c, jnp.zeros(c.shape[:2] + (t - c.shape[2],) + c.shape[3:],
                          c.dtype)], axis=2))
        tc = _grow(tc, S + 3, lambda c, t: torch.cat(
            [c, c.new_zeros(c.shape[:2] + (t - c.shape[2],) + c.shape[3:])],
            dim=2))
    assert tc["k"].shape[2] == (64 if cfg.sliding_window else S + 3)
    for pos in range(S, S + 3):
        tok = rng.integers(3, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jcfg, jparams, jc, jnp.asarray(tok),
                                    jnp.int32(pos))
        tl = lm.decode_step(tc, torch.tensor(tok.astype(np.int64)), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   rtol=1e-5, atol=1e-5)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, 500, n).astype(np.int32) for n in lens]


# tests/test_serving.py's mixed lengths; tests/test_paged_families.py's
# wraparound pair (80 > the window of 64) and its wave-parity lengths
CASES = [
    ("qwen25_0_5b", 0, _prompts(7, (16, 24, 16, 33, 40, 9, 24)), 8),
    ("h2o_danube_1_8b", 1, _prompts(11, (80, 20)), 8),
    ("h2o_danube_1_8b", 0, _prompts(7, (16, 24, 33, 40, 9)), 6),
]


@pytest.mark.parametrize("arch,seed,prompts,max_new", CASES,
                         ids=["qwen", "h2o-wrap", "h2o-mixed"])
def test_wave_engine_matches_reference(arch, seed, prompts, max_new):
    jcfg, jparams, cfg, lm = _models(arch, seed)
    want = JEngine(jcfg, jparams, max_len=96, slots=2).generate(
        prompts, max_new=max_new, continuous=False)
    got = Engine(lm, max_len=96, slots=2).generate(
        prompts, max_new=max_new, continuous=False)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.tokens == w.tokens, f"{arch} request {i} diverged"
        assert g.prompt_len == w.prompt_len and g.prefill_s > 0


def test_wave_equals_continuous_qwen():
    _, _, _, lm = _models("qwen25_0_5b", 0)
    eng = Engine(lm, max_len=100, slots=2)
    prompts = _prompts(3, (16, 24, 16, 33, 40, 9, 97))
    wave = eng.generate(prompts, max_new=3, continuous=False)
    cont = eng.generate(prompts, max_new=3)           # None: continuous
    assert eng.continuous().steps > 0
    for i, (w, c) in enumerate(zip(wave, cont)):
        assert w.tokens == c.tokens, f"request {i} diverged"


def test_sliding_window_routes_to_continuous():
    """`generate(continuous=None)` on the reduced h2o runs the continuous
    engine over ring pages (the reference's routing) and gives the
    reference's tokens; its paged steps take `ring_len` and `limit`."""
    jcfg, jparams, cfg, lm = _models("h2o_danube_1_8b", 0)
    prompts = _prompts(5, (12, 70, 33))
    want = JEngine(jcfg, jparams, max_len=96, slots=2).generate(
        prompts, max_new=4)
    eng = Engine(lm, max_len=96, slots=2)
    got = eng.generate(prompts, max_new=4)
    ce = eng.continuous()
    assert ce.steps > 0 and ce.ring_len == cfg.sliding_window
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.tokens == w.tokens, f"request {i} diverged"
    pool = init_page_pool(cfg, 16, 8, device="cpu")
    row = torch.arange(8, dtype=torch.int32)
    logits = lm.prefill_chunk_paged(pool, torch.ones(1, 8, dtype=torch.long),
                                    row, 0, 5, page_size=8, ring_len=64)
    assert logits.shape == (1, 8, cfg.vocab_padded)
    assert pool["k"][:, :, 5:].abs().sum() == 0     # padding never written
    out = lm.decode_step_paged(pool, torch.ones(1, 1, dtype=torch.long),
                               torch.tensor([5]), torch.ones(1,
                                                             dtype=torch.bool),
                               row[None], page_size=8, ring_len=64)
    assert out.shape == (1, cfg.vocab_padded) and bool(out.isfinite().all())


def test_encode_prompt_buckets_like_reference():
    ref = ReducedSLM("qwen25_0_5b")
    slm = SLM(get_config("qwen25_0_5b").reduced(), device="cpu")
    rng = np.random.default_rng(2)
    words = [f"w{i}" for i in range(300)]
    for n in (0, 1, 31, 32, 33, 200, 400):
        text = " ".join(rng.choice(words, n))
        want = ref.encode_prompt(text)
        got = slm.encode_prompt(text, bucket=True)
        assert got.dtype == want.dtype and np.array_equal(got, want), n
        assert np.array_equal(slm.encode_prompt(text),
                              ref.encode_prompt(text, bucket=False))
    assert slm.measure_ttft("a short question") > 0
