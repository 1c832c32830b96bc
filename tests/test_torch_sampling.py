"""Sampled decoding in the port against the JAX package on the CPU.

`repro_torch.serving.sampling` against `jax.random` (jax_threefry_
partitionable, the default): `prng_key`, `fold_in`, `random_bits` and
`uniform` bit for bit; `gumbel` within 2 ulp of max(|g|, 1) (`log`
rounds one ulp apart from XLA's, and -log(-log u) carries the inner
log's ulp into the outer one); `categorical` and `sample_rows` equal to
jax's draws and to the reference engine's `_sample_rows`. Then the
reference's sampled scenarios on the float32 reduced qwen2.5-0.5B with
the same converted params, the port's tokens equal to the reference
engine's: the same (seed, rid) under 0, 1, 2 and 4 co-residents,
`Engine.generate(greedy=False)` on the continuous engine and on waves,
and a sampled `RagSession`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.tokenizer import HashTokenizer as JHashTokenizer
from repro.models import model as jmodel
from repro.serving.embedder import HashEmbedder as JHashEmbedder
from repro.serving.engine import ContinuousEngine as JContinuousEngine
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import _sample_rows as j_sample_rows
from repro.serving.rag import MobileRAG as JMobileRAG
from repro.serving.slm import ReducedSLM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.models.dense import DenseLM
from repro_torch.serving import sampling as S
from repro_torch.serving.embedder import HashEmbedder
from repro_torch.serving.engine import ContinuousEngine, Engine
from repro_torch.serving.rag import MobileRAG

SEEDS = (0, 3, 9, 2 ** 31 - 1)
RIDS = (0, 1, 100, 2 ** 31 - 1)
SHAPES = ((1,), (7,), (3, 1000), (151936,))
TINY = np.finfo(np.float32).tiny


def _words(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_equal_jax(seed):
    jkey = jax.random.PRNGKey(seed)
    key = S.prng_key(seed)
    np.testing.assert_array_equal(key.numpy(), _words(jkey))
    for rid in RIDS:
        jf = jax.random.fold_in(jkey, rid)
        f = S.fold_in(key, rid)
        np.testing.assert_array_equal(f.numpy(), _words(jf))
        for shape in SHAPES:
            bits = S.random_bits(f, shape).numpy()
            assert bits.shape == shape
            np.testing.assert_array_equal(
                bits, _words(jax.random.bits(jf, shape)))


def test_batched_keys_and_bounds():
    """Keys [B, 2] fold and draw row by row; a seed outside [0, 2^31)
    is refused."""
    keys = torch.stack([S.prng_key(s) for s in SEEDS])
    folded = S.fold_in(keys, torch.tensor(RIDS))
    bits = S.random_bits(folded, (5, 3))
    for i, (s, r) in enumerate(zip(SEEDS, RIDS)):
        jf = jax.random.fold_in(jax.random.PRNGKey(s), r)
        np.testing.assert_array_equal(folded[i].numpy(), _words(jf))
        np.testing.assert_array_equal(bits[i].numpy(),
                                      _words(jax.random.bits(jf, (5, 3))))
    for bad in (-1, 2 ** 31):
        with pytest.raises(ValueError):
            S.prng_key(bad)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_equal_and_gumbel_within_2ulp(seed):
    n = 151936
    for rid in RIDS:
        jf = jax.random.fold_in(jax.random.PRNGKey(seed), rid)
        f = S.fold_in(S.prng_key(seed), rid)
        ju = np.asarray(jax.random.uniform(jf, (n,), minval=TINY,
                                           maxval=1.0))
        u = S.uniform(f, (n,)).numpy()
        np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))
        jg = np.asarray(jax.random.gumbel(jf, (n,)))
        g = S.gumbel(f, (n,)).numpy()
        ulps = np.abs(g - jg) / np.spacing(np.maximum(np.abs(jg),
                                                      np.float32(1)))
        assert ulps.max() <= 2.0, ulps.max()


def _tied_rows(n_rows, width, seed):
    """bf16-rounded logits; every third row has its maximum tied at four
    positions, every fifth row is constant."""
    rng = np.random.default_rng(seed)
    rows = torch.tensor(rng.normal(size=(n_rows, width)) * 2.0,
                        dtype=torch.float32).to(torch.bfloat16).float()
    rows = rows.numpy().copy()
    for i in range(0, n_rows, 3):
        top = rows[i].max()
        rows[i, rng.choice(width, 4, replace=False)] = top
    rows[::5] = 0.5
    return rows


def test_categorical_matches_jax():
    rows = _tied_rows(256, 1000, seed=1)
    draw = jax.jit(jax.random.categorical)
    keys = [jax.random.fold_in(jax.random.PRNGKey(11), i) for i in range(256)]
    want = np.asarray([int(draw(k, r)) for k, r in zip(keys, rows)])
    tkeys = torch.tensor(np.stack([_words(k) for k in keys]))
    got = S.categorical(tkeys, torch.tensor(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    # one key, one row
    assert int(S.categorical(tkeys[7], torch.tensor(rows[7]))) == want[7]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_rows_matches_reference(dtype):
    B, V = 6, 997
    rows = _tied_rows(B, V, seed=2)
    jkeys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(5),
                                                    r)) for r in range(B)])
    ts = np.asarray([0, 3, 7, 1, 0, 12], np.int32)
    greedy = np.asarray([True, False, False, True, False, False])
    jlog = jnp.asarray(rows).astype(dtype)
    want = np.asarray(j_sample_rows(jlog, jnp.asarray(jkeys),
                                    jnp.asarray(ts), jnp.asarray(greedy)))
    tlog = torch.tensor(rows).to(getattr(torch, dtype))
    got = S.sample_rows(tlog, jkeys.astype(np.int64), ts, greedy)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # every row greedy: the first maximum of each row
    allg = S.sample_rows(tlog, jkeys.astype(np.int64), ts, np.ones(B, bool))
    np.testing.assert_array_equal(allg.numpy(), np.argmax(
        tlog.float().numpy(), -1))


# ---------------------------------------------------------- engines


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("qwen25_0_5b").reduced(dtype="float32")
    cfg = get_config("qwen25_0_5b").reduced(dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    lm = DenseLM(cfg, device="cpu", params=params_from_reference(
        jax.tree.map(np.asarray, jparams), "cpu"))
    return jcfg, jparams, lm


def _drain(ce, tid):
    res = {}
    while ce.pending:
        for ev in ce.step():
            if ev.kind == "done":
                res[ev.rid] = ev.result.tokens
    return res[tid]


def _run_sampled(make, target, co, *, rid=100, seed=5, max_new=8):
    """Target request sampled under `co` co-residents; its tokens."""
    ce = make()
    tid = ce.submit(target, max_new=max_new, rid=rid, greedy=False,
                    seed=seed)
    for i, p in enumerate(co):
        ce.submit(p, max_new=max_new, rid=i, greedy=False, seed=seed)
    return _drain(ce, tid)


def test_sampling_reproducible_across_coresident_mixes(models):
    """The same (seed, rid) gives the reference's tokens alone and with
    1, 2 and 4 co-residents (tests/test_paged_families.py); another seed
    gives another stream."""
    jcfg, jparams, lm = models
    rng = np.random.default_rng(3)
    target = rng.integers(4, 500, 20).astype(np.int32)
    others = [rng.integers(4, 500, n).astype(np.int32)
              for n in (12, 28, 17, 22)]
    want = _run_sampled(
        lambda: JContinuousEngine(jcfg, jparams, slots=4, max_len=96),
        target, [])
    make = lambda: ContinuousEngine(lm, slots=4, max_len=96)  # noqa: E731
    runs = [_run_sampled(make, target, others[:n]) for n in (0, 1, 2, 4)]
    assert all(r == want for r in runs), (want, runs)
    ce = make()
    tid = ce.submit(target, max_new=8, rid=100, greedy=False, seed=6)
    assert _drain(ce, tid) != want


def test_sampled_requests_route_through_continuous(models):
    """`Engine.generate(greedy=False)` runs on the continuous engine,
    reproducibly, with the reference's tokens, and differs from
    greedy."""
    jcfg, jparams, lm = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(4, 500, n).astype(np.int32) for n in (14, 14, 22)]
    eng = Engine(lm, max_len=96)
    a = eng.generate(prompts, max_new=6, greedy=False, seed=3)
    b = eng.generate(prompts, max_new=6, greedy=False, seed=3)
    assert [x.tokens for x in a] == [x.tokens for x in b]
    assert eng.continuous().steps > 0
    want = JEngine(jcfg, jparams, max_len=96).generate(
        prompts, max_new=6, greedy=False, seed=3)
    assert [x.tokens for x in a] == [x.tokens for x in want]
    g = eng.generate(prompts, max_new=6)
    assert any(x.tokens != y.tokens for x, y in zip(a, g))


def test_wave_and_paged_sampling_agree(models):
    """Waves draw from the same per-request streams as the continuous
    engine (tests/test_pager.py): equal tokens on both paths, equal to
    the reference's."""
    jcfg, jparams, lm = models
    rng = np.random.default_rng(23)
    prompts = [rng.integers(4, 500, n).astype(np.int32) for n in (16, 16, 24)]
    eng = Engine(lm, max_len=96, slots=2)
    wave = eng.generate(prompts, max_new=6, greedy=False, seed=9,
                        continuous=False)
    cont = eng.generate(prompts, max_new=6, greedy=False, seed=9,
                        continuous=True)
    jwave = JEngine(jcfg, jparams, max_len=96, slots=2).generate(
        prompts, max_new=6, greedy=False, seed=9, continuous=False)
    for i, (w, c, j) in enumerate(zip(wave, cont, jwave)):
        assert w.tokens == c.tokens == j.tokens, f"request {i} diverged"
    # explicit rids pick the streams: a wave of request 1 alone, as rid 1
    solo = eng.generate_wave([prompts[1]], max_new=6, greedy=False, seed=9,
                             rids=[1])
    assert solo[0].tokens == wave[1].tokens


def _word_corpus(n_docs, seed, sentences=12, words=7):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    return [" ".join(" ".join(rng.choice(vocab, words)).capitalize() + "."
                     for _ in range(sentences)) for _ in range(n_docs)]


def test_sampled_session_matches_reference(models):
    """A sampled RagSession (3 slots, chunks of 2) against the reference's
    on the same documents, queries and weights: the same doc ids,
    prompts and sampled tokens (the engine rids, warmup first, are the
    reference's), and `stream` yields each request's tokens in order."""
    jcfg, jparams, lm = models
    docs = _word_corpus(120, seed=4)
    queries = [docs[i].split(". ")[1 + i % 4] for i in range(2, 120, 23)]
    kw = dict(max_new=6, slots=3, retrieve_chunk=2, greedy=False, seed=7)
    jpipe = JMobileRAG(docs, JHashEmbedder(dim=64), device_retrieval=True,
                       top_k=3)
    slm = ReducedSLM()
    slm._engine = JEngine(jcfg, jparams, max_len=slm.max_prompt + slm.max_new,
                          page_size=slm.page_size)
    slm._tok = JHashTokenizer(jcfg.vocab_size)
    jpipe._slm_engine = slm
    want = jpipe.session(**kw).run(queries)
    pipe = MobileRAG(docs, HashEmbedder(dim=64), top_k=3,
                     gen_config=lm.cfg, gen_params=dict(
                         lm.named_parameters()), device="cpu")
    sess = pipe.session(**kw)
    assert sess.engine is pipe.slm.continuous(3)
    got = sess.run(queries)
    for a, b in zip(got, want):
        assert a.doc_ids == b.doc_ids and a.prompt == b.prompt
        assert a.gen_tokens == b.gen_tokens and len(a.gen_tokens) >= 1
    greedy = pipe.session(max_new=6, slots=3).run(queries[:2])
    assert any(a.gen_tokens != b.gen_tokens for a, b in zip(greedy, got))
    events = list(pipe.stream(queries[:2], max_new=4, slots=3))
    for rid in (0, 1):
        toks = [e.payload for e in events
                if e.req_id == rid and e.kind == "token"]
        done = [e.payload for e in events
                if e.req_id == rid and e.kind == "done"]
        assert [e.kind for e in events if e.req_id == rid][0] == "submitted"
        assert len(done) == 1 and done[0].gen_tokens == toks
