"""The paper's Table-5 pipelines on the CPU, the port against the JAX
package: Naive-RAG, Advanced-RAG (the x3 candidate set re-ranked by best
sentence similarity) and EdgeRAG (IVF-DISK and the bounded LRU query
cache) give the reference's doc ids, prompts and prompt tokens on its QA
corpus (100 documents, HashEmbedder at 96, host search on both);
`_finalize` gives the reference's Table-6 TTFT and energy at fixed
times; `accuracy` and `answer_in_context` agree; `SLM.generate` and
`answer(q, generate=True)` give the reference's float32 greedy tokens on
reduced qwen2.5-0.5B (weights carried across by
`params_from_reference`; each package's pipelines share one sLM, as the
reference's share its `ReducedSLM`). MobileRAG's generate runs over a
random-word corpus, whose SCR windows never tie (ROADMAP F5; the QA
corpus repeats filler sentences). The reference's
`tests/test_serving.py` cases have counterparts at the end."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.data.synthetic import make_qa_corpus as j_make_qa_corpus
from repro.data.tokenizer import HashTokenizer as JHashTokenizer
from repro.models import model as jmodel
from repro.serving import rag as jrag
from repro.serving.embedder import HashEmbedder as JHashEmbedder
from repro.serving.engine import Engine as JEngine
from repro.serving.slm import ReducedSLM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.data.synthetic import make_qa_corpus
from repro_torch.kernels.ops import KernelError
from repro_torch.serving import rag
from repro_torch.serving.embedder import HashEmbedder
from repro_torch.serving.slm import SLM

BASELINES = ["naive", "advanced", "edge"]
N_Q = 10


@pytest.fixture(scope="module")
def corpus():
    c = make_qa_corpus(n_docs=100, n_questions=20, seed=0)
    jc = j_make_qa_corpus("squad", n_docs=100, n_questions=20, seed=0)
    assert c.docs == jc.docs
    assert [(e.question, e.answer) for e in c.examples] == \
        [(e.question, e.answer) for e in jc.examples]
    return c


@pytest.fixture(scope="module")
def slms():
    """The reference's sLM (float32 reduced qwen2.5-0.5B) and the port's
    on the same weights."""
    jcfg = j_get_config("qwen25_0_5b").reduced(dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jslm = ReducedSLM()
    jslm._engine = JEngine(jcfg, jparams,
                           max_len=jslm.max_prompt + jslm.max_new,
                           page_size=jslm.page_size)
    jslm._tok = JHashTokenizer(jcfg.vocab_size)
    cfg = get_config("qwen25_0_5b").reduced(dtype="float32")
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    return SLM(cfg, params=params, device="cpu"), jslm


@pytest.fixture(scope="module")
def pipes(corpus):
    """name -> (port pipeline, reference pipeline) over the QA corpus;
    Naive and Advanced share one index in each package."""
    out = {}
    for name in BASELINES:
        kw, jkw = {}, {}
        if name == "advanced":
            kw["index"] = out["naive"][0].index
            jkw["index"] = out["naive"][1].index
        out[name] = (rag.PIPELINES[name](corpus.docs, HashEmbedder(dim=96),
                                         top_k=3, device="cpu", **kw),
                     jrag.PIPELINES[name](corpus.docs,
                                          JHashEmbedder(dim=96), top_k=3,
                                          **jkw))
    return out


def _same(a, b):
    assert a.doc_ids == b.doc_ids
    assert a.prompt == b.prompt
    assert a.prompt_tokens == b.prompt_tokens


@pytest.mark.parametrize("name", BASELINES)
def test_baselines_match_reference(pipes, corpus, name):
    pipe, jpipe = pipes[name]
    assert not pipe.device_retrieval and not jpipe.device_retrieval
    qs = [e.question for e in corpus.examples[:N_Q]]
    for q in qs:
        _same(pipe.answer(q), jpipe.answer(q))
    for a, b in zip(pipe.answer_batch(qs), jpipe.answer_batch(qs)):
        _same(a, b)
    assert pipe.retrieval_fallbacks == jpipe.retrieval_fallbacks == 0


def test_advanced_rerank_matches_reference(pipes, corpus):
    """The re-rank keeps top_k of the x3 candidates in the reference's
    order, and reorders some query against plain retrieval."""
    (adv, jadv), (naive, _) = pipes["advanced"], pipes["naive"]
    moved = 0
    for e in corpus.examples[:N_Q]:
        a, b = adv.answer(e.question), jadv.answer(e.question)
        assert a.doc_ids == b.doc_ids and len(a.doc_ids) == 3
        cands = naive._retrieve(adv.embed([e.question])[0], 9)
        assert set(a.doc_ids) <= set(cands)
        moved += a.doc_ids != cands[:3]
        assert a.post_s > 0
    assert moved > 0


@pytest.mark.parametrize("slm", sorted(rag.SLM_SPEEDS))
def test_finalize_matches_reference(corpus, slm):
    """The Table-6 model at fixed times: the same TTFT and energy, field
    for field, and the generator hook's text."""
    assert rag.SLM_SPEEDS == jrag.SLM_SPEEDS
    assert rag.BATTERY_J == jrag.BATTERY_J
    gen = lambda p: p[-12:].upper()          # noqa: E731
    pipe = rag.NaiveRAG.__new__(rag.NaiveRAG)
    pipe.speeds, pipe.generator = rag.SLM_SPEEDS[slm], gen
    jpipe = jrag.NaiveRAG.__new__(jrag.NaiveRAG)
    jpipe.slm, jpipe.generator = jrag.SLM_SPEEDS[slm], gen
    for i, (t_ret, t_post) in enumerate([(0.0, 0.0), (1.25e-3, 4.5e-4),
                                         (0.031, 0.0072)]):
        prompt = " ".join(corpus.docs[i].split()[: 40 + 30 * i])
        a = pipe._finalize("q", prompt, [i, 2], t_ret, t_post)
        b = jpipe._finalize("q", prompt, [i, 2], t_ret, t_post)
        assert [a.prompt_tokens, a.ttft_model_s, a.energy_model_j,
                a.generated, a.retrieval_s, a.post_s] == \
            [b.prompt_tokens, b.ttft_model_s, b.energy_model_j,
             b.generated, b.retrieval_s, b.post_s]


def test_ragan_answer_fields_in_reference_order():
    import dataclasses
    assert [f.name for f in dataclasses.fields(rag.RAGAnswer)] == \
        [f.name for f in dataclasses.fields(jrag.RAGAnswer)]


def test_edge_qcache_lru_matches_reference(corpus):
    edge = rag.EdgeRAG(corpus.docs, HashEmbedder(dim=96), top_k=3,
                       device="cpu")
    jedge = jrag.EdgeRAG(corpus.docs, JHashEmbedder(dim=96), top_k=3)
    edge.qcache_cap = jedge.qcache_cap = 3
    stream = ["a?", "b?", "c?", "a?", "d?", "e?", "a?", "b?", "e?"]
    for q in stream:
        _same(edge.answer(q), jedge.answer(q))
        assert list(edge._qcache) == list(jedge._qcache)
        assert (edge.qcache_hits, edge.qcache_misses) == \
            (jedge.qcache_hits, jedge.qcache_misses)
    assert len(edge._qcache) == 3 and edge.qcache_hits >= 2
    assert edge.qcache_hits + edge.qcache_misses == len(stream)


@pytest.mark.parametrize("name", BASELINES + ["mobile"])
def test_accuracy_matches_reference(pipes, corpus, name):
    if name == "mobile":
        pipe = rag.MobileRAG(corpus.docs, HashEmbedder(dim=96), top_k=3,
                             device="cpu")
        jpipe = jrag.MobileRAG(corpus.docs, JHashEmbedder(dim=96), top_k=3,
                               device_retrieval=True)
    else:
        pipe, jpipe = pipes[name]
    exs = corpus.examples[:15]
    assert rag.accuracy(pipe, exs) == jrag.accuracy(jpipe, exs)
    for e, a, b in zip(exs, pipe.answer_batch([e.question for e in exs]),
                       jpipe.answer_batch([e.question for e in exs])):
        assert rag.answer_in_context(e, a) == jrag.answer_in_context(e, b)
    assert rag.accuracy(pipe, []) == 0.0


def test_slm_generate_matches_reference(slms, corpus):
    slm, jslm = slms
    prompts = [corpus.docs[3][:300], "Question: what is it?\nAnswer:",
               " ".join(corpus.docs[:4])]
    got = slm.generate(prompts, max_new=6)
    want = jslm.generate(prompts, max_new=6)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and len(g.tokens) >= 1
        assert g.text == w.text
        assert g.prompt_tokens == w.prompt_tokens
        assert g.ttft_s > 0
    assert got[2].prompt_tokens == slm.MAX_PROMPT
    for bad in (0, slm.MAX_NEW + 1):
        with pytest.raises(ValueError):
            slm.generate(prompts[:1], max_new=bad)
        with pytest.raises(ValueError):
            jslm.generate(prompts[:1], max_new=bad)
    slm.warmup()
    jslm.warmup()


def word_corpus(n_docs, seed, sentences=12, words=7):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    return [" ".join(" ".join(rng.choice(vocab, words)).capitalize() + "."
                     for _ in range(sentences)) for _ in range(n_docs)]


@pytest.mark.parametrize("name", BASELINES + ["mobile"])
def test_answer_generate_matches_reference(slms, pipes, corpus, name):
    """`answer(q, generate=True)`: the same prompt, prompt tokens and
    float32 greedy tokens as the reference's, on each package's shared
    sLM (Naive and Advanced and Edge on the QA corpus; MobileRAG on a
    random-word corpus)."""
    slm, jslm = slms
    if name == "mobile":
        docs = word_corpus(80, seed=11)
        q = docs[17].split(". ")[3]
        pipe = rag.MobileRAG(docs, HashEmbedder(dim=64), top_k=3,
                             device="cpu")
        jpipe = jrag.MobileRAG(docs, JHashEmbedder(dim=64), top_k=3,
                               device_retrieval=True)
    else:
        pipe, jpipe = pipes[name]
        q = corpus.examples[4].question
    pipe._slm, jpipe._slm_engine = slm, jslm
    a = pipe.answer(q, generate=True, max_new=6)
    b = jpipe.answer(q, generate=True, max_new=6)
    _same(a, b)
    assert a.gen_tokens == b.gen_tokens and len(a.gen_tokens) >= 1
    assert a.generated == b.generated
    assert a.ttft_measured_s > 0


def test_kernel_fault_not_absorbed_by_the_base_ladder(corpus, monkeypatch):
    """The base class's retrieval ladder absorbs an index fault (counted,
    the corpus head served) but never a kernel fault."""
    pipe = rag.NaiveRAG(corpus.docs[:60], HashEmbedder(dim=96), top_k=3,
                        device="cpu")
    q = corpus.examples[0].question

    def down(*a, **kw):
        raise RuntimeError("index down")
    monkeypatch.setattr(pipe.index, "search", down)
    a = pipe.answer(q)
    assert pipe.retrieval_fallbacks == 1 and a.doc_ids == [0, 1, 2]

    def kernel(*a, **kw):
        raise KernelError("ecoscan: launch failed")
    monkeypatch.setattr(pipe.index, "search", kernel)
    with pytest.raises(KernelError):
        pipe.answer(q)
    assert pipe.retrieval_fallbacks == 1


# ---- counterparts of the reference's tests/test_serving.py cases


def test_all_pipelines_answer(pipes, corpus):
    built = {n: p for n, (p, _) in pipes.items()}
    built["mobile"] = rag.MobileRAG(corpus.docs, HashEmbedder(dim=96),
                                    top_k=3, device="cpu")
    assert set(built) == set(rag.PIPELINES)
    for name, pipe in built.items():
        assert isinstance(pipe, rag.PIPELINES[name])
        a = pipe.answer(corpus.examples[0].question)
        assert a.prompt_tokens > 0
        assert a.ttft_model_s > 0 and a.energy_model_j > 0
        assert len(a.doc_ids) > 0


def test_mobilerag_reduces_tokens_at_same_accuracy(pipes, corpus):
    naive = pipes["naive"][0]
    mobile = rag.MobileRAG(corpus.docs, HashEmbedder(dim=96), top_k=3,
                           device="cpu")
    acc_n = rag.accuracy(naive, corpus.examples, max_q=15)
    acc_m = rag.accuracy(mobile, corpus.examples, max_q=15)
    tok_n = np.mean([naive.answer(e.question).prompt_tokens
                     for e in corpus.examples[:10]])
    tok_m = np.mean([mobile.answer(e.question).prompt_tokens
                     for e in corpus.examples[:10]])
    assert tok_m < tok_n * 0.8          # >= 20% token reduction
    assert acc_m >= acc_n - 0.15        # no material accuracy loss


def test_mobilerag_ttft_beats_naive(pipes, corpus):
    naive = pipes["naive"][0]
    mobile = rag.MobileRAG(corpus.docs, HashEmbedder(dim=96), top_k=3,
                           device="cpu")
    q = corpus.examples[0].question
    assert mobile.answer(q).ttft_model_s < naive.answer(q).ttft_model_s


def test_mobilerag_generate_end_to_end(slms, corpus):
    """answer(query, generate=True) and answer_batch(generate=True)
    return real decoded tokens with a measured TTFT."""
    mobile = rag.MobileRAG(corpus.docs, HashEmbedder(dim=96), top_k=3,
                           device="cpu")
    mobile._slm = slms[0]
    a = mobile.answer(corpus.examples[0].question, generate=True)
    assert a.gen_tokens and 1 <= len(a.gen_tokens) <= 16
    assert isinstance(a.generated, str)
    assert a.ttft_measured_s > 0
    batch = mobile.answer_batch(
        [e.question for e in corpus.examples[:2]], generate=True)
    assert all(x.gen_tokens for x in batch)
    assert all(x.ttft_measured_s > 0 for x in batch)
