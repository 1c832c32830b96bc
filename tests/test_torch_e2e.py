"""The slice end to end on the CPU: the port's MobileRAG
`answer_batch(generate=True)` against the JAX package's on the same
documents, queries and float32 reduced qwen2.5-0.5B weights. Required:
the same doc ids, byte-identical prompts and identical greedy tokens,
with prefix-cache hits and COW forks on both sides (every prompt shares
the "Context:" head, and one query repeats).

The documents are random-word sentences: the synthetic QA corpus repeats
eight filler sentences, so many SCR windows share a bag of words and
score one ulp apart, and each package's f32 sum order would pick among
them (tests/test_torch_retrieval.py holds the QA corpus's retrieval to
the reference)."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.data.tokenizer import HashTokenizer as JHashTokenizer
from repro.models import model as jmodel
from repro.serving.embedder import HashEmbedder as JHashEmbedder
from repro.serving.engine import Engine as JEngine
from repro.serving.rag import MobileRAG as JMobileRAG
from repro.serving.slm import ReducedSLM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.serving.embedder import HashEmbedder
from repro_torch.serving.rag import MobileRAG


def word_corpus(n_docs, seed, sentences=12, words=7):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    return [" ".join(" ".join(rng.choice(vocab, words)).capitalize() + "."
                     for _ in range(sentences)) for _ in range(n_docs)]


@pytest.fixture(scope="module")
def answers():
    docs = word_corpus(200, seed=11)
    queries = [docs[i].split(". ")[2 + i % 5] for i in range(3, 200, 33)]
    queries.append(queries[0])                 # same prompt: full-page hit
    jcfg = j_get_config("qwen25_0_5b").reduced(dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jpipe = JMobileRAG(docs, JHashEmbedder(dim=64), device_retrieval=True,
                       top_k=3)
    slm = ReducedSLM()
    slm._engine = JEngine(jcfg, jparams, max_len=slm.max_prompt + slm.max_new,
                          page_size=slm.page_size)
    slm._tok = JHashTokenizer(jcfg.vocab_size)
    jpipe._slm_engine = slm
    jans = jpipe.answer_batch(queries, generate=True, max_new=8)
    cfg = get_config("qwen25_0_5b").reduced(dtype="float32")
    pipe = MobileRAG(docs, HashEmbedder(dim=64), top_k=3, gen_config=cfg,
                     gen_params=params_from_reference(
                         jax.tree.map(np.asarray, jparams), "cpu"),
                     device="cpu")
    ans = pipe.answer_batch(queries, generate=True, max_new=8)
    return (ans, pipe.slm.engine, jans,
            slm._engine.continuous(4))


def test_same_docs_prompts_and_tokens(answers):
    ans, _, jans, _ = answers
    assert len(ans) == len(jans) == 7
    for a, ja in zip(ans, jans):
        assert a.doc_ids == ja.doc_ids
        assert a.prompt == ja.prompt
        assert a.gen_tokens == ja.gen_tokens and len(a.gen_tokens) >= 1


def test_prefix_cache_and_cow_match(answers):
    _, eng, _, jeng = answers
    assert eng.prefix_hits == jeng.prefix_hits >= 2
    assert eng.prefix_tokens_reused == jeng.prefix_tokens_reused
    assert eng.steps == jeng.steps
