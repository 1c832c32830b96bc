"""The legacy per-query SCR path on the CPU against the JAX package:
`apply_scr` (identical texts, order, spans and token counts; scores
within 1e-5, the kernels summing in another order), and the port's
`MobileRAG(use_window_index=False)` against the JAX one, with
`answer_batch(generate=False)` and `generate=True` (same doc ids,
byte-identical prompts, identical greedy tokens on float32 reduced
qwen2.5-0.5B weights carried across with `params_from_reference`). Its
prompts also equal the window-index pipeline's, as the reference's
tests/test_window_index.py asserts for the reference.

The documents are hand-written (with an empty and a one-sentence
document) or random-word sentences, so no SCR choice hinges on float
rounding (see tests/test_torch_e2e.py)."""
import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.core.scr import SCRConfig as JSCRConfig
from repro.core.scr import apply_scr as j_apply_scr
from repro.core.scr import segment_best_windows as j_segment_best_windows
from repro.data.tokenizer import HashTokenizer as JHashTokenizer
from repro.models import model as jmodel
from repro.serving.embedder import HashEmbedder as JHashEmbedder
from repro.serving.engine import Engine as JEngine
from repro.serving.rag import MobileRAG as JMobileRAG
from repro.serving.slm import ReducedSLM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_reference
from repro_torch.core.scr import SCRConfig, apply_scr, segment_best_windows
from repro_torch.serving.embedder import HashEmbedder
from repro_torch.serving.rag import MobileRAG

DOCS = [
    ("Volcanoes are studied by geologists. "
     "Their eruptions follow magma pressure. "
     "Monitoring stations track seismic activity. "
     "Lava flows reshape the landscape."),
    ("The Tiramisu dessert originated in Italy. "
     "An interesting historical note about Tiramisu follows. "
     "Recipe of the Tiramisu includes cheese and coffee. "
     "The price of a single slice of Tiramisu can vary. "
     "Many cafes now offer Tiramisu for pick-up."),
    "One single sentence about astronomy.",
    "",
    ("Quantum computers use qubits. "
     "Error correction is the central challenge."),
]


def word_corpus(n_docs, seed, sentences=12, words=7):
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    return [" ".join(" ".join(rng.choice(vocab, words)).capitalize() + "."
                     for _ in range(sentences)) for _ in range(n_docs)]


def assert_same_scr(out, ref):
    assert out.order == ref.order
    assert out.spans == ref.spans
    assert out.texts == ref.texts
    assert out.tokens_before == ref.tokens_before
    assert out.tokens_after == ref.tokens_after
    np.testing.assert_allclose(out.scores, ref.scores, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def embedders():
    docs = [d for d in DOCS if d]
    return HashEmbedder(dim=64).fit(docs), JHashEmbedder(dim=64).fit(docs)


@pytest.mark.parametrize("doc_ids", [
    [0, 1], [1, 0, 4], [2], [3], [3, 2], [0, 1, 2, 3, 4], [],
])
def test_apply_scr_matches_reference(embedders, doc_ids):
    emb, jemb = embedders
    q = "Show me the dessert recipe from recent downloads."
    docs = [DOCS[i] for i in doc_ids]
    out = apply_scr(q, docs, emb, SCRConfig(3, 2, 1), device="cpu")
    assert_same_scr(out, j_apply_scr(q, docs, jemb, JSCRConfig(3, 2, 1)))


@pytest.mark.parametrize("window,overlap,ext", [(3, 2, 1), (2, 0, 2)])
def test_apply_scr_random_words(window, overlap, ext):
    docs = word_corpus(6, seed=window)
    q = docs[2].split(". ")[5]
    emb, jemb = HashEmbedder(dim=64), JHashEmbedder(dim=64)
    out = apply_scr(q, docs, emb, SCRConfig(window, overlap, ext),
                    device="cpu")
    ref = j_apply_scr(q, docs, jemb, JSCRConfig(window, overlap, ext))
    assert_same_scr(out, ref)
    assert out.order[0] == 2


def test_segment_best_windows_matches_reference():
    r = np.random.default_rng(4)
    scores = r.integers(0, 4, 40).astype(np.float32)     # many exact ties
    owners = np.sort(r.integers(0, 7, 40))
    best, counts = segment_best_windows(scores, owners, 9)
    jbest, jcounts = j_segment_best_windows(scores, owners, 9)
    np.testing.assert_array_equal(counts, jcounts)
    has = counts > 0
    np.testing.assert_array_equal(best[has], jbest[has])


@pytest.fixture(scope="module")
def pipelines():
    docs = word_corpus(200, seed=11)
    queries = [docs[i].split(". ")[2 + i % 5] for i in range(3, 200, 33)]
    jcfg = j_get_config("qwen25_0_5b").reduced(dtype="float32")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jpipe = JMobileRAG(docs, JHashEmbedder(dim=64), device_retrieval=True,
                       top_k=3, use_window_index=False)
    slm = ReducedSLM()
    slm._engine = JEngine(jcfg, jparams, max_len=slm.max_prompt + slm.max_new,
                          page_size=slm.page_size)
    slm._tok = JHashTokenizer(jcfg.vocab_size)
    jpipe._slm_engine = slm
    cfg = get_config("qwen25_0_5b").reduced(dtype="float32")
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    pipe = MobileRAG(docs, HashEmbedder(dim=64), top_k=3, gen_config=cfg,
                     gen_params=params, use_window_index=False, device="cpu")
    windowed = MobileRAG(docs, HashEmbedder(dim=64), top_k=3, gen_config=cfg,
                         device="cpu")
    return queries, pipe, jpipe, windowed


def test_legacy_pipeline_builds_no_window_index(pipelines):
    _, pipe, jpipe, windowed = pipelines
    assert pipe.window_index is None and jpipe.window_index is None
    assert windowed.window_index is not None


def test_legacy_answer_batch_matches_reference(pipelines):
    queries, pipe, jpipe, windowed = pipelines
    ans = pipe.answer_batch(queries)
    jans = jpipe.answer_batch(queries)
    wans = windowed.answer_batch(queries)
    assert len(ans) == len(jans) == 6
    for a, ja, wa in zip(ans, jans, wans):
        assert a.doc_ids == ja.doc_ids == wa.doc_ids
        assert a.prompt == ja.prompt == wa.prompt
        assert a.prompt_tokens == ja.prompt_tokens
        assert_same_scr(a.scr, ja.scr)
        assert a.post_s > 0


def test_legacy_generate_matches_reference(pipelines):
    queries, pipe, jpipe, _ = pipelines
    ans = pipe.answer_batch(queries, generate=True, max_new=8)
    jans = jpipe.answer_batch(queries, generate=True, max_new=8)
    assert len(ans) == len(jans) == 6
    for a, ja in zip(ans, jans):
        assert a.doc_ids == ja.doc_ids
        assert a.prompt == ja.prompt
        assert a.gen_tokens == ja.gen_tokens and len(a.gen_tokens) >= 1
