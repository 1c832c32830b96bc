"""The port's retrieval modules against the JAX package on the CPU: the
embedder and tokenizer (identical ids and vectors), k-means (same
assignments, centroids within 1e-5), the EcoVector pack (identical data,
lens and slot ids after a fresh build), the fused device search (same
ids, dists within 2e-5), the window index pack (identical) and batched
SCR (identical results and prompts; scores within 2e-5). The pack stays
identical after one insert and one delete."""
import numpy as np
import pytest

from repro.core.ecovector import EcoVector as JEcoVector
from repro.core.kmeans import kmeans as j_kmeans
from repro.core.scr import apply_scr_batch as j_apply_scr_batch
from repro.core.scr import build_prompt as j_build_prompt
from repro.core.window_index import WindowIndex as JWindowIndex
from repro.data.synthetic import make_qa_corpus as j_make_qa_corpus
from repro.data.tokenizer import HashTokenizer as JHashTokenizer
from repro.serving.embedder import HashEmbedder as JHashEmbedder
from repro_torch.core.ecovector import EcoVector
from repro_torch.core.kmeans import kmeans
from repro_torch.core.scr import apply_scr_batch, build_prompt
from repro_torch.core.window_index import WindowIndex
from repro_torch.data.synthetic import make_qa_corpus
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.serving.embedder import HashEmbedder


def word_corpus(n_docs, seed, sentences=12, words=7):
    """Docs of random-word sentences. Unlike the synthetic QA corpus,
    which repeats eight filler sentences, no two windows share a bag of
    words, so no SCR choice hinges on float rounding (with repeated bags
    the vectors differ by an ulp and each package's f32 sum order picks
    the window)."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(400)]
    return [" ".join(" ".join(rng.choice(vocab, words)).capitalize() + "."
                     for _ in range(sentences)) for _ in range(n_docs)]


@pytest.fixture(scope="module")
def corpus():
    c = make_qa_corpus(n_docs=160, n_questions=8, seed=3)
    jc = j_make_qa_corpus("squad", n_docs=160, n_questions=8, seed=3)
    assert c.docs == jc.docs
    assert [e.question for e in c.examples] == \
        [e.question for e in jc.examples]
    emb = HashEmbedder(dim=64).fit(c.docs)
    jemb = JHashEmbedder(dim=64).fit(c.docs)
    return c, emb, jemb


def test_tokenizer_and_embedder_identical(corpus):
    c, emb, jemb = corpus
    text = c.docs[0] + " " + c.examples[0].question
    assert HashTokenizer(512).encode(text) == JHashTokenizer(512).encode(text)
    np.testing.assert_array_equal(emb(c.docs[:20]), jemb(c.docs[:20]))


@pytest.mark.parametrize("n,d,k,iters", [(300, 16, 8, 10), (257, 32, 5, 10),
                                          (300, 16, 8, 8)])
def test_kmeans_matches_reference(n, d, k, iters):
    x = np.random.default_rng(n).standard_normal((n, d)).astype(np.float32)
    cent, assign = kmeans(x, k, iters, seed=1, device="cpu")
    jcent, jassign = j_kmeans(x, k, iters, seed=1)
    np.testing.assert_array_equal(assign, jassign)
    np.testing.assert_allclose(cent, jcent, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def indexes(corpus):
    c, emb, jemb = corpus
    vecs = emb(c.docs)
    ev = EcoVector(64, n_clusters=8, device="cpu").build(vecs)
    jev = JEcoVector(64, n_clusters=8).build(jemb(c.docs))
    return ev, jev


def test_ecovector_pack_identical(indexes):
    ev, jev = indexes
    data, lens, slot_ids, cap = ev.device_pack()
    jdata, jlens, jslot_ids, jcap = jev.device_pack()
    assert cap == jcap
    np.testing.assert_array_equal(lens, jlens)
    np.testing.assert_array_equal(slot_ids, jslot_ids)
    np.testing.assert_array_equal(data, jdata)
    vec = data[0, 0] + np.float32(0.01)
    for index in (ev, jev):
        index.insert(10_000, vec)
        index.delete(int(slot_ids[1, 0]))
    data, lens, slot_ids, cap = ev.device_pack()
    jdata, jlens, jslot_ids, jcap = jev.device_pack()
    assert cap == jcap and ev.stats.pack_cluster_repacks == 2
    assert 10_000 in slot_ids and jev.stats.pack_cluster_repacks == 2
    np.testing.assert_array_equal(lens, jlens)
    np.testing.assert_array_equal(slot_ids, jslot_ids)
    np.testing.assert_array_equal(data, jdata)


@pytest.mark.parametrize("n_probe,k", [(2, 3), (4, 10)])
def test_search_device_batched_matches_reference(corpus, indexes, n_probe, k):
    c, emb, _ = corpus
    ev, jev = indexes
    qv = emb([e.question for e in c.examples] + c.docs[:4])
    ids, dists = ev.search_device_batched(qv, k=k, n_probe=n_probe)
    jids, jdists = jev.search_device_batched(qv, k=k, n_probe=n_probe,
                                             use_pallas=True)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(dists, jdists, rtol=2e-5, atol=2e-5)


def test_window_index_and_scr_batch_match_reference():
    docs = word_corpus(120, seed=5)
    emb = HashEmbedder(dim=64).fit(docs)
    jemb = JHashEmbedder(dim=64).fit(docs)
    wi = WindowIndex(emb, device="cpu").build(docs)
    jwi = JWindowIndex(jemb).build(docs)
    data, lens = wi.pack()
    jdata, jlens = jwi.pack()
    np.testing.assert_array_equal(lens, jlens)
    np.testing.assert_array_equal(data, jdata)
    rng = np.random.default_rng(6)
    queries = [docs[i].split(". ")[3] for i in range(0, 48, 6)]
    ids = [list(rng.choice(len(docs), 3, replace=False)) for _ in queries]
    ids[1] = ids[1][:1]                       # a ragged row pads with -1
    res = apply_scr_batch(queries, ids, wi, emb)
    jres = j_apply_scr_batch(queries, ids, jwi, jemb, use_pallas=True)
    for q, r, jr in zip(queries, res, jres):
        assert (r.texts, r.order, r.spans, r.tokens_before, r.tokens_after) \
            == (jr.texts, jr.order, jr.spans, jr.tokens_before,
                jr.tokens_after)
        np.testing.assert_allclose(r.scores, jr.scores, rtol=2e-5, atol=2e-5)
        assert build_prompt(q, r) == j_build_prompt(q, jr)
