"""Window-index updates in the port against the JAX package on the CPU.

After the same `add` / `update` / `remove` sequences the port's
`WindowIndex` holds the reference's pack (shape and bytes), lens and
`WindowIndexStats` (field for field; the port's device-copy counters
`mirror_uploads` / `mirror_rows` come on top), and `apply_scr_batch`
gives the reference's orders, spans, texts and token counts, scores
within 1e-5. The device copy is refreshed by rows: inside the pack's
shape only the dirty rows are copied into the same storage; a growth
uploads the pack whole. Then the reference's appended-document scenario
(tests/test_system.py) on both packages' MobileRAG: the same doc ids and
prompt, no IndexError."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.scr import SCRConfig as JSCRConfig
from repro.core.scr import apply_scr_batch as j_apply_scr_batch
from repro.core.window_index import WindowIndex as JWindowIndex
from repro.data.synthetic import make_qa_corpus as j_make_qa_corpus
from repro.serving.embedder import HashEmbedder as JHashEmbedder
from repro.serving.rag import MobileRAG as JMobileRAG
from repro_torch.core.scr import SCRConfig, apply_scr_batch
from repro_torch.core.window_index import WindowIndex
from repro_torch.data.synthetic import make_qa_corpus
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
GEOM = (3, 2, 1)


class Pair:
    """The same window index in both packages, driven together."""

    def __init__(self, docs, geom=GEOM, dim=64, fit=None):
        fit = [d for d in docs if d] if fit is None else fit
        self.emb = HashEmbedder(dim=dim).fit(fit)
        self.jemb = JHashEmbedder(dim=dim).fit(fit)
        self.w = WindowIndex(self.emb, SCRConfig(*geom),
                             device="cpu").build(docs)
        self.jw = JWindowIndex(self.jemb, JSCRConfig(*geom)).build(docs)

    def op(self, name, *args):
        got = getattr(self.w, name)(*args)
        assert got == getattr(self.jw, name)(*args)
        assert self.w._dirty == self.jw._dirty
        return got

    def refresh(self):
        """Both device copies refreshed; the port's tensors."""
        self.jw.device_arrays()
        return self.w.device_arrays()

    def same(self):
        """Pack, lens and every reference stats field equal."""
        data, lens = self.w.pack()
        jdata, jlens = self.jw.pack()
        assert data.shape == jdata.shape and data.dtype == jdata.dtype
        assert data.tobytes() == jdata.tobytes()
        assert lens.tobytes() == jlens.tobytes()
        for f in dataclasses.fields(self.jw.stats):
            assert getattr(self.w.stats, f.name) == \
                getattr(self.jw.stats, f.name), f.name
        return data, lens

    def scr(self, queries, ids):
        got = apply_scr_batch(queries, ids, self.w, self.emb)
        want = j_apply_scr_batch(queries, ids, self.jw, self.jemb)
        for a, b in zip(got, want):
            assert (a.order, a.spans, a.texts) == (b.order, b.spans, b.texts)
            assert (a.tokens_before, a.tokens_after) == \
                (b.tokens_before, b.tokens_after)
            np.testing.assert_allclose(a.scores, b.scores, rtol=1e-5,
                                       atol=1e-5)
        self.same()
        return got


def test_update_marks_only_owning_block_dirty():
    p = Pair(DOCS)
    p.op("update", 0, "Completely new text about sailing. Boats need wind.")
    assert p.w._dirty == {0}
    p.same()
    assert p.w.stats.block_repacks == 1 and p.w.stats.full_builds == 1
    out = p.scr(["wind and boats sailing"], [[0, 1]])[0]
    assert "sailing" in " ".join(out.texts) or "wind" in " ".join(out.texts)


def test_update_invalidates_stale_windows():
    p = Pair(DOCS)
    q = "Show me the dessert recipe."
    before = p.scr([q], [[1, 0]])[0]
    assert any("Recipe of the Tiramisu" in t for t in before.texts)
    p.op("update", 1, "Weather patterns shift with ocean currents.")
    after = p.scr([q], [[1, 0]])[0]
    assert not any("Tiramisu" in t for t in after.texts)


def test_add_and_remove_docs():
    p = Pair(DOCS)
    di = p.op("add", "Fresh document about gardening. Tomatoes need sun. "
                     "Water them daily.")
    assert di == len(DOCS)
    out = p.scr(["gardening tomatoes"], [[di]])[0]
    assert "Tomatoes" in " ".join(out.texts)
    p.op("remove", di)
    _, lens = p.same()
    assert lens[di] == 0
    assert p.w.stats.grows == 1


def test_capw_grows_geometrically():
    p = Pair(["Short. Doc."], geom=(1, 0, 0), fit=["Short. Doc."])
    capw0 = p.w.pack()[0].shape[1]
    long_doc = " ".join(f"Sentence number {i} talks about topic."
                        for i in range(capw0 * 3))
    p.op("update", 0, long_doc)
    data, lens = p.same()
    assert p.w.stats.grows == 1 and data.shape[1] == capw0 * 4
    assert lens[0] == capw0 * 3


def test_row_table_grows_on_add():
    p = Pair(["One doc. Two sentences."])
    nd0 = p.w.pack()[0].shape[0]
    for i in range(nd0 + 3):
        p.op("add", f"Additional doc {i}. It has sentences.")
    data, _ = p.same()
    assert data.shape[0] >= nd0 + 4 and p.w.stats.full_builds == 1


def test_placeholder_dim_rebuild():
    """A corpus with no window and an embedder without `dim`: the pack is
    built at a placeholder width, then rebuilt whole at the first
    window, as the reference does."""
    emb = HashEmbedder(dim=16)
    jemb = JHashEmbedder(dim=16)
    bare = lambda e: (lambda texts: e(texts))  # noqa: E731  (no .dim)
    p = Pair.__new__(Pair)
    p.emb, p.jemb = emb, jemb
    p.w = WindowIndex(bare(emb), SCRConfig(*GEOM), device="cpu").build(["",
                                                                        ""])
    p.jw = JWindowIndex(bare(jemb), JSCRConfig(*GEOM)).build(["", ""])
    assert p.w.pack()[0].shape == (2, 8, 1)
    p.op("update", 1, "Now there is text. And a second sentence.")
    data, _ = p.same()
    assert data.shape == (2, 8, 16) and p.w.stats.full_builds == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_update_sequences(seed):
    """Random adds (some past CAPW), updates and removes, with SCR
    batches between them: equal packs, stats and SCR output throughout,
    and the device copy equal to the host pack after every refresh."""
    rng = np.random.default_rng(seed)
    words = [f"t{i}" for i in range(60)]

    def doc(n_sent):
        return " ".join(" ".join(rng.choice(words, 5)).capitalize() + "."
                        for _ in range(n_sent))
    docs = [doc(int(rng.integers(0, 7))) for _ in range(12)]
    p = Pair(docs, fit=docs + [doc(4) for _ in range(8)])
    for _ in range(10):
        kind = rng.choice(["add", "update", "remove", "scr"])
        n = len(p.w)
        if kind == "add":
            p.op("add", doc(int(rng.integers(0, 14))))
        elif kind == "update":
            p.op("update", int(rng.integers(n)), doc(int(rng.integers(1, 9))))
        elif kind == "remove":
            p.op("remove", int(rng.integers(n)))
        else:
            ids = [list(rng.choice(n, 3, replace=False)) for _ in range(2)]
            p.scr([doc(1), doc(1)], ids)
            ddata, dlens = p.refresh()
            data, lens = p.w.pack()
            assert ddata.numpy().tobytes() == data.tobytes()
            assert dlens.numpy().tobytes() == lens.tobytes()
        p.same()


def test_device_copy_refreshes_dirty_rows_only():
    """Inside the pack's shape a refresh copies the dirty rows into the
    same storage (counted) and uploads lens; a growth uploads the pack
    whole once. The device tensors never alias the host pack."""
    p = Pair(DOCS)
    d0, l0 = p.refresh()
    assert p.w.stats.mirror_uploads == 1 and p.w.stats.mirror_rows == 0
    assert not np.shares_memory(d0.numpy(), p.w.pack()[0])
    ptr = d0.data_ptr()
    p.op("update", 2, "Replacement text. With two sentences.")
    p.op("remove", 4)
    d1, l1 = p.refresh()
    data, lens = p.same()
    assert d1.data_ptr() == ptr and p.w.stats.mirror_uploads == 1
    assert p.w.stats.mirror_rows == 2
    assert d1.numpy().tobytes() == data.tobytes()
    assert l1.numpy().tobytes() == lens.tobytes()
    assert int(l1[2]) == len(p.w.spans[2]) and int(l1[4]) == 0
    p.refresh()
    assert p.w.stats.mirror_rows == 2           # nothing dirty: no copy
    long_doc = " ".join(f"Sentence {i} here." for i in range(40))
    p.op("update", 0, long_doc)
    d2, _ = p.refresh()
    data, _ = p.same()
    assert p.w.stats.grows == 1 and p.w.stats.mirror_uploads == 2
    assert d2.shape == data.shape and d2.numpy().tobytes() == data.tobytes()
    # scr_select at the grown CAPW picks the long doc's windows
    p.scr(["Sentence 37 here."], [[0, 1, 2]])


def test_window_index_resident_bytes_and_dma_counters():
    """tests/test_tiered.py's accounting on both packages."""
    docs = [f"sentence {i} one. sentence {i} two. sentence {i} three."
            for i in range(6)]
    wi = WindowIndex(HashEmbedder(dim=32), SCRConfig(),
                     device="cpu").build(docs)
    jwi = JWindowIndex(JHashEmbedder(dim=32), JSCRConfig()).build(docs)
    before = wi.resident_bytes()
    assert before == jwi.resident_bytes() >= wi.ram_bytes()
    queries = ["sentence 1 one", "sentence 2 two"]
    doc_ids = [[0, 1, 2], [3, 4]]
    apply_scr_batch(queries, doc_ids, wi, HashEmbedder(dim=32))
    j_apply_scr_batch(queries, doc_ids, jwi, JHashEmbedder(dim=32))
    s = wi.stats
    assert (s.select_calls, s.select_queries, s.blocks_dma) == (1, 2, 5)
    assert s.last_query_dma_blocks == 2.5
    after = wi.resident_bytes()
    assert after == jwi.resident_bytes() > before
    for f in dataclasses.fields(jwi.stats):
        assert getattr(s, f.name) == getattr(jwi.stats, f.name), f.name


def test_appended_doc_answers_like_reference():
    """tests/test_system.py's update path: a doc appended to `docs` and
    inserted into the index is synced into the window index before SCR,
    retrieved, and condensed into the prompt, as in the reference."""
    corpus = make_qa_corpus(n_docs=150, n_questions=25, seed=1)
    jcorpus = j_make_qa_corpus("squad", n_docs=150, n_questions=25, seed=1)
    assert corpus.docs == jcorpus.docs
    emb, jemb = HashEmbedder(dim=128), JHashEmbedder(dim=128)
    pipe = MobileRAG(corpus.docs, emb, top_k=3, device="cpu")
    jpipe = JMobileRAG(jcorpus.docs, jemb, top_k=3)
    newdoc = "The zeppelin99 was first described in 1901. It flew far."
    new_id = len(corpus.docs)
    for m, e in ((pipe, emb), (jpipe, jemb)):
        m.docs.append(newdoc)
        m.index.insert(new_id, e([newdoc])[0])
    q = "What is known about the zeppelin99?"
    a = pipe.answer_batch([q])[0]
    ja = jpipe.answer_batch([q])[0]
    assert new_id in a.doc_ids and a.doc_ids == ja.doc_ids
    assert a.prompt == ja.prompt and "1901" in a.prompt
    assert len(pipe.window_index) == len(jpipe.window_index) == new_id + 1
    for f in dataclasses.fields(jpipe.window_index.stats):
        assert getattr(pipe.window_index.stats, f.name) == \
            getattr(jpipe.window_index.stats, f.name), f.name
    # an id past the synced index is still refused
    with pytest.raises(IndexError, match="outside"):
        apply_scr_batch([q], [[new_id + 1]], pipe.window_index, emb)
    assert torch.equal(pipe.window_index.device_arrays()[1],
                       torch.from_numpy(pipe.window_index.pack()[1]))
