"""The paper's embedding model on the CPU, the port against the JAX
package: gte-small's config, its parameter layout (tied embeddings, a
GELU FFN without w3), the GELU MLP (jax.nn.gelu's tanh approximation),
non-causal attention, `DenseLM.encode` and `ModelEmbedder` on reduced
gte-small (weights carried across by `params_from_reference`) within
1e-5 in float32 and 2e-2 in bf16 over right-padded batches,
`HashTokenizer.encode_batch`, and a MobileRAG and an EdgeRAG built on
the model embedder retrieving the reference's documents."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.synthetic import make_qa_corpus as j_make_qa_corpus
from repro.data.tokenizer import HashTokenizer as JHashTokenizer
from repro.models import layers as jL
from repro.models import model as jmodel
from repro.serving import rag as jrag
from repro.serving.embedder import ModelEmbedder as JModelEmbedder
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_reference
from repro_torch.data.synthetic import make_qa_corpus
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models.dense import DenseLM, param_shapes
from repro_torch.models.model import supports_paged
from repro_torch.serving import rag
from repro_torch.serving.embedder import ModelEmbedder

TEXTS = ["The quick brown fox jumps over the lazy dog.", "a", "",
         " ".join(f"word{i}" for i in range(40)),
         "Who founded the city of Qarth, and when?"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(dtype, max_len=16):
    jcfg = j_get_config("gte_small").reduced(dtype=dtype)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    cfg = get_config("gte_small").reduced(dtype=dtype)
    params = params_from_reference(jax.tree.map(np.asarray, jparams), "cpu")
    return (ModelEmbedder(cfg, params=params, max_len=max_len,
                          device="cpu"),
            JModelEmbedder(jcfg, jparams, JHashTokenizer(jcfg.vocab_size),
                           max_len=max_len), jcfg, jparams)


@pytest.fixture(scope="module")
def f32():
    return _pair("float32")


def test_gte_config_matches_reference():
    assert "gte_small" in ARCH_IDS
    cfg, jcfg = get_config("gte_small"), j_get_config("gte_small")
    for f in dataclasses.fields(cfg):
        if hasattr(jcfg, f.name) and f.name not in ("moe",):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    r = cfg.reduced()
    assert (r.num_layers, r.d_model, r.num_heads, r.num_kv_heads,
            r.head_dim) == (2, 128, 4, 2, 32)
    assert (r.act, r.causal, r.tie_embeddings) == ("gelu", False, True)
    assert not supports_paged(cfg) and supports_paged(
        get_config("qwen25_0_5b"))


@pytest.mark.parametrize("arch", ["gte_small", "qwen25_0_5b"])
def test_param_layout_matches_reference(arch):
    jcfg = j_get_config(arch).reduced()
    tree = jmodel.param_shapes(jcfg)
    want = {k: tuple(v.shape) for k, v in tree["layers"].items()}
    want.update({k: tuple(v.shape) for k, v in tree.items()
                 if k != "layers"})
    got = {k: s for k, (s, _) in param_shapes(
        get_config(arch).reduced()).items()}
    assert got == want
    assert ("w3" in got) == (arch != "gte_small")


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(0)
    x, w1, w3 = (rng.normal(size=s).astype(np.float32)
                 for s in ((3, 5, 16), (16, 24), (16, 24)))
    w2 = rng.normal(size=(24, 16)).astype(np.float32)
    want = jL.mlp(*(jnp.asarray(a) for a in (x, w1, w2, w3)), act)
    got = L.mlp(*(torch.tensor(a) for a in (x, w1, w2, w3)), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError):
        L.mlp(*(torch.tensor(a) for a in (x, w1, w2, w3)), "relu")


def test_noncausal_attention_matches_reference():
    """The plain flash_prefill without the causal mask, GQA, against the
    reference's `layers.attention(causal=False)`."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 16, 2, 32)).astype(np.float32)
            for _ in range(2))
    want = jL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=False)
    got = ref.flash_prefill(*(torch.tensor(a) for a in (q, k, v)),
                            causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_embedder_matches_reference(dtype, f32):
    """Right-padded batches (an empty text, one past max_len): the port's
    vectors within 1e-5 of the reference's in f32, 2e-2 in bf16 (the
    reference pools in bf16 before its f32 cast, in XLA's sum order)."""
    emb, jemb, _, _ = f32 if dtype == "float32" else _pair(dtype)
    got, want = emb(TEXTS), jemb(TEXTS)
    assert got.dtype == np.float32 and got.shape == (len(TEXTS), emb.dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])
    norms = np.linalg.norm(got, axis=1)
    np.testing.assert_allclose(norms[[0, 1, 3, 4]], 1.0, atol=1e-3)
    assert norms[2] == 0.0                       # empty text: no tokens


def test_encode_attends_padding_and_pools_over_mask(f32):
    """`encode` equals the reference's `model.encode` with and without a
    mask; padding keys are attended (a row's vector depends on max_len
    even though the mask hides the pads from the pooling)."""
    emb, _, jcfg, jparams = f32
    toks = emb.tok.encode_batch(TEXTS[:2], 12)
    mask = (toks != 0).astype(np.float32)
    for m in (mask, None):
        batch = {"tokens": jnp.asarray(toks)}
        if m is not None:
            batch["mask"] = jnp.asarray(m)
        want = np.asarray(jmodel.encode(jcfg, jparams, batch))
        got = emb.model.encode(torch.tensor(toks, dtype=torch.long),
                               None if m is None else torch.tensor(m))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    long = emb.model.encode(torch.tensor(emb.tok.encode_batch(TEXTS[:1], 20),
                                         dtype=torch.long),
                            torch.tensor(emb.tok.encode_batch(TEXTS[:1], 20)
                                         ) != 0)
    assert not torch.allclose(long[0], emb.model.encode(
        torch.tensor(toks[:1], dtype=torch.long), torch.tensor(mask[:1]))[0])


def test_batches_of_fixed_size_agree(f32):
    emb = f32[0]
    texts = TEXTS * 3
    whole = emb(texts)
    emb.BATCH = 4
    try:
        np.testing.assert_allclose(emb(texts), whole, rtol=0, atol=1e-6)
    finally:
        del emb.BATCH
    assert emb([]).shape == (0, emb.dim)


def test_encode_batch_matches_reference():
    tok, jtok = HashTokenizer(512), JHashTokenizer(512)
    for max_len in (1, 6, 16):
        got = tok.encode_batch(TEXTS, max_len)
        assert got.dtype == np.int32 and got.shape == (len(TEXTS), max_len)
        np.testing.assert_array_equal(got, jtok.encode_batch(TEXTS, max_len))
    same = ["one two three", "four five six"]
    np.testing.assert_array_equal(tok.encode_batch(same, 8, pad=False),
                                  jtok.encode_batch(same, 8, pad=False))


def test_embedder_default_weights_and_device_rule():
    cfg = get_config("gte_small").reduced(dtype="float32")
    a = ModelEmbedder(cfg, seed=1, device="cpu")
    b = ModelEmbedder(cfg, seed=1, device="cpu")
    np.testing.assert_array_equal(a(TEXTS), b(TEXTS))
    assert isinstance(a.model, DenseLM) and a.dim == 128
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ModelEmbedder(cfg)


@pytest.mark.parametrize("name", ["mobile", "edge"])
def test_pipelines_on_model_embedder_match_reference(f32, name):
    """MobileRAG (EcoVector, window index, SCR) and EdgeRAG (IVF-DISK) on
    the model embedder retrieve the reference's documents."""
    emb, jemb, _, _ = f32
    c = make_qa_corpus(n_docs=70, n_questions=8, seed=2)
    assert c.docs == j_make_qa_corpus("squad", n_docs=70, n_questions=8,
                                      seed=2).docs
    qs = [e.question for e in c.examples]
    if name == "mobile":
        pipe = rag.MobileRAG(c.docs, emb, top_k=3, device="cpu")
        jpipe = jrag.MobileRAG(c.docs, jemb, top_k=3, device_retrieval=True)
        assert pipe.window_index.pack()[0].shape[-1] == emb.dim
    else:
        pipe = rag.EdgeRAG(c.docs, emb, top_k=3, device="cpu")
        jpipe = jrag.EdgeRAG(c.docs, jemb, top_k=3)
    for a, b in zip(pipe.answer_batch(qs), jpipe.answer_batch(qs)):
        assert sorted(a.doc_ids) == sorted(b.doc_ids)
        assert a.prompt_tokens > 0
