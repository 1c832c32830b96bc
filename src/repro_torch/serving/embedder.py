"""Embedding backends of the RAG pipelines (the port of
`repro.serving.embedder`).

HashEmbedder: deterministic hashed bag-of-words + fixed random projection,
unit-norm (same vectors as the reference's from the same seed and texts).
ModelEmbedder: the gte-small bidirectional encoder (mean-pooled,
unit-norm), the paper's embedding model, on `DenseLM.encode`: its
attention is `flash_prefill` with `causal=False`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.dense import DenseLM


class HashEmbedder:
    VOCAB = 32768
    SEED = 0

    def __init__(self, dim: int = 384):
        self.dim = dim
        self.tok = HashTokenizer(self.VOCAB)
        rng = np.random.default_rng(self.SEED)
        self.proj = rng.normal(0, 1 / np.sqrt(dim),
                               (self.VOCAB, dim)).astype(np.float32)
        self.idf = np.ones(self.VOCAB, np.float32)
        self.fitted = False

    def fit(self, texts: List[str]) -> "HashEmbedder":
        df = np.zeros(self.VOCAB, np.float32)
        for t in texts:
            for i in set(self.tok.encode(t)):
                df[i] += 1
        n = max(len(texts), 1)
        self.idf = np.log((n + 1) / (df + 1)) + 1.0
        self.fitted = True
        return self

    def __call__(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            ids = self.tok.encode(t)
            if ids:
                ids = np.asarray(ids)
                v = (self.proj[ids] * self.idf[ids][:, None]).sum(0)
                n = np.linalg.norm(v)
                out[i] = v / n if n > 0 else v
        return out


class ModelEmbedder:
    """Texts -> the encoder's unit-norm embeddings, np.float32 [n, d].
    Each text is tokenized to its first `max_len` ids, right-padded
    (`HashTokenizer.encode_batch`; the mask marks real tokens), and the
    texts go through the model BATCH at a time. `params` (the
    `DenseLM` layout, e.g. `convert.params_from_reference` of a gte
    tree) loads given weights; without it they are random from
    `seed`."""

    BATCH = 256

    def __init__(self, cfg: ModelConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 tokenizer: Optional[HashTokenizer] = None,
                 max_len: int = 64, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.model = DenseLM(cfg, device=device, seed=seed, params=params)
        self.tok = tokenizer or HashTokenizer(cfg.vocab_size)
        self.max_len = max_len

    @property
    def dim(self) -> int:
        return self.cfg.d_model

    def __call__(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        dev = self.model.device
        for s in range(0, len(texts), self.BATCH):
            toks = torch.from_numpy(self.tok.encode_batch(
                texts[s:s + self.BATCH], self.max_len)).to(dev)
            vecs = self.model.encode(toks.long(), toks != self.tok.pad_id)
            out[s:s + len(toks)] = vecs.cpu().numpy()
        return out
