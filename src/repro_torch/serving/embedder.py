"""HashEmbedder: deterministic hashed bag-of-words + fixed random
projection, unit-norm (the port's copy of `repro.serving.embedder`'s;
same vectors from the same seed and texts)."""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.tokenizer import HashTokenizer


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
