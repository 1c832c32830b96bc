"""Corpus-resident SCR window index (the build and pack of
`repro.core.window_index`).

Every document is split into sentences, windowed (`SCRConfig` geometry)
and embedded once at build time; the window embeddings are packed into a
padded [ND, CAPW, d] block per document with `lens[ND]` valid counts, and
a device copy feeds the `scr_select` kernel. Updates, save/load and the
WAL are not ported yet.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.scr import SCRConfig, sliding_windows, split_sentences


class WindowIndex:
    MIN_CAPW = 8                 # same floor as the EcoVector pack

    def __init__(self, embed: Callable, cfg: SCRConfig = SCRConfig(),
                 device="cuda"):
        self.embed = embed
        self.cfg = cfg
        self.device = resolve_device(device)
        self.texts: List[str] = []
        self.sents: List[List[str]] = []
        self.spans: List[List[Tuple[int, int]]] = []
        self.ntok: List[int] = []            # whitespace tokens per doc
        self._data: Optional[np.ndarray] = None    # [ND, CAPW, d]
        self._lens: Optional[np.ndarray] = None    # [ND] i32
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def __len__(self) -> int:
        return len(self.texts)

    def build(self, docs: Sequence[str]) -> "WindowIndex":
        """Split/window/embed the whole corpus in one batched embed call
        and build the block pack and its device copy."""
        self.texts = list(docs)
        self.sents = [split_sentences(t) for t in self.texts]
        self.spans = [sliding_windows(s, self.cfg.sliding_window_size,
                                      self.cfg.overlap_size)
                      for s in self.sents]
        self.ntok = [len(t.split()) for t in self.texts]
        win_texts, owners = [], []
        for di, (sents, spans) in enumerate(zip(self.sents, self.spans)):
            win_texts.extend(" ".join(sents[a:b]) for a, b in spans)
            owners.extend([di] * len(spans))
        dim = getattr(self.embed, "dim", None)
        vecs = (np.asarray(self.embed(win_texts), np.float32) if win_texts
                else np.zeros((0, dim or 1), np.float32))
        d = dim or (vecs.shape[1] if vecs.size else 1)
        nd = len(self.texts)
        capw = max(self.MIN_CAPW, max((len(s) for s in self.spans),
                                      default=0))
        self._data = np.zeros((nd, capw, d), np.float32)
        self._lens = np.asarray([len(s) for s in self.spans],
                                np.int32).reshape(nd)
        owners = np.asarray(owners, np.int64)
        # window w of doc di is the w-th of its owner's run in `owners`
        starts = np.concatenate(([0], np.cumsum(self._lens)))[:-1]
        slot = np.arange(len(owners)) - starts[owners] if len(owners) else \
            np.zeros(0, np.int64)
        self._data[owners, slot] = vecs
        # device copy (never an alias of the host pack)
        self._dev = (torch.tensor(self._data, device=self.device),
                     torch.tensor(self._lens, device=self.device))
        return self

    def pack(self) -> Tuple[np.ndarray, np.ndarray]:
        """The host (data [ND, CAPW, d], lens [ND]) pack."""
        return self._data, self._lens

    def device_arrays(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pack on the index's device."""
        return self._dev
