"""Deterministic offline tokenizer: word-level md5 hashing with an
incremental id->word table for detokenisation of seen vocabulary (the
port's own copy of `repro.data.tokenizer`; same ids for the same text)."""
from __future__ import annotations

import hashlib
import re
from typing import Dict, Iterable, List

import numpy as np

_WORD_RE = re.compile(r"\w+|[^\w\s]")


class HashTokenizer:
    def __init__(self, vocab_size: int = 32000, reserved: int = 4):
        self.vocab_size = vocab_size
        self.reserved = reserved  # 0 pad, 1 bos, 2 eos, 3 unk
        self.pad_id, self.bos_id, self.eos_id, self.unk_id = 0, 1, 2, 3
        self.id_to_word: dict[int, str] = {}
        # word -> id memo: the hash is a pure function of the word, so the
        # memo changes no id; it saves the md5 on every repeated word
        self._ids: Dict[str, int] = {}

    def _hash(self, w: str) -> int:
        i = self._ids.get(w)
        if i is None:
            h = int.from_bytes(hashlib.md5(w.lower().encode()).digest()[:4],
                               "little")
            i = self._ids[w] = self.reserved + h % (self.vocab_size
                                                    - self.reserved)
        return i

    def encode(self, text: str, *, bos: bool = False,
               eos: bool = False) -> List[int]:
        """The ids of text's words and punctuation, after bos_id and
        before eos_id when asked."""
        ids = [self.bos_id] if bos else []
        for w in _WORD_RE.findall(text):
            i = self._hash(w)
            self.id_to_word.setdefault(i, w)
            ids.append(i)
        if eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        out = []
        for i in map(int, ids):
            if i < self.reserved:
                continue
            out.append(self.id_to_word.get(i, f"<{i}>"))
        return " ".join(out)

    def encode_batch(self, texts: List[str], max_len: int,
                     pad: bool = True) -> np.ndarray:
        """int32 ids [len(texts), max_len]: each text's first max_len ids,
        right-padded with pad_id (`pad=False`: unpadded rows)."""
        rows = []
        for t in texts:
            ids = self.encode(t)[:max_len]
            if pad:
                ids = ids + [self.pad_id] * (max_len - len(ids))
            rows.append(ids)
        return np.asarray(rows, np.int32)
