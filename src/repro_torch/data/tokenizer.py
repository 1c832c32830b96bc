"""Deterministic offline tokenizer: word-level md5 hashing with an
incremental id->word table for detokenisation of seen vocabulary (the
port's own copy of `repro.data.tokenizer`; same ids for the same text)."""
from __future__ import annotations

import hashlib
import re
from typing import Dict, Iterable, List

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

    def encode(self, text: str) -> List[int]:
        ids = []
        for w in _WORD_RE.findall(text):
            i = self._hash(w)
            self.id_to_word.setdefault(i, w)
            ids.append(i)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        out = []
        for i in map(int, ids):
            if i < self.reserved:
                continue
            out.append(self.id_to_word.get(i, f"<{i}>"))
        return " ".join(out)
