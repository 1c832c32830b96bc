"""Corpus-resident SCR window index (the port of
`repro.core.window_index`, without its save/load and WAL).

Every document is split into sentences, windowed (`SCRConfig` geometry)
and embedded once at build time; the window embeddings are packed into a
padded [ND, CAPW, d] block per document with `lens[ND]` valid counts, and
a device copy feeds the `scr_select` kernel.

Updates follow the reference's dirty-block protocol: `add` / `update` /
`remove` change the host metadata and mark only the owning block dirty;
the next `pack()` embeds just the dirty documents (one batched embed
call) and rewrites their blocks in place, growing the rows and CAPW by
doubling on overflow. `device_arrays()` then copies only the rewritten
rows into the existing device tensors and uploads `lens`; it uploads the
whole pack only on first use and after a growth. Durability (`save`,
`load`, the journal) waits for the port of `core/store.py`'s journal, so
`stats.wal_replayed` stays 0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.scr import SCRConfig, sliding_windows, split_sentences


@dataclass
class WindowIndexStats:
    """The reference's counters, counted at the same points, then the
    port's device-copy counters."""
    full_builds: int = 0         # whole [ND, CAPW, d] pack builds
    block_repacks: int = 0       # single-doc block rewrites in place
    grows: int = 0               # doubling growths of rows / CAPW
    embed_calls: int = 0         # batched embed invocations
    windows_embedded: int = 0    # total window texts embedded
    wal_replayed: int = 0        # mutations replayed by a load (none yet)
    resident_bytes: int = 0      # host pack + device copy, last reading
    select_calls: int = 0        # scr_select batch invocations
    select_queries: int = 0      # query rows across those batches
    blocks_dma: int = 0          # (query, doc) blocks read by scr_select
    last_query_dma_blocks: float = 0.0   # blocks per query, last batch
    mirror_uploads: int = 0      # whole-pack uploads to the device
    mirror_rows: int = 0         # dirty rows copied into the device pack


class WindowIndex:
    MIN_CAPW = 8                 # same floor as the EcoVector pack

    def __init__(self, embed: Callable, cfg: SCRConfig = SCRConfig(),
                 dim: Optional[int] = None, device="cuda"):
        self.embed = embed
        self.cfg = cfg
        self.device = resolve_device(device)
        self.texts: List[str] = []
        self.sents: List[List[str]] = []
        self.spans: List[List[Tuple[int, int]]] = []
        self.ntok: List[int] = []            # whitespace tokens per doc
        self.stats = WindowIndexStats()
        self._dim = dim if dim is not None else getattr(embed, "dim", None)
        self._data: Optional[np.ndarray] = None    # [ND, CAPW, d]
        self._lens: Optional[np.ndarray] = None    # [ND] i32
        self._dirty: Set[int] = set()
        # device copy (data, lens), never a view of the host pack, and
        # the rows rewritten on the host since it was last refreshed
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._dev_dirty: Set[int] = set()

    # ------------------------------------------------------------- build

    def __len__(self) -> int:
        return len(self.texts)

    def _window_texts(self, di: int) -> List[str]:
        sents, spans = self.sents[di], self.spans[di]
        return [" ".join(sents[a:b]) for a, b in spans]

    def _set_doc(self, di: int, text: str) -> None:
        self.texts[di] = text
        self.sents[di] = split_sentences(text)
        self.spans[di] = sliding_windows(self.sents[di],
                                         self.cfg.sliding_window_size,
                                         self.cfg.overlap_size)
        self.ntok[di] = len(text.split())

    def _embed_batch(self, win_texts: List[str]) -> np.ndarray:
        vecs = np.asarray(self.embed(win_texts), np.float32)
        self.stats.embed_calls += 1
        self.stats.windows_embedded += len(win_texts)
        if self._dim is None:
            self._dim = vecs.shape[1]
        return vecs

    def _embed_docs(self, doc_ids: Iterable[int]) -> np.ndarray:
        """The windows of `doc_ids`, in order, in one embed call (none
        when there is no window)."""
        win_texts = [t for di in doc_ids for t in self._window_texts(di)]
        if not win_texts:
            return np.zeros((0, self._dim or 1), np.float32)
        return self._embed_batch(win_texts)

    def _place(self, doc_ids: Sequence[int], vecs: np.ndarray) -> None:
        """Write each doc's windows (its run of `vecs`, in `doc_ids`
        order) into its row, from slot 0, and set its length."""
        doc_ids = np.asarray(doc_ids, np.int64)
        counts = np.asarray([len(self.spans[di]) for di in doc_ids],
                            np.int32)
        self._lens[doc_ids] = counts
        if len(vecs):
            owners = np.repeat(doc_ids, counts)
            starts = np.repeat(np.cumsum(counts) - counts, counts)
            self._data[owners, np.arange(len(vecs)) - starts] = vecs

    def build(self, docs: Sequence[str]) -> "WindowIndex":
        """Split/window/embed the whole corpus in one batched embed call
        and build the block pack (the device copy is made on first
        use)."""
        n = len(docs)
        self.texts = [""] * n
        self.sents = [[] for _ in range(n)]
        self.spans = [[] for _ in range(n)]
        self.ntok = [0] * n
        for di, text in enumerate(docs):
            self._set_doc(di, text)
        self._build_pack()
        return self

    def _build_pack(self) -> None:
        nd = len(self.texts)
        vecs = self._embed_docs(range(nd))
        d = self._dim or (vecs.shape[1] if vecs.size else 1)
        capw = max(self.MIN_CAPW,
                   max((len(s) for s in self.spans), default=0))
        self._data = np.zeros((nd, capw, d), np.float32)
        self._lens = np.zeros((nd,), np.int32)
        self._place(range(nd), vecs)
        self.stats.full_builds += 1
        self._dirty.clear()
        self._dev = None
        self._dev_dirty.clear()

    # ----------------------------------------------------------- updates

    def add(self, text: str) -> int:
        """Append a document; only its block is embedded and packed (at
        the next `pack()`). Returns the new doc id."""
        di = len(self.texts)
        self.texts.append("")
        self.sents.append([])
        self.spans.append([])
        self.ntok.append(0)
        self._set_doc(di, text)
        self._mark_dirty(di)
        return di

    def update(self, di: int, text: str) -> None:
        """Replace a document's text; marks only its block dirty."""
        self._set_doc(di, text)
        self._mark_dirty(di)

    def remove(self, di: int) -> None:
        """Drop a document's windows: its block empties and the id stays,
        as retrieval indexes tombstone ids."""
        self._set_doc(di, "")
        self._mark_dirty(di)

    def _mark_dirty(self, di: int) -> None:
        if self._data is not None:
            self._dirty.add(di)

    # -------------------------------------------------------------- pack

    def pack(self) -> Tuple[np.ndarray, np.ndarray]:
        """The host (data [ND, CAPW, d], lens [ND]) pack, with the dirty
        blocks repacked first (one batched embed call for all of them)."""
        if self._data is None:
            self._build_pack()
        elif self._dirty:
            self._repack_dirty()
        return self._data, self._lens

    def _repack_dirty(self) -> None:
        nd, capw, d = self._data.shape
        need_rows = len(self.texts)
        need_capw = max((len(self.spans[di]) for di in self._dirty),
                        default=0)
        if need_rows > nd or need_capw > capw:
            new_nd, new_capw = max(nd, 1), capw
            while new_nd < need_rows:
                new_nd *= 2
            while new_capw < need_capw:
                new_capw *= 2
            data = np.zeros((new_nd, new_capw, d), np.float32)
            data[:nd, :capw] = self._data
            lens = np.zeros((new_nd,), np.int32)
            lens[:nd] = self._lens
            self._data, self._lens = data, lens
            self.stats.grows += 1
            self._dev = None             # new shape: upload it whole
            self._dev_dirty.clear()
        dirty = sorted(self._dirty)
        vecs = self._embed_docs(dirty)
        if len(vecs) and vecs.shape[1] != d:
            # the pack was built before any window existed (placeholder
            # dim); rebuild it now that the true dim is known
            self._build_pack()
            return
        self._data[dirty] = 0.0
        self._place(dirty, vecs)
        self.stats.block_repacks += len(dirty)
        self._dev_dirty.update(dirty)
        self._dirty.clear()

    def device_arrays(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The pack on the index's device. After updates inside the
        pack's shape only the rewritten rows are copied into the
        existing tensors (one `index_copy_`) and `lens` is uploaded; the
        whole pack is uploaded on first use and after a growth."""
        data, lens = self.pack()
        if self._dev is None:
            self._dev = (torch.tensor(data, device=self.device),
                         torch.tensor(lens, device=self.device))
            self._dev_dirty.clear()
            self.stats.mirror_uploads += 1
        elif self._dev_dirty:
            rows = sorted(self._dev_dirty)
            ddata, dlens = self._dev
            ddata.index_copy_(0, torch.tensor(rows, device=self.device),
                              torch.tensor(data[rows], device=self.device))
            dlens.copy_(torch.from_numpy(lens))
            self._dev_dirty.clear()
            self.stats.mirror_rows += len(rows)
        return self._dev

    # -------------------------------------------------------- accounting

    def ram_bytes(self) -> int:
        data, lens = self.pack()
        return int(data.nbytes + lens.nbytes)

    def resident_bytes(self) -> int:
        """The host pack plus the device copy, once it exists."""
        total = self.ram_bytes()
        if self._dev is not None:
            total += sum(t.numel() * t.element_size() for t in self._dev)
        self.stats.resident_bytes = total
        return total

    def record_select(self, doc_ids: np.ndarray) -> None:
        """Account one `scr_select` batch: every valid (query, doc) pair
        reads one doc block of the pack."""
        doc_ids = np.asarray(doc_ids)
        blocks = int((doc_ids >= 0).sum())
        nq = int(doc_ids.shape[0])
        self.stats.select_calls += 1
        self.stats.select_queries += nq
        self.stats.blocks_dma += blocks
        self.stats.last_query_dma_blocks = blocks / max(nq, 1)
