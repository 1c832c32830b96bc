"""Selective Content Reduction (paper §4): the port of `repro.core.scr`.

Two paths, as in the reference:
- `apply_scr_batch`, over a corpus-resident window index: one
  `scr_select` kernel call scores every (query, retrieved doc) pair and
  picks each doc's best window;
- `apply_scr`, the legacy per-query path: it splits and re-embeds the
  retrieved documents' windows and scores them with one `scr_score`
  kernel call.
The host assembles the condensed texts in the same Python as the
reference, so results and prompts are identical.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops

_SENT_RE = re.compile(r"(?<=[.!?])\s+")


def split_sentences(text: str) -> List[str]:
    parts = [s.strip() for s in _SENT_RE.split(text.strip()) if s.strip()]
    return parts or ([text.strip()] if text.strip() else [])


def sliding_windows(sentences: Sequence[str], window: int,
                    overlap: int) -> List[Tuple[int, int]]:
    """Return [start, end) sentence spans. step = window - overlap >= 1."""
    n = len(sentences)
    if n == 0:
        return []
    window = max(1, min(window, n))
    step = max(1, window - overlap)
    spans = []
    i = 0
    while True:
        spans.append((i, min(i + window, n)))
        if i + window >= n:
            break
        i += step
    return spans


@dataclass
class SCRConfig:
    sliding_window_size: int = 3
    overlap_size: int = 2
    context_extension_size: int = 1


@dataclass
class SCRResult:
    texts: List[str]             # condensed docs, reordered
    order: List[int]             # original doc index per output slot
    scores: List[float]          # best-window score per output doc
    spans: List[Tuple[int, int]]  # chosen extended span per output doc
    tokens_before: int
    tokens_after: int


def _count_tokens(text: str) -> int:
    return len(text.split())


def segment_best_windows(scores: np.ndarray, owners: Sequence[int],
                         n_docs: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-document argmax over flat window scores [NW] owned by `owners`
    [NW]. Returns (best [n_docs]: flat index of each doc's first-max
    window, valid where the doc owns windows; counts [n_docs]: windows
    per doc)."""
    scores = np.asarray(scores)
    owners = np.asarray(owners, np.int64)
    counts = np.bincount(owners, minlength=n_docs)[:n_docs]
    if len(owners) == 0:
        return np.zeros(n_docs, np.int64), counts
    # sort by (owner asc, score desc, flat index asc): the first row of
    # each owner group is that doc's first-max window
    srt = np.lexsort((np.arange(len(owners)), -scores, owners))
    starts = np.searchsorted(owners[srt], np.arange(n_docs), side="left")
    best = srt[np.minimum(starts, len(owners) - 1)]
    return best, counts


def apply_scr(query: str, docs: Sequence[str], embed: Callable,
              cfg: SCRConfig = SCRConfig(), device="cuda") -> SCRResult:
    """Legacy per-query SCR: embed the query and every window of `docs`,
    score the windows with one `scr_score` call (B = 1) on `device`, keep
    each doc's best window with its context extension, and order the docs
    by that score."""
    dev = resolve_device(device)
    qv = np.asarray(embed([query]))[0]
    doc_sents = [split_sentences(t) for t in docs]
    doc_spans = [sliding_windows(s, cfg.sliding_window_size, cfg.overlap_size)
                 for s in doc_sents]
    win_texts, owners = [], []
    for di, (sents, spans) in enumerate(zip(doc_sents, doc_spans)):
        for (a, b) in spans:
            win_texts.append(" ".join(sents[a:b]))
            owners.append(di)
    if not win_texts:
        return SCRResult(list(docs), list(range(len(docs))),
                         [0.0] * len(docs), [(0, 0)] * len(docs), 0, 0)
    wv = np.asarray(embed(win_texts), np.float32)      # [NW, d]
    scores = ops.scr_score(
        torch.tensor(wv[None], device=dev),
        torch.tensor(qv[None].astype(np.float32), device=dev))[0]
    scores = scores.cpu().numpy()
    best, counts = segment_best_windows(scores, owners, len(docs))
    offsets = np.concatenate(([0], np.cumsum(counts)))
    out_texts, out_scores, out_spans = [], [], []
    for di, (sents, spans) in enumerate(zip(doc_sents, doc_spans)):
        if not counts[di]:
            out_texts.append(docs[di])
            out_scores.append(-np.inf)
            out_spans.append((0, len(sents)))
            continue
        a, b = spans[int(best[di]) - int(offsets[di])]
        a2 = max(0, a - cfg.context_extension_size)
        b2 = min(len(sents), b + cfg.context_extension_size)
        out_texts.append(" ".join(sents[a2:b2]))
        out_scores.append(float(scores[best[di]]))
        out_spans.append((a2, b2))
    order = sorted(range(len(docs)), key=lambda i: -out_scores[i])
    before = sum(_count_tokens(t) for t in docs)
    after = sum(_count_tokens(out_texts[i]) for i in order)
    return SCRResult([out_texts[i] for i in order], order,
                     [out_scores[i] for i in order],
                     [out_spans[i] for i in order], before, after)


def apply_scr_batch(queries: Sequence[str],
                    doc_ids_per_query: Sequence[Sequence[int]],
                    index, embed: Callable,
                    qvs: Optional[np.ndarray] = None) -> List[SCRResult]:
    """Batched SCR over a `WindowIndex`: the queries' vectors (`qvs`
    [B, d], embedded here when None) and the retrieved doc ids go through
    one `scr_select` call; the host does string assembly only."""
    B = len(queries)
    if B == 0:
        return []
    if qvs is None:
        qvs = np.asarray(embed(list(queries)), np.float32)
    K = max((len(ids) for ids in doc_ids_per_query), default=0)
    _, lens = index.pack()
    if K == 0 or not lens.any():
        return [_assemble(q, ids, None, None, index)
                for q, ids in zip(queries, doc_ids_per_query)]
    ids_m = np.full((B, K), -1, np.int32)
    for b, row in enumerate(doc_ids_per_query):
        ids_m[b, :len(row)] = row
    if ids_m.max() >= len(index):
        raise IndexError(f"doc id {ids_m.max()} outside the {len(index)}-doc "
                         "window index")
    data_t, lens_t = index.device_arrays()
    index.record_select(ids_m)
    dev = data_t.device
    scores, wins = ops.scr_select(
        torch.tensor(np.asarray(qvs, np.float32), device=dev), data_t,
        lens_t, torch.tensor(ids_m, device=dev))
    scores = scores.cpu().numpy()
    wins = wins.cpu().numpy()
    return [_assemble(q, ids, scores[b], wins[b], index)
            for b, (q, ids) in enumerate(zip(queries, doc_ids_per_query))]


def _assemble(query: str, doc_ids: Sequence[int],
              scores_row: Optional[np.ndarray],
              wins_row: Optional[np.ndarray], index) -> SCRResult:
    """Host-side Selecting & Merging & Reordering (§4 steps 2–3) from the
    kernel's per-doc (score, window) pairs — string work only."""
    cfg = index.cfg
    n = len(doc_ids)
    if all(not index.spans[di] for di in doc_ids):
        docs = [index.texts[di] for di in doc_ids]
        return SCRResult(docs, list(range(n)), [0.0] * n, [(0, 0)] * n,
                         0, 0)
    out_texts, out_scores, out_spans = [], [], []
    for j, di in enumerate(doc_ids):
        sents, spans = index.sents[di], index.spans[di]
        if not spans:
            out_texts.append(index.texts[di])
            out_scores.append(-np.inf)
            out_spans.append((0, len(sents)))
            continue
        a, b = spans[int(wins_row[j])]
        a2 = max(0, a - cfg.context_extension_size)
        b2 = min(len(sents), b + cfg.context_extension_size)
        out_texts.append(" ".join(sents[a2:b2]))
        out_scores.append(float(scores_row[j]))
        out_spans.append((a2, b2))
    order = sorted(range(n), key=lambda i: -out_scores[i])
    before = sum(index.ntok[di] for di in doc_ids)
    after = sum(_count_tokens(out_texts[i]) for i in order)
    return SCRResult([out_texts[i] for i in order], order,
                     [out_scores[i] for i in order],
                     [out_spans[i] for i in order], before, after)


def build_prompt(query: str, result: SCRResult) -> str:
    ctx = "\n\n".join(f"[Doc {result.order[i] + 1}] {t}"
                      for i, t in enumerate(result.texts))
    return f"Context:\n{ctx}\n\nQuestion: {query}\nAnswer:"
