"""MobileRAG (EcoVector -> SCR -> sLM), the port of
`repro.serving.rag.MobileRAG` on its device path.

Retrieval runs the fused route -> ecoscan search on the device
(`EcoVector.search_device_batched`) by default; `device_retrieval=False`
is the reference's host-search mode, one `index.search` a query (the
EcoVector host search loads each probed cluster's graph from disk).
`index=` serves from an index built elsewhere instead of building one.
SCR runs the `scr_select` kernel over the corpus-resident window index,
or, with `use_window_index=False`, the legacy per-query `apply_scr`
(re-embedded windows scored by the `scr_score` kernel). Documents
appended to `docs` after construction (and inserted into the index) are
added to the window index before the next SCR (`_sync_window_index`), as
the reference does. `answer_batch(generate=True)` pipelines chunks of
queries through a `RagSession` into the continuous engine; `session()`
and `stream()` take the reference's `slots`, `retrieve_chunk`, `greedy`
and `seed`, and its serving-under-fire arguments: `max_pending`
(admission bound), `deadline_s`, `trace` and `slo_s` (SLO admission).

The reference's two degradation ladders are ported: an index fault
serves the last good retrieval's ids (or the corpus head) and counts
`retrieval_fallbacks`; an SCR fault serves the full retrieved documents
(`_make_prompt`) and counts `scr_fallbacks`. One deliberate difference:
a kernel fault (a kernel that does not build or launch, a CUDA error;
`ops.is_kernel_fault`) is never absorbed by either ladder. It
propagates, so a broken device cannot pass for a served answer.

Durable retrieval state, as the reference's: `retrieval_state=` names
a directory; when it holds committed generations (of either package)
the EcoVector and the window index are restored from them, their WALs
replayed, and nothing of the corpus is embedded; otherwise the pipeline
builds and commits its first generations there. `save_retrieval()`
folds the journaled mutations into new generations.
`device_budget_bytes` holds the index under a device budget (None: all
resident; an int: bytes; a float in (0, 1]: a share of the all-resident
pack) with a `TieredEcoVector`; construction activates its tiers where
an all-resident index makes its device pack. A corrupt snapshot warns
and rebuilds; a kernel fault propagates.

Not ported: the reference's other pipelines and their Table-6
TTFT/energy model.
"""
from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.core import store
from repro_torch.core.ecovector import EcoVector
from repro_torch.core.scr import (SCRConfig, SCRResult, apply_scr,
                                  apply_scr_batch, build_prompt)
from repro_torch.core.tiered import TieredEcoVector
from repro_torch.core.window_index import WindowIndex
from repro_torch.kernels.ops import is_kernel_fault
from repro_torch.serving.session import RagSession
from repro_torch.serving.slm import SLM
from repro_torch.serving.trace import TraceSink


@dataclass
class RAGAnswer:
    prompt: str
    doc_ids: List[int]
    retrieval_s: float
    post_s: float                   # SCR time
    prompt_tokens: int              # whitespace tokens of the prompt
    scr: Optional[SCRResult] = None
    generated: Optional[str] = None
    gen_tokens: Optional[List[int]] = None
    ttft_measured_s: Optional[float] = None


class MobileRAG:
    """EcoVector + SCR + sLM. `gen_config` is the generator's model
    (default: full-width qwen2.5-0.5B) with weights `gen_params`
    (default: random from `seed`). `scr` is the SCR window geometry;
    `use_window_index=False` builds no window index and condenses each
    query with the legacy `apply_scr`. `trace` records the engine's and
    the session's request lifecycle (serving/trace.py). `index` is a
    built index to retrieve from (default: an EcoVector built over the
    docs); `device_retrieval=False` searches it on the host, one query
    at a time. With device retrieval the construction also makes the
    index's device pack (or a tiered index's tiers), so the first
    request does not pay for it. `retrieval_state` and
    `device_budget_bytes` are the reference's (module docstring)."""

    def __init__(self, docs: Sequence[str], embed: Callable, *,
                 top_k: int = 3,
                 scr: SCRConfig = SCRConfig(),
                 use_window_index: bool = True,
                 index=None, device_retrieval: bool = True,
                 gen_config: Optional[ModelConfig] = None,
                 gen_params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, trace: Optional[TraceSink] = None,
                 retrieval_state: Optional[str] = None,
                 device_budget_bytes: Optional[float] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.retrieval_state = retrieval_state
        self.device_budget_bytes = device_budget_bytes
        self.docs = list(docs)
        self.embed = embed
        self.top_k = top_k
        # IVF probe width of every retrieval; the session's SLO ladder
        # lowers it under deadline pressure and restores it after the
        # chunk
        self.n_probe = 4
        # degradation ladders: an index fault serves the last good
        # retrieval (or the corpus head), an SCR fault the full documents;
        # each decision counted
        self.retrieval_fallbacks = 0
        self.scr_fallbacks = 0
        self._last_good_ids: Optional[List[List[int]]] = None
        if hasattr(embed, "fit") and not getattr(embed, "fitted", True):
            embed.fit(self.docs)
        t0 = time.perf_counter()
        loaded_index = loaded_wi = None
        if retrieval_state is not None:
            loader = (EcoVector.load if device_budget_bytes is None
                      else TieredEcoVector.load)
            loaded_index = self._load_state_part(
                lambda root: loader(root, device=self.device),
                os.path.join(retrieval_state, "ecovector"))
            if use_window_index:
                loaded_wi = self._load_state_part(
                    lambda root: WindowIndex.load(embed, root,
                                                  device=self.device),
                    os.path.join(retrieval_state, "windows"))
        if loaded_index is not None:
            index = loaded_index
        if index is None:
            index = self._build_index(
                np.asarray(embed(self.docs), np.float32))
        if device_budget_bytes is not None and isinstance(
                index, TieredEcoVector):
            index.set_device_budget(self._resolve_device_budget(index))
        self.index = index
        self.device_retrieval = device_retrieval
        if device_retrieval:
            if isinstance(index, TieredEcoVector):
                index.activate()
            else:
                index.device_arrays()
        self.build_s = time.perf_counter() - t0
        self.scr_cfg = scr
        self.window_index: Optional[WindowIndex] = loaded_wi
        t0 = time.perf_counter()
        if use_window_index:
            if loaded_wi is None:
                self.window_index = WindowIndex(
                    embed, scr, device=self.device).build(self.docs)
            self._sync_window_index()      # docs beyond the snapshot
            self.window_index.device_arrays()
        self.scr_build_s = time.perf_counter() - t0
        if retrieval_state is not None and (loaded_index is None
                                            or loaded_wi is None):
            self.save_retrieval()          # establish / complete it
        self.gen_config = gen_config or get_config("qwen25_0_5b")
        self._gen_params = gen_params
        self._seed = seed
        self.trace = trace
        self._slm: Optional[SLM] = None

    def _build_index(self, doc_vecs: np.ndarray) -> EcoVector:
        n_clusters = max(4, len(self.docs) // 64)
        cls = EcoVector if self.device_budget_bytes is None \
            else TieredEcoVector
        return cls(doc_vecs.shape[1], n_clusters=n_clusters,
                   device=self.device).build(doc_vecs)

    def _resolve_device_budget(self, index: TieredEcoVector) -> int:
        b = self.device_budget_bytes
        if 0 < b <= 1.0:             # a share of the all-resident pack
            return int(b * index.all_resident_bytes())
        return int(b)

    @staticmethod
    def _load_state_part(loader, root: str):
        """One part's restore: no state means a build (the first run);
        corrupt state warns, then rebuilds. A kernel fault propagates."""
        try:
            return loader(root)
        except FileNotFoundError:
            return None
        except (store.StoreError, OSError) as e:
            if is_kernel_fault(e):
                raise
            warnings.warn(f"retrieval state under {root} failed "
                          f"validation ({e}); rebuilding from source",
                          stacklevel=3)
            return None

    def save_retrieval(self, root: Optional[str] = None) -> None:
        """Commit the retrieval state (an EcoVector generation and a
        window-index generation) under `root` / `retrieval_state`,
        folding the journaled mutations into the new snapshots."""
        root = root or self.retrieval_state
        if root is None:
            raise ValueError("no retrieval_state directory configured")
        self.retrieval_state = root
        if hasattr(self.index, "save"):
            self.index.save(os.path.join(root, "ecovector"))
        if self.window_index is not None:
            self.window_index.save(os.path.join(root, "windows"))

    @property
    def slm(self) -> SLM:
        """The generator, built on first use."""
        if self._slm is None:
            self._slm = SLM(self.gen_config, params=self._gen_params,
                            seed=self._seed, device=self.device)
            self._gen_params = None
        return self._slm

    def _retrieve_batch(self, qvs: np.ndarray, k: int) -> List[List[int]]:
        """Ids of each query of a [B, d] batch: one device call, or a
        host search a query. An index fault degrades to `_fallback_ids`
        (counted in `retrieval_fallbacks`); a kernel fault propagates."""
        qvs = np.atleast_2d(np.asarray(qvs, np.float32))
        try:
            if self.device_retrieval:
                ids_b, _ = self.index.search_device_batched(
                    qvs, k=k, n_probe=self.n_probe)
            else:
                ids_b = [self.index.search(qv, k=k, n_probe=self.n_probe)[0]
                         for qv in qvs]
        except Exception as e:
            if is_kernel_fault(e):
                raise
            self.retrieval_fallbacks += 1
            return self._fallback_ids(len(qvs), k)
        clean = [[int(i) for i in row if 0 <= int(i) < len(self.docs)]
                 for row in ids_b]
        self._last_good_ids = clean
        return clean

    def _fallback_ids(self, n: int, k: int) -> List[List[int]]:
        """Stale but serviceable ids while the index is down: the last
        good batch's rows, cycled, else the first k documents."""
        if self._last_good_ids:
            rows = self._last_good_ids
            return [list(rows[i % len(rows)]) for i in range(n)]
        return [list(range(min(k, len(self.docs)))) for _ in range(n)]

    def _make_prompt(self, query: str, ids: List[int]) -> str:
        """The full retrieved documents as context (the prompt of an SCR
        fallback)."""
        ctx = "\n\n".join(f"[Doc {i + 1}] {self.docs[i]}" for i in ids)
        return f"Context:\n{ctx}\n\nQuestion: {query}\nAnswer:"

    def _full_docs(self, query: str, ids: List[int], t_ret: float,
                   t_post: float) -> RAGAnswer:
        prompt = self._make_prompt(query, ids)
        return RAGAnswer(prompt, list(ids), t_ret, t_post,
                         len(prompt.split()))

    def answer_batch(self, queries: Sequence[str], *,
                     generate: bool = False,
                     max_new: int = 16) -> List[RAGAnswer]:
        """One embed feeds the fused retrieval and the fused SCR select;
        the rest is host string assembly. Without a window index, each
        query is condensed by its own `apply_scr` call after the batched
        retrieval. An SCR fault serves every query of the batch its full
        documents (one `scr_fallbacks`); a kernel fault propagates.
        `generate=True` routes through a RagSession, whose retrieval
        chunks re-enter this path."""
        queries = list(queries)
        if not queries:
            return []
        if generate:
            return self.session(max_new=max_new).run(queries)
        t0 = time.perf_counter()
        qvs = np.asarray(self.embed(queries), np.float32)
        ids_b = self._retrieve_batch(qvs, self.top_k)
        t_ret = (time.perf_counter() - t0) / len(queries)
        if self.window_index is None:
            return [self._finish_legacy(q, ids, t_ret)
                    for q, ids in zip(queries, ids_b)]
        self._sync_window_index()
        t1 = time.perf_counter()
        try:
            results = apply_scr_batch(queries, ids_b, self.window_index,
                                      self.embed, qvs=qvs)
        except Exception as e:
            if is_kernel_fault(e):
                raise
            self.scr_fallbacks += 1
            t_post = (time.perf_counter() - t1) / len(queries)
            return [self._full_docs(q, ids, t_ret, t_post)
                    for q, ids in zip(queries, ids_b)]
        t_post = (time.perf_counter() - t1) / len(queries)
        out = []
        for q, ids, res in zip(queries, ids_b, results):
            prompt = build_prompt(q, res)
            out.append(RAGAnswer(prompt, [ids[i] for i in res.order], t_ret,
                                 t_post, len(prompt.split()), scr=res))
        return out

    def _finish_legacy(self, query: str, ids: List[int],
                       t_ret: float) -> RAGAnswer:
        """Per-query SCR over the retrieved docs (`apply_scr`); an SCR
        fault serves the full documents (one `scr_fallbacks`), a kernel
        fault propagates."""
        t1 = time.perf_counter()
        try:
            res = apply_scr(query, [self.docs[i] for i in ids], self.embed,
                            self.scr_cfg, device=self.device)
        except Exception as e:
            if is_kernel_fault(e):
                raise
            self.scr_fallbacks += 1
            return self._full_docs(query, ids, t_ret,
                                   time.perf_counter() - t1)
        t_post = time.perf_counter() - t1
        prompt = build_prompt(query, res)
        return RAGAnswer(prompt, [ids[i] for i in res.order], t_ret, t_post,
                         len(prompt.split()), scr=res)

    def _sync_window_index(self) -> None:
        """Add the documents appended to `self.docs` since the window
        index was built: one `add` each, so only their blocks are
        embedded and packed (at the next `pack()`)."""
        w = self.window_index
        while len(w) < len(self.docs):
            w.add(self.docs[len(w)])

    def session(self, *, max_new: int = 16, slots: int = 4,
                retrieve_chunk: int = 4, greedy: bool = True,
                seed: int = 0, max_pending: Optional[int] = None,
                deadline_s: Optional[float] = None,
                trace: Optional[TraceSink] = None,
                slo_s: Optional[float] = None) -> RagSession:
        """A RagSession over this pipeline: continuous-batching decode on
        the sLM's engine of `slots` slots. `greedy=False` samples each
        request from its own stream fold_in(PRNGKey(seed), rid).
        `max_pending` bounds admission (degrade past half, shed at the
        bound); `deadline_s` is the default deadline of a request;
        `trace` is a shared TraceSink (default: the pipeline's); `slo_s`
        turns on SLO admission planned from the live trace window."""
        return RagSession(self, max_new=max_new, slots=slots,
                          retrieve_chunk=retrieve_chunk, greedy=greedy,
                          seed=seed, max_pending=max_pending,
                          deadline_s=deadline_s,
                          trace=self.trace if trace is None else trace,
                          slo_s=slo_s)

    def stream(self, queries: Sequence[str] = (), *, max_new: int = 16,
               slots: int = 4, retrieve_chunk: int = 4):
        """Events (submitted / retrieved / condensed / token / done) of
        `queries` through a fresh RagSession."""
        return self.session(max_new=max_new, slots=slots,
                            retrieve_chunk=retrieve_chunk).stream(queries)
