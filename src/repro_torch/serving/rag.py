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
and `seed`. Not ported: the reference's other pipelines and their
Table-6 TTFT/energy model, durable retrieval state (`retrieval_state`,
`save_retrieval`) and the degradation ladders (retrieval and SCR
fallbacks, deadlines, SLO admission): a fault in retrieval or SCR
raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.core.ecovector import EcoVector
from repro_torch.core.scr import (SCRConfig, SCRResult, apply_scr,
                                  apply_scr_batch, build_prompt)
from repro_torch.core.window_index import WindowIndex
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
    index's device pack, so the first request does not pay for it."""

    def __init__(self, docs: Sequence[str], embed: Callable, *,
                 top_k: int = 3,
                 scr: SCRConfig = SCRConfig(),
                 use_window_index: bool = True,
                 index=None, device_retrieval: bool = True,
                 gen_config: Optional[ModelConfig] = None,
                 gen_params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, trace: Optional[TraceSink] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.docs = list(docs)
        self.embed = embed
        self.top_k = top_k
        self.n_probe = 4
        if hasattr(embed, "fit") and not getattr(embed, "fitted", True):
            embed.fit(self.docs)
        t0 = time.perf_counter()
        if index is None:
            doc_vecs = np.asarray(embed(self.docs), np.float32)
            index = EcoVector(doc_vecs.shape[1],
                              n_clusters=max(4, len(self.docs) // 64),
                              device=self.device).build(doc_vecs)
        self.index = index
        self.device_retrieval = device_retrieval
        if device_retrieval:
            index.device_arrays()
        self.build_s = time.perf_counter() - t0
        self.scr_cfg = scr
        self.window_index: Optional[WindowIndex] = None
        t0 = time.perf_counter()
        if use_window_index:
            self.window_index = WindowIndex(embed, scr,
                                            device=self.device).build(
                self.docs)
            self.window_index.device_arrays()
        self.scr_build_s = time.perf_counter() - t0
        self.gen_config = gen_config or get_config("qwen25_0_5b")
        self._gen_params = gen_params
        self._seed = seed
        self.trace = trace
        self._slm: Optional[SLM] = None

    @property
    def slm(self) -> SLM:
        """The generator, built on first use."""
        if self._slm is None:
            self._slm = SLM(self.gen_config, params=self._gen_params,
                            seed=self._seed, device=self.device)
            self._gen_params = None
        return self._slm

    def _retrieve_batch(self, qvs: np.ndarray, k: int) -> List[List[int]]:
        if self.device_retrieval:
            ids_b, _ = self.index.search_device_batched(qvs, k=k,
                                                        n_probe=self.n_probe)
        else:
            ids_b = [self.index.search(qv, k=k, n_probe=self.n_probe)[0]
                     for qv in qvs]
        return [[int(i) for i in row if 0 <= int(i) < len(self.docs)]
                for row in ids_b]

    def answer_batch(self, queries: Sequence[str], *,
                     generate: bool = False,
                     max_new: int = 16) -> List[RAGAnswer]:
        """One embed feeds the fused retrieval and the fused SCR select;
        the rest is host string assembly. Without a window index, each
        query is condensed by its own `apply_scr` call after the batched
        retrieval. `generate=True` routes through a RagSession, whose
        retrieval chunks re-enter this path."""
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
        results = apply_scr_batch(queries, ids_b, self.window_index,
                                  self.embed, qvs=qvs)
        t_post = (time.perf_counter() - t1) / len(queries)
        out = []
        for q, ids, res in zip(queries, ids_b, results):
            prompt = build_prompt(q, res)
            out.append(RAGAnswer(prompt, [ids[i] for i in res.order], t_ret,
                                 t_post, len(prompt.split()), scr=res))
        return out

    def _finish_legacy(self, query: str, ids: List[int],
                       t_ret: float) -> RAGAnswer:
        """Per-query SCR over the retrieved docs (`apply_scr`)."""
        t1 = time.perf_counter()
        res = apply_scr(query, [self.docs[i] for i in ids], self.embed,
                        self.scr_cfg, device=self.device)
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
                seed: int = 0) -> RagSession:
        """A RagSession over this pipeline: continuous-batching decode on
        the sLM's engine of `slots` slots. `greedy=False` samples each
        request from its own stream fold_in(PRNGKey(seed), rid)."""
        return RagSession(self, max_new=max_new, slots=slots,
                          retrieve_chunk=retrieve_chunk, greedy=greedy,
                          seed=seed, trace=self.trace)

    def stream(self, queries: Sequence[str] = (), *, max_new: int = 16,
               slots: int = 4, retrieve_chunk: int = 4):
        """Events (submitted / retrieved / condensed / token / done) of
        `queries` through a fresh RagSession."""
        return self.session(max_new=max_new, slots=slots,
                            retrieve_chunk=retrieve_chunk).stream(queries)
