"""The four RAG pipelines the paper compares (Figure 1, Table 5), the
port of `repro.serving.rag`:

  Naive-RAG    : vector search -> full docs -> sLM.
  Advanced-RAG : vector search (x3 wider) -> re-rank by max sentence
                 similarity -> full docs -> sLM.
  EdgeRAG      : IVF-DISK index + a bounded LRU query-embedding cache ->
                 full docs -> sLM.
  MobileRAG    : EcoVector -> SCR (condense + reorder) -> sLM.

Each `answer()` returns the final prompt, its timing, its whitespace
token count and the Table-6 model's TTFT and energy (`SLM_SPEEDS`, the
paper's §3.4.3 power model through `core/analytical.energy_mj`), so the
Table-5 comparison runs without a phone. `answer(q, generate=True)` and
`answer_batch(generate=True)` also decode real tokens on the generator
(`SLM`; a `RagSession` over its continuous engine for a batch).

Every pipeline takes the port's generator arguments (`gen_config`,
default full-width qwen2.5-0.5B; `gen_params`, default random from
`seed`), `trace` and `device` in place of the reference's `gen_arch`;
`slm=` is the Table-6 speed key (kept in `speeds`; the `slm` property is
the generator). The three baselines search on the host by default, as
the reference's do (`device_retrieval = False`); MobileRAG retrieves on
the device by default (the fused route -> ecoscan search; on the CPU
through the plain versions), and construction with device retrieval
makes the index's device pack (or a tiered index's tiers), so the first
request does not pay for it. `index=` serves from an index built
elsewhere.

The reference's degradation ladders are ported: an index fault serves
the last good retrieval's ids (or the corpus head) and counts
`retrieval_fallbacks`; MobileRAG's SCR fault serves the full retrieved
documents (`_make_prompt`) and counts `scr_fallbacks`. One deliberate
difference: a kernel fault (a kernel that does not build or launch, a
CUDA error; `ops.is_kernel_fault`) is never absorbed by either ladder.
It propagates, so a broken device cannot pass for a served answer.

MobileRAG's SCR runs the `scr_select` kernel over the corpus-resident
window index, or, with `use_window_index=False`, the legacy per-query
`apply_scr` (re-embedded windows scored by the `scr_score` kernel).
Documents appended to `docs` after construction (and inserted into the
index) are added to the window index before the next SCR
(`_sync_window_index`). Durable retrieval state, as the reference's:
`retrieval_state=` names a directory; when it holds committed
generations (of either package) the EcoVector and the window index are
restored from them, their WALs replayed, and nothing of the corpus is
embedded; otherwise the pipeline builds and commits its first
generations there. `save_retrieval()` folds the journaled mutations into
new generations. `device_budget_bytes` holds the index under a device
budget (None: all resident; an int: bytes; a float in (0, 1]: a share of
the all-resident pack) with a `TieredEcoVector`. A corrupt snapshot
warns and rebuilds; a kernel fault propagates.
"""
from __future__ import annotations

import os
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.configs import get_config
from repro_torch.core import store
from repro_torch.core.analytical import energy_mj
from repro_torch.core.baselines import IVFDisk
from repro_torch.core.ecovector import EcoVector
from repro_torch.core.scr import (SCRConfig, SCRResult, apply_scr,
                                  apply_scr_batch, build_prompt,
                                  split_sentences)
from repro_torch.core.tiered import TieredEcoVector
from repro_torch.core.window_index import WindowIndex
from repro_torch.kernels.ops import is_kernel_fault
from repro_torch.serving.session import RagSession
from repro_torch.serving.slm import SLM
from repro_torch.serving.trace import TraceSink

# Table 6: measured on Galaxy S24
SLM_SPEEDS = {
    "qwen25_0_5b": {"prompt_tps": 90.0, "gen_tps": 14.5, "batt_pct_1k": 0.10},
    "qwen25_1_5b": {"prompt_tps": 50.0, "gen_tps": 10.0, "batt_pct_1k": 0.30},
    "deepseek_r1_1_5b": {"prompt_tps": 35.0, "gen_tps": 9.0,
                         "batt_pct_1k": 0.36},
}
BATTERY_J = 4000e-3 * 3600 * 3.8  # 4000 mAh at 3.8 V -> ~54.7 kJ


@dataclass
class RAGAnswer:
    prompt: str
    doc_ids: List[int]
    retrieval_s: float
    post_s: float                   # re-rank / SCR time
    prompt_tokens: int              # whitespace tokens of the prompt
    ttft_model_s: float             # retrieval + post + prompt eval (model)
    energy_model_j: float
    scr: Optional[SCRResult] = None
    generated: Optional[str] = None
    # filled by generation: the decoded token ids and the MEASURED
    # prefill + first-token time (beside the Table-6 ttft_model_s)
    gen_tokens: Optional[List[int]] = None
    ttft_measured_s: Optional[float] = None


def _tok_count(text: str) -> int:
    return len(text.split())


class RAGBase:
    """Shared retrieve -> post -> prompt -> model flow. A pipeline with a
    simple flow sets `_finish(query, ids, t_ret, qv=...)` (`qv`: the
    query's vector, already embedded) and inherits `answer` and
    `answer_batch`."""
    name = "base"
    # True: `search_device_batched` where the index has it; False: host
    # search, one `index.search` a query
    device_retrieval: bool = False
    _finish = None

    def __init__(self, docs: Sequence[str], embed: Callable, *,
                 top_k: int = 3, slm: str = "qwen25_0_5b", index=None,
                 generator: Optional[Callable] = None,
                 device_retrieval: Optional[bool] = None,
                 gen_config: Optional[ModelConfig] = None,
                 gen_params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, trace: Optional[TraceSink] = None,
                 device_budget_bytes: Optional[float] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.docs = list(docs)
        self.embed = embed
        self.top_k = top_k
        # IVF probe width of every retrieval; the session's SLO ladder
        # lowers it under deadline pressure and restores it after the
        # chunk
        self.n_probe = 4
        self.device_budget_bytes = device_budget_bytes
        self.speeds = SLM_SPEEDS[slm]
        self.generator = generator
        # degradation ladder: an index fault serves the last good
        # retrieval (or the corpus head), counted
        self.retrieval_fallbacks = 0
        self._last_good_ids: Optional[List[List[int]]] = None
        if device_retrieval is not None:
            self.device_retrieval = device_retrieval
        self.gen_config = gen_config or get_config("qwen25_0_5b")
        self._gen_params = gen_params
        self._seed = seed
        self.trace = trace
        # the generator's KV page size; set it before the first use of
        # `slm` (the reference's --page-size)
        self.page_size = SLM.PAGE_SIZE
        self._slm: Optional[SLM] = None
        if hasattr(embed, "fit") and not getattr(embed, "fitted", True):
            embed.fit(self.docs)
        t0 = time.perf_counter()
        if index is None:
            index = self._build_index(
                np.asarray(embed(self.docs), np.float32))
        if device_budget_bytes is not None and isinstance(
                index, TieredEcoVector):
            index.set_device_budget(self._resolve_device_budget(index))
        self.index = index
        if self.device_retrieval:
            if isinstance(index, TieredEcoVector):
                index.activate()
            elif hasattr(index, "search_device_batched"):
                index.device_arrays()
        self.build_s = time.perf_counter() - t0

    def _build_index(self, doc_vecs: np.ndarray):
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

    @property
    def slm(self) -> SLM:
        """The generator, built on first use."""
        if self._slm is None:
            self._slm = SLM(self.gen_config, params=self._gen_params,
                            seed=self._seed, page_size=self.page_size,
                            device=self.device)
            self._gen_params = None
        return self._slm

    # ---------------------------------------------------------- retrieval

    def _retrieve_batch(self, qvs: np.ndarray, k: int) -> List[List[int]]:
        """Ids of each query of a [B, d] batch: one device call where the
        index has one and device retrieval is on, else a host search a
        query. An index fault degrades to `_fallback_ids` (counted in
        `retrieval_fallbacks`); a kernel fault propagates."""
        qvs = np.atleast_2d(np.asarray(qvs, np.float32))
        try:
            if self.device_retrieval and hasattr(self.index,
                                                 "search_device_batched"):
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

    def _retrieve(self, qv, k):
        return self._retrieve_batch(qv[None], k)[0]

    # ------------------------------------------------------------ answers

    def _make_prompt(self, query: str, docs: List[str],
                     order: List[int]) -> str:
        """The documents in full as context, labelled by their ids."""
        ctx = "\n\n".join(f"[Doc {order[i] + 1}] {d}"
                          for i, d in enumerate(docs))
        return f"Context:\n{ctx}\n\nQuestion: {query}\nAnswer:"

    def _full_docs_prompt(self, query: str, ids: List[int]) -> str:
        return self._make_prompt(query, [self.docs[i] for i in ids], ids)

    def _finalize(self, query, prompt, doc_ids, t_ret, t_post,
                  scr=None) -> RAGAnswer:
        """The answer with the Table-6 model: prompt evaluation at the
        sLM's prompt_tps after retrieval and post; energy = retrieval and
        post as CPU time (§3.4.3) + the LM's battery share a 1k tokens.
        The `generator` hook, when set, fills `generated`."""
        ptok = _tok_count(prompt)
        t_eval = ptok / self.speeds["prompt_tps"]
        ttft = t_ret + t_post + t_eval
        e_cpu = energy_mj((t_ret + t_post) * 1e3, 0.0) * 1e-3
        e_lm = ptok / 1000.0 * self.speeds["batt_pct_1k"] / 100.0 * BATTERY_J
        gen = None
        if self.generator is not None:
            gen = self.generator(prompt)
        return RAGAnswer(prompt, list(doc_ids), t_ret, t_post, ptok, ttft,
                         e_cpu + e_lm, scr, gen)

    def _attach_generation(self, answers: List[RAGAnswer],
                           max_new: int = 16) -> List[RAGAnswer]:
        """Decode the answers' prompts with `SLM.generate` and record the
        tokens, their text and the measured TTFT on each answer."""
        gens = self.slm.generate([a.prompt for a in answers],
                                 max_new=max_new)
        for a, g in zip(answers, gens):
            a.gen_tokens = g.tokens
            a.generated = g.text
            a.ttft_measured_s = g.ttft_s
        return answers

    def answer(self, query: str, *, generate: bool = False,
               max_new: int = 16) -> RAGAnswer:
        """One query end to end; `generate=True` also decodes its prompt
        on the generator (`SLM.generate`)."""
        if self._finish is None:
            raise NotImplementedError
        t0 = time.perf_counter()
        qv = np.asarray(self.embed([query]))[0]
        ids = self._retrieve(qv, self.top_k)
        t_ret = time.perf_counter() - t0
        ans = self._finish(query, ids, t_ret, qv=qv)
        if generate:
            self._attach_generation([ans], max_new=max_new)
        return ans

    def answer_batch(self, queries: Sequence[str], *,
                     generate: bool = False,
                     max_new: int = 16) -> List[RAGAnswer]:
        """One embed and one batched retrieval for the queries, then the
        post stage a query (`answer` a query for a pipeline without
        `_finish`). `generate=True` routes through a RagSession, whose
        retrieval chunks re-enter this path."""
        queries = list(queries)
        if not queries:
            return []
        if generate:
            return self._answer_batch_generate(queries, max_new)
        if self._finish is None:
            return [self.answer(q) for q in queries]
        t0 = time.perf_counter()
        qvs = np.asarray(self.embed(queries), np.float32)
        ids_b = self._retrieve_batch(qvs, self.top_k)
        t_ret = (time.perf_counter() - t0) / len(queries)
        return [self._finish(q, ids, t_ret, qv=qv)
                for q, ids, qv in zip(queries, ids_b, qvs)]

    def _answer_batch_generate(self, queries: List[str],
                               max_new: int) -> List[RAGAnswer]:
        """A RagSession pipelines retrieval and post chunks into the
        continuous engine; a generator without the paged path condenses
        everything, then decodes it with `SLM.generate`."""
        try:
            sess = self.session(max_new=max_new)
        except ValueError:
            out = self.answer_batch(queries, generate=False)
            return self._attach_generation(out, max_new=max_new)
        return sess.run(queries)

    # ---------------------------------------------- request-centric serving

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


class NaiveRAG(RAGBase):
    name = "Naive-RAG"

    def _finish(self, query: str, ids: List[int], t_ret: float,
                qv=None) -> RAGAnswer:
        return self._finalize(query, self._full_docs_prompt(query, ids), ids,
                              t_ret, 0.0)


class AdvancedRAG(RAGBase):
    """Re-ranker: re-scores a x3 wider candidate set by each document's
    best sentence similarity to the query (the lightweight stand-in for a
    re-rank model, which adds the post-retrieval latency the paper
    measures)."""
    name = "Advanced-RAG"

    def answer(self, query: str, *, generate: bool = False,
               max_new: int = 16) -> RAGAnswer:
        t0 = time.perf_counter()
        qv = np.asarray(self.embed([query]))[0]
        ids = self._retrieve(qv, self.top_k * 3)
        t_ret = time.perf_counter() - t0
        t1 = time.perf_counter()
        scores = []
        for i in ids:
            sents = split_sentences(self.docs[i]) or [self.docs[i]]
            sv = np.asarray(self.embed(sents))
            scores.append(float(np.max(sv @ qv)))
        order = np.argsort(scores)[::-1][: self.top_k]
        ids = [ids[i] for i in order]
        t_post = time.perf_counter() - t1
        ans = self._finalize(query, self._full_docs_prompt(query, ids), ids,
                             t_ret, t_post)
        if generate:
            self._attach_generation([ans], max_new=max_new)
        return ans


class EdgeRAG(RAGBase):
    """IVF-DISK retrieval + a query-embedding cache (the paper's EdgeRAG
    baseline). The cache is a bounded LRU (`qcache_cap` entries), so a
    long query stream cannot grow it without limit; `qcache_hits` and
    `qcache_misses` count its lookups."""
    name = "EdgeRAG"
    qcache_cap = 256

    def __init__(self, docs: Sequence[str], embed: Callable, **kw):
        self._qcache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.qcache_hits = 0
        self.qcache_misses = 0
        super().__init__(docs, embed, **kw)

    def _build_index(self, doc_vecs: np.ndarray) -> IVFDisk:
        return IVFDisk(doc_vecs.shape[1],
                       n_clusters=max(4, len(self.docs) // 64),
                       device=self.device).build(doc_vecs)

    def _embed_query_cached(self, query: str) -> np.ndarray:
        qv = self._qcache.get(query)
        if qv is not None:
            self._qcache.move_to_end(query)     # LRU promotion
            self.qcache_hits += 1
            return qv
        qv = np.asarray(self.embed([query]))[0]
        self.qcache_misses += 1
        self._qcache[query] = qv
        while len(self._qcache) > self.qcache_cap:
            self._qcache.popitem(last=False)    # evict the LRU head
        return qv

    def answer(self, query: str, *, generate: bool = False,
               max_new: int = 16) -> RAGAnswer:
        t0 = time.perf_counter()
        qv = self._embed_query_cached(query)
        ids = self._retrieve(qv, self.top_k)
        t_ret = time.perf_counter() - t0
        ans = self._finalize(query, self._full_docs_prompt(query, ids), ids,
                             t_ret, 0.0)
        if generate:
            self._attach_generation([ans], max_new=max_new)
        return ans


class MobileRAG(RAGBase):
    """EcoVector + SCR + sLM (the paper's method). `scr` is the SCR
    window geometry; `use_window_index=False` builds no window index and
    condenses each query with the legacy `apply_scr`. `retrieval_state`
    and `device_budget_bytes` are the reference's (module docstring).
    Other keywords are `RAGBase`'s."""
    name = "MobileRAG"
    device_retrieval = True

    def __init__(self, docs: Sequence[str], embed: Callable, *,
                 scr: SCRConfig = SCRConfig(),
                 use_window_index: bool = True,
                 retrieval_state: Optional[str] = None, **kw):
        t0 = time.perf_counter()
        self.retrieval_state = retrieval_state
        dev = resolve_device(kw.get("device", "cuda"))
        loaded_index = loaded_wi = None
        if retrieval_state is not None:
            loader = (EcoVector.load if kw.get("device_budget_bytes") is None
                      else TieredEcoVector.load)
            loaded_index = self._load_state_part(
                lambda root: loader(root, device=dev),
                os.path.join(retrieval_state, "ecovector"))
            if use_window_index:
                loaded_wi = self._load_state_part(
                    lambda root: WindowIndex.load(embed, root, device=dev),
                    os.path.join(retrieval_state, "windows"))
        if loaded_index is not None:
            kw["index"] = loaded_index
        load_s = time.perf_counter() - t0
        super().__init__(docs, embed, **kw)
        self.build_s += load_s
        self.scr_cfg = scr
        self.scr_fallbacks = 0       # SCR fault -> full-document prompt
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

    def _sync_window_index(self) -> None:
        """Add the documents appended to `self.docs` since the window
        index was built: one `add` each, so only their blocks are
        embedded and packed (at the next `pack()`)."""
        w = self.window_index
        while len(w) < len(self.docs):
            w.add(self.docs[len(w)])

    def _finish(self, query: str, ids: List[int], t_ret: float,
                qv=None) -> RAGAnswer:
        """SCR of one query: the window index's fused select, or the
        legacy `apply_scr` without one. An SCR fault serves the full
        documents (one `scr_fallbacks`); a kernel fault propagates."""
        t1 = time.perf_counter()
        res = None
        try:
            if self.window_index is not None:
                self._sync_window_index()
                qvs = (None if qv is None
                       else np.asarray(qv, np.float32)[None])
                res = apply_scr_batch([query], [ids], self.window_index,
                                      self.embed, qvs=qvs)[0]
            else:
                res = apply_scr(query, [self.docs[i] for i in ids],
                                self.embed, self.scr_cfg, device=self.device)
        except Exception as e:
            if is_kernel_fault(e):
                raise
            self.scr_fallbacks += 1
        t_post = time.perf_counter() - t1
        if res is None:
            return self._finalize(query, self._full_docs_prompt(query, ids),
                                  ids, t_ret, t_post)
        return self._finalize(query, build_prompt(query, res),
                              [ids[i] for i in res.order], t_ret, t_post,
                              scr=res)

    def answer_batch(self, queries: Sequence[str], *,
                     generate: bool = False,
                     max_new: int = 16) -> List[RAGAnswer]:
        """One embed feeds the fused retrieval and the fused SCR select;
        the rest is host string assembly. Without a window index each
        query is condensed by its own `apply_scr` after the batched
        retrieval. An SCR fault serves every query of the batch its full
        documents (one `scr_fallbacks`); a kernel fault propagates.
        `generate=True` routes through a RagSession, whose retrieval
        chunks re-enter this path."""
        queries = list(queries)
        if self.window_index is None or not queries or generate:
            return super().answer_batch(queries, generate=generate,
                                        max_new=max_new)
        self._sync_window_index()
        t0 = time.perf_counter()
        qvs = np.asarray(self.embed(queries), np.float32)
        ids_b = self._retrieve_batch(qvs, self.top_k)
        t_ret = (time.perf_counter() - t0) / len(queries)
        t1 = time.perf_counter()
        try:
            results = apply_scr_batch(queries, ids_b, self.window_index,
                                      self.embed, qvs=qvs)
        except Exception as e:
            if is_kernel_fault(e):
                raise
            self.scr_fallbacks += 1
            t_post = (time.perf_counter() - t1) / len(queries)
            return [self._finalize(q, self._full_docs_prompt(q, ids), ids,
                                   t_ret, t_post)
                    for q, ids in zip(queries, ids_b)]
        t_post = (time.perf_counter() - t1) / len(queries)
        return [self._finalize(q, build_prompt(q, res),
                               [ids[i] for i in res.order], t_ret, t_post,
                               scr=res)
                for q, ids, res in zip(queries, ids_b, results)]


PIPELINES = {
    "naive": NaiveRAG,
    "advanced": AdvancedRAG,
    "edge": EdgeRAG,
    "mobile": MobileRAG,
}


def answer_in_context(example, ans: RAGAnswer) -> bool:
    """The planted answer sentence survived retrieval and (for MobileRAG)
    SCR condensation: the accuracy predicate of every Table-5
    consumer."""
    return example.answer.lower() in ans.prompt.lower()


def accuracy(pipe: RAGBase, examples, max_q: Optional[int] = None) -> float:
    """Answer-in-final-context accuracy, the retrieval-quality proxy for
    Table 5's accuracy, through `answer_batch` (the batched retrieval and
    SCR path)."""
    exs = list(examples[:max_q])
    if not exs:
        return 0.0
    answers = pipe.answer_batch([ex.question for ex in exs])
    ok = sum(bool(answer_in_context(ex, a)) for ex, a in zip(exs, answers))
    return ok / len(exs)
