"""On-device sLM: a `DenseLM` behind the wave `Engine` and its shared
continuous engine, with tokenisation (the port of
`repro.serving.slm.ReducedSLM`: `encode_prompt`, `continuous`,
`generate`, `warmup`, `measure_ttft`).

Unlike the reference, which always builds the reduced config, the SLM
takes a `ModelConfig`, full width or reduced, and its weights (random
from `seed`, or given as `params`). Prompts are left-truncated to the
last MAX_PROMPT tokens and, for the wave path, left-padded to a multiple
of PAD_MULTIPLE so that prompt lengths fall into few buckets.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.dense import DenseLM
from repro_torch.serving.engine import ContinuousEngine, Engine


@dataclass
class SLMGeneration:
    tokens: List[int]               # generated token ids (EOS included)
    text: str                       # detokenised generation, EOS dropped
    prompt_tokens: int              # true (pre-pad) prompt length
    ttft_s: float                   # measured prefill + first-token time
    decode_s: float = 0.0


class SLM:
    # the reference ReducedSLM's sizes: the KV budget per request is
    # MAX_PROMPT + MAX_NEW tokens
    MAX_PROMPT = 256
    MAX_NEW = 24
    PAGE_SIZE = 32
    PREFILL_CHUNK = 32
    PAD_MULTIPLE = 32
    SLOTS = 4

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 page_size: int = PAGE_SIZE, device="cuda"):
        """`page_size`: positions a page of the continuous engines' KV
        pools (the reference's `--page-size`)."""
        self.cfg = cfg
        self.model = DenseLM(cfg, device=device, seed=seed, params=params)
        self.tokenizer = HashTokenizer(cfg.vocab_size)
        self.wave = Engine(self.model, max_len=self.MAX_PROMPT + self.MAX_NEW,
                           eos_id=self.tokenizer.eos_id,
                           prefill_chunk=self.PREFILL_CHUNK,
                           slots=self.SLOTS, page_size=page_size)

    def encode_prompt(self, prompt: str, *, bucket: bool = False
                      ) -> np.ndarray:
        """Prompt ids, left-truncated to MAX_PROMPT (the pad id for an
        empty prompt): ragged, for the continuous engine that prefills in
        chunks, or with `bucket=True` left-padded to the next multiple of
        PAD_MULTIPLE (at most MAX_PROMPT), the wave path's buckets."""
        tok = self.tokenizer
        ids = tok.encode(prompt)[-self.MAX_PROMPT:]
        if not bucket:
            return np.asarray(ids or [tok.pad_id], np.int32)
        m = self.PAD_MULTIPLE
        bucket_len = min(self.MAX_PROMPT, -(-max(len(ids), 1) // m) * m)
        return np.asarray([tok.pad_id] * (bucket_len - len(ids)) + ids,
                          np.int32)

    def continuous(self, slots: int = SLOTS) -> ContinuousEngine:
        """The shared continuous engine of `slots` slots over this model
        (a session's decode backend), built on first use."""
        return self.wave.continuous(slots)

    @property
    def engine(self) -> ContinuousEngine:
        """The continuous engine of SLOTS slots."""
        return self.continuous(self.SLOTS)

    def warmup(self) -> None:
        """One throwaway generation off the measured path."""
        self.generate(["warmup"], max_new=1)

    def generate(self, prompts: List[str], max_new: Optional[int] = None,
                 *, warm_first: bool = True) -> List[SLMGeneration]:
        """Greedy generations of `prompts`, bucketed as the reference
        encodes them, through `Engine.generate` (the continuous engine
        for every ported config). `max_new` (default MAX_NEW) must lie in
        [1, MAX_NEW]: the KV budget a request is fixed at construction.
        `warm_first` runs the same prompts once unmeasured first, as the
        reference does."""
        if max_new is None:
            max_new = self.MAX_NEW
        if not 1 <= max_new <= self.MAX_NEW:
            raise ValueError(f"max_new={max_new} outside [1, {self.MAX_NEW}]:"
                             " the KV budget a request is fixed at "
                             "construction")
        tok = self.tokenizer
        arrs = [self.encode_prompt(p, bucket=True) for p in prompts]
        if warm_first:
            self.wave.generate(arrs, max_new=1)
        out = []
        for p, r in zip(prompts, self.wave.generate(arrs, max_new=max_new)):
            out.append(SLMGeneration(
                tokens=list(r.tokens),
                text=tok.decode(t for t in r.tokens if t != tok.eos_id),
                prompt_tokens=min(len(tok.encode(p)), self.MAX_PROMPT),
                ttft_s=r.prefill_s, decode_s=r.decode_s))
        return out

    def measure_ttft(self, prompt: str, *, warm: bool = True) -> float:
        """Wall time of one wave of the bucketed prompt through its first
        token (prefill + one greedy pick). `warm` runs the same wave once
        unmeasured first."""
        arr = self.encode_prompt(prompt, bucket=True)
        if warm:
            self.wave.generate_wave([arr], max_new=1)
        t0 = time.perf_counter()
        self.wave.generate_wave([arr], max_new=1)
        return time.perf_counter() - t0
