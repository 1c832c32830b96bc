"""On-device sLM: a `DenseLM` behind the wave `Engine` and its shared
continuous engine, with tokenisation (the port of
`repro.serving.slm.ReducedSLM`: `encode_prompt`, `continuous`,
`measure_ttft`).

Unlike the reference, which always builds the reduced config, the SLM
takes a `ModelConfig`, full width or reduced, and its weights (random
from `seed`, or given as `params`). Prompts are left-truncated to the
last MAX_PROMPT tokens and, for the wave path, left-padded to a multiple
of PAD_MULTIPLE so that prompt lengths fall into few buckets.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.dense import DenseLM
from repro_torch.serving.engine import ContinuousEngine, Engine


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
                 device="cuda"):
        self.cfg = cfg
        self.model = DenseLM(cfg, device=device, seed=seed, params=params)
        self.tokenizer = HashTokenizer(cfg.vocab_size)
        self.wave = Engine(self.model, max_len=self.MAX_PROMPT + self.MAX_NEW,
                           eos_id=self.tokenizer.eos_id,
                           prefill_chunk=self.PREFILL_CHUNK,
                           slots=self.SLOTS, page_size=self.PAGE_SIZE)

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
