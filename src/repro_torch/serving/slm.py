"""On-device sLM: a `DenseLM` behind the continuous engine, with
tokenisation (the port of `repro.serving.slm.ReducedSLM`).

Unlike the reference, which always builds the reduced config, the SLM
takes a `ModelConfig`, full width or reduced, and its weights (random
from `seed`, or given as `params`). Prompts are left-truncated to the
last MAX_PROMPT tokens.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.dense import DenseLM
from repro_torch.serving.engine import ContinuousEngine


class SLM:
    # the reference ReducedSLM's sizes: the KV budget per request is
    # MAX_PROMPT + MAX_NEW tokens
    MAX_PROMPT = 256
    MAX_NEW = 24
    PAGE_SIZE = 32
    PREFILL_CHUNK = 32
    SLOTS = 4

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.model = DenseLM(cfg, device=device, seed=seed, params=params)
        self.tokenizer = HashTokenizer(cfg.vocab_size)
        self._engine: Optional[ContinuousEngine] = None

    def encode_prompt(self, prompt: str) -> np.ndarray:
        """Prompt ids, left-truncated to MAX_PROMPT (the pad id for an
        empty prompt); the engine prefills ragged lengths in chunks."""
        tok = self.tokenizer
        ids = tok.encode(prompt)[-self.MAX_PROMPT:]
        return np.asarray(ids or [tok.pad_id], np.int32)

    @property
    def engine(self) -> ContinuousEngine:
        """The continuous engine over this model, built on first use."""
        if self._engine is None:
            self._engine = ContinuousEngine(
                self.model, slots=self.SLOTS,
                max_len=self.MAX_PROMPT + self.MAX_NEW,
                eos_id=self.tokenizer.eos_id,
                prefill_chunk=self.PREFILL_CHUNK, page_size=self.PAGE_SIZE)
        return self._engine
