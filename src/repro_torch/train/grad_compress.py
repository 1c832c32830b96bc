"""Int8 gradient compression with error feedback (the port of
`repro.train.grad_compress`): each gradient goes through the int8 wire
format (per-row scales, `optimizer.quantize_rows`) and back.
`compress_decompress` is the stateless round trip the trainer applies
with `grad_compression="int8_ef"`; `compress_with_feedback` keeps the
residual in a state folded into the next step's gradient, for a loop
that owns persistent state."""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from repro_torch.train.optimizer import dequantize_rows, quantize_rows


def compress_decompress(grads: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Each gradient through the int8 code and back, in its dtype
    (0-d tensors unchanged)."""
    def f(g):
        if g.dim() == 0:
            return g
        return dequantize_rows(quantize_rows(g.float())).to(g.dtype)
    return {n: f(g) for n, g in grads.items()}


def compress_with_feedback(grads: Mapping[str, torch.Tensor],
                           ef_state: Mapping[str, torch.Tensor]):
    """g' = Q(g + e), e' = (g + e) - g' for each gradient (0-d ones pass
    as they are). Returns (the sent gradients, the new state)."""
    sent, ef = {}, {}
    for n, g in grads.items():
        e = ef_state[n]
        if g.dim() == 0:
            sent[n], ef[n] = g, e
            continue
        tot = g.float() + e
        deq = dequantize_rows(quantize_rows(tot))
        sent[n], ef[n] = deq.to(g.dtype), tot - deq
    return sent, ef


def init_ef_state(params: Mapping[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, device=p.device)
            for n, p in params.items()}
