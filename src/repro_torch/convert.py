"""Conversion from the reference's arrays to the port's tensors.

Takes numpy arrays (the caller turns JAX arrays into numpy), so this
module imports nothing of JAX. The conversion copies: `torch.from_numpy`
would alias host buffers.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch import resolve_device


def params_from_reference(tree: Mapping, device="cuda"
                          ) -> Dict[str, torch.Tensor]:
    """A `repro.models.model.init_params` tree of the dense or the moe
    family, as numpy arrays ({"layers": {...}, "tok_embed", "final_norm"[,
    "lm_head"]}), -> the flat name -> tensor dict `DenseLM(params=...)`
    or `MoELM(params=...)` takes (layer weights keep their stacked
    [L, ...] layout: a moe tree's "router", "we1", "we2", "we3", its FFN
    norm "mlp_norm", or "moe_norm" beside "mlp_norm", "w1", "w2", "w3"
    with `dense_residual`; gte-small's tree has tied embeddings, so no
    "lm_head", and a GELU FFN without "w3")."""
    dev = resolve_device(device)
    flat = dict(tree["layers"])
    flat.update({k: v for k, v in tree.items() if k != "layers"})
    return {k: torch.tensor(np.array(v), device=dev) for k, v in flat.items()}
