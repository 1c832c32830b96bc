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


def flat_names(tree: Mapping) -> Dict[str, object]:
    """The reference's parameter tree flattened to the port's names:
    "layers" entries keep their names; the encoder-decoder's
    "enc_layers" and "dec_layers" entries take the prefixes "enc_" and
    "dec_"; any other sub-tree (the rglru's "tail{j}" layers) prefixes
    its name and "_"; top-level arrays ("tok_embed", "final_norm",
    "lm_head", "patch_proj", "frame_proj") keep their names."""
    flat: Dict[str, object] = {}
    for key, val in tree.items():
        if not isinstance(val, Mapping):
            flat[key] = val
            continue
        if key == "layers":
            prefix = ""
        elif key.endswith("_layers"):
            prefix = key[:-len("layers")]
        else:
            prefix = key + "_"
        flat.update({prefix + k: v for k, v in val.items()})
    return flat


def params_from_reference(tree: Mapping, device="cuda"
                          ) -> Dict[str, torch.Tensor]:
    """A `repro.models.model.init_params` tree of any family, as numpy
    arrays, -> the flat name -> tensor dict the family's model takes
    (`models.model.build_model(cfg, params=...)`; `flat_names` gives the
    names). Layer weights keep their stacked [L, ...] layout: a dense or
    moe tree's "layers" (the moe's "router", "we1", "we2", "we3", its
    FFN norm "mlp_norm", or "moe_norm" beside "mlp_norm", "w1", "w2",
    "w3" with `dense_residual`), the mamba2 "layers", the rglru's
    "s{i}_" sub-layers [NB, ...] and "tail{j}" layers [1, ...], the
    encoder-decoder's "enc_layers" and "dec_layers"."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.array(v), device=dev)
            for k, v in flat_names(tree).items()}
