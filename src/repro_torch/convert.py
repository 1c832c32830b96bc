"""Conversion from the reference's arrays to the port's tensors.

Takes numpy arrays (the caller turns JAX arrays into numpy), so this
module imports nothing of JAX. The conversion copies: `torch.from_numpy`
would alias host buffers.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device


def flat_names(tree: Mapping) -> Dict[str, object]:
    """The reference's parameter tree flattened to the port's names:
    "layers" entries keep their names; the encoder-decoder's
    "enc_layers" and "dec_layers" entries take the prefixes "enc_" and
    "dec_"; any other sub-tree (the rglru's "tail{j}" layers) prefixes
    its name and "_"; top-level arrays ("tok_embed", "final_norm",
    "lm_head", "patch_proj", "frame_proj") keep their names. An int8
    moment ({"q", "s"}, `train.optimizer.quantize_rows`) is one value."""
    flat: Dict[str, object] = {}
    for key, val in tree.items():
        if not isinstance(val, Mapping) or set(val) == {"q", "s"}:
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


def shard_params(params: Mapping[str, torch.Tensor], cfg, tp: int,
                 rank: int) -> Dict[str, torch.Tensor]:
    """Whole parameters of a dense `cfg` (the port's, or the reference's
    converted by `params_from_reference`) -> rank `rank`'s part on a
    "model" axis of size `tp` (`models.model.tp_layout`): each cut
    weight narrowed to the rank's heads, FFN columns or rows, or
    vocabulary range (views, no copy), the rest as they are."""
    from repro_torch.models.model import tp_layout
    cuts = tp_layout(cfg, tp, rank).cuts
    return {n: t.narrow(*cuts[n]) if n in cuts else t
            for n, t in params.items()}


# top-level entries of every family's reference tree (`embed_defs`)
TOP_LEVEL = ("tok_embed", "final_norm", "lm_head", "patch_proj", "frame_proj")
_TAIL = re.compile(r"^(tail\d+)_(.+)$")


def nest_names(flat: Mapping) -> Dict[str, object]:
    """The inverse of `flat_names`: a dict keyed by the port's flat
    parameter names (parameters, moments, gradients, specs) nested as the
    reference's tree: TOP_LEVEL names as they are, "enc_" and "dec_"
    names under "enc_layers" and "dec_layers", "tail{j}_" names under
    "tail{j}", every other name under "layers"."""
    out: Dict[str, object] = {}
    for name, val in flat.items():
        if name in TOP_LEVEL:
            out[name] = val
            continue
        m = _TAIL.match(name)
        if m:
            top, sub = m.group(1), m.group(2)
        elif name.startswith(("enc_", "dec_")):
            top, sub = name[:3] + "_layers", name[4:]
        else:
            top, sub = "layers", name
        out.setdefault(top, {})[sub] = val
    return out


def state_tree(masters: Mapping, opt_state: Mapping) -> tuple:
    """The trainer's state (flat masters, and AdamW's {"m", "v": flat,
    "step"}) as the reference's `(params, opt_state)` tree, whose leaves
    in `tree_leaves` order are the reference's `jax.tree.leaves` order:
    dict keys sorted at every level, so "final_norm" < "layers/..." <
    "lm_head" < "tok_embed", "m" < "step" < "v", and an int8 moment's
    "q" < "s". The checkpoints of `dist.checkpoint` number their leaves
    in that order."""
    return (nest_names(masters),
            {"m": nest_names(opt_state["m"]), "step": opt_state["step"],
             "v": nest_names(opt_state["v"])})


def state_from_tree(tree) -> tuple:
    """(masters, opt_state) with flat names from a `state_tree`-shaped
    tree (the inverse of `state_tree`)."""
    params, opt = tree
    return (flat_names(params),
            {"m": flat_names(opt["m"]), "v": flat_names(opt["v"]),
             "step": opt["step"]})


# ------------------------------------------------------------ tree walks


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> List:
    """The leaves of nested dicts, tuples and lists in `jax.tree.leaves`
    order: a dict's values by sorted key, a sequence's in order; None is
    an empty subtree; anything else (a tensor, an array, a scalar) is a
    leaf, as is any node for which `is_leaf` says so."""
    out: List = []

    def walk(x):
        if is_leaf is not None and is_leaf(x):
            out.append(x)
        elif isinstance(x, Mapping):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif x is not None:
            out.append(x)
    walk(tree)
    return out


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """fn over the leaves of `tree` (and the matching nodes of `rest`,
    which share its structure down to its leaves), rebuilt in `tree`'s
    structure (dicts keep their key order; named tuples their type)."""
    def walk(x, *ys):
        if is_leaf is not None and is_leaf(x):
            return fn(x, *ys)
        if isinstance(x, Mapping):
            return {k: walk(x[k], *(y[k] for y in ys)) for k in x}
        if isinstance(x, (tuple, list)):
            vals = [walk(v, *(y[i] for y in ys)) for i, v in enumerate(x)]
            if isinstance(x, list):
                return vals
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        if x is None:
            return None
        return fn(x, *ys)
    return walk(tree, *rest)


def tree_unflatten(like, leaves: Sequence):
    """`like`'s structure with its leaves (in `tree_leaves` order)
    replaced by `leaves`."""
    n = len(tree_leaves(like))
    if n != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of {n}")
    it = iter(leaves)

    # a dict's values in sorted-key order, so leaf i lands where
    # tree_leaves found it
    def walk(x):
        if isinstance(x, Mapping):
            vals = {k: walk(x[k]) for k in sorted(x)}
            return {k: vals[k] for k in x}
        if isinstance(x, (tuple, list)):
            vals = [walk(v) for v in x]
            if isinstance(x, list):
                return vals
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        if x is None:
            return None
        return next(it)
    return walk(like)
