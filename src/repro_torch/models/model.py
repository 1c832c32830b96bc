"""The port's model families behind one constructor (the serving part
of `repro.models.model`): `build_model` picks the family's model by
`cfg.family`, and `supports_paged` says whether the continuous engine
serves a config, with the reference's exclusions.

Training (the rest of `repro.models.model`): the trainer owns f32
master weights (name -> tensor, the model's parameter names; `masters`
copies a model's, `convert.params_from_reference` converts the
reference's). `loss_fn` casts them to the compute dtype
(`cast_params`, differentiable, so gradients reach the masters), binds
them to the model (`dense.bound`) and runs its training forward, then
the reference's masked cross entropy with the optional z-loss and the
MoE aux loss. Batches are name -> array dicts (`make_sample_batch`),
numpy until `to_device` moves them.

Sharding (the rest of it): `param_specs`, `batch_specs` and
`cache_specs` give each tensor's logical axes (`dist.sharding`) by the
port's names; `param_shapes` and `batch_struct` the shapes they are
pruned against.

Tensor-parallel serving (the dense family): `tp_layout(cfg, tp, rank)`
is rank r's part of the model on a "model" axis of size tp, the cut of
each weight from `param_specs`' "tp" entries (`TPLayout`);
`param_shapes(cfg, layout)` the shapes of that part.
"""
from __future__ import annotations

import re
from types import SimpleNamespace
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.dist import sharding as sh
from repro_torch.models.dense import LM, N_IMG, DenseLM, bound, keeps_f32
from repro_torch.models.encdec import DEC_RATIO, EncDecLM
from repro_torch.models.mamba2 import Mamba2LM
from repro_torch.models.moe import MoELM
from repro_torch.models.rglru import RGLRULM

FAMILIES = {"dense": DenseLM, "moe": MoELM, "encdec": EncDecLM,
            "rglru": RGLRULM, "mamba2": Mamba2LM}

IGNORE_LABEL = -100


def supports_paged(cfg: ModelConfig) -> bool:
    """Whether the paged path (continuous batching) covers `cfg`, as the
    reference's `supports_paged` says: the dense and MoE text decoders,
    every dense one (sliding-window ring pages and int8 KV included) and
    MoE without either, since the reference's MoE wave path (the parity
    baseline and `continuous=False`) implements neither ring rolls nor KV
    quantization. Excluded: non-text inputs (whisper's frames, qwen2-vl's
    patches), M-RoPE, a non-causal encoder (gte-small), and the encdec,
    rglru and mamba2 families (their caches are not paged KV)."""
    if cfg.modality != "text" or not cfg.causal or cfg.rope_type == "mrope":
        return False
    if cfg.family == "dense":
        return True
    return (cfg.family == "moe" and not cfg.kv_quant
            and cfg.sliding_window is None)


def build_model(cfg: ModelConfig, **kw) -> LM:
    """The model of `cfg.family` (keywords: `LM`'s device, seed,
    params)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} "
                         f"(families: {sorted(FAMILIES)})")
    return FAMILIES[cfg.family](cfg, **kw)


# ------------------------------------------------------------- training


def masters(model: LM) -> Dict[str, torch.Tensor]:
    """f32 copies of the model's weights, the trainer's masters."""
    return {n: p.detach().float().clone() for n, p in model.named_parameters()}


def count_params(params: Mapping[str, torch.Tensor]) -> int:
    return sum(t.numel() for t in params.values())


def cast_params(params: Mapping[str, torch.Tensor], dtype
                ) -> Dict[str, torch.Tensor]:
    """The reference's mixed-precision policy: every f32 tensor to the
    compute `dtype`, but the F32_KEEP parameters (`dense.keeps_f32`, the
    recurrences' decay and skip terms, under any prefix); differentiable,
    so gradients flow to the f32 masters. (The reference matches
    F32_KEEP against the last key of its tree, so it casts rglru's
    stacked "s{i}_lam" in bf16 runs; the port keeps it f32, as its
    serving weights do.)"""
    return {n: t.to(dtype) if t.dtype == torch.float32 and not keeps_f32(n)
            else t for n, t in params.items()}


def to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """A batch of arrays on `device`: integer arrays as int64, floating
    ones as f32."""
    out = {}
    for n, a in batch.items():
        t = torch.as_tensor(a)
        t = t.long() if not t.is_floating_point() else t.float()
        out[n] = t.to(device)
    return out


def loss_fn(model: LM, params: Mapping[str, torch.Tensor], batch: Mapping,
            *, aux_coef: float = 0.01, z_coef: float = 0.0):
    """Causal-LM cross entropy of `model` on the weights `params` (f32
    masters, cast by `cast_params` to the config's dtype and bound to the
    model for the forward), as the reference's `loss_fn`: the logits in
    f32, the mean of logsumexp - the label's logit over the labels that
    are not IGNORE_LABEL (divided by max(count, 1)); + z_coef * the mean
    of logsumexp^2 over them; + aux_coef * the MoE aux loss. `batch`
    holds tensors on the model's device (`to_device`). Returns (loss,
    metrics: "nll", "ntokens", "loss", and "z_loss", "moe_aux" where they
    apply)."""
    with bound(model, cast_params(params, model.cfg.torch_dtype)):
        logits, aux = model(batch)
    labels = batch["labels"]
    logits = logits.float()
    valid = labels != IGNORE_LABEL
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, safe[..., None])[..., 0]
    nll = (lse - true_logit) * valid
    ntok = valid.sum().clamp(min=1)
    loss = nll.sum() / ntok
    metrics = {"nll": loss, "ntokens": ntok}
    if z_coef:
        zl = z_coef * torch.sum(lse.square() * valid) / ntok
        loss = loss + zl
        metrics["z_loss"] = zl
    if aux is not None:
        metrics["moe_aux"] = aux
        loss = loss + aux_coef * aux
    metrics["loss"] = loss
    return loss, metrics


def make_sample_batch(cfg: ModelConfig, B: int, S: int, seed: int = 0
                      ) -> Dict[str, np.ndarray]:
    """A random training batch of numpy arrays from `seed`: tokens and
    labels [B, S] int32 in the vocab; a vision config's patches [B,
    N_IMG, d] f32 with the patch positions' labels IGNORE_LABEL (S >
    N_IMG); an encoder-decoder's frames [B, S, d] f32 with dec_tokens
    and labels [B, max(S // DEC_RATIO, 8)]."""
    rng = np.random.default_rng(seed)
    V, d = cfg.vocab_size, cfg.d_model
    if cfg.family == "encdec":
        sd = max(S // DEC_RATIO, 8)
        return {"frames": rng.standard_normal((B, S, d)).astype(np.float32),
                "dec_tokens": rng.integers(0, V, (B, sd)).astype(np.int32),
                "labels": rng.integers(0, V, (B, sd)).astype(np.int32)}
    out = {"tokens": rng.integers(0, V, (B, S)).astype(np.int32),
           "labels": rng.integers(0, V, (B, S)).astype(np.int32)}
    if cfg.modality == "vision":
        if S <= N_IMG:
            raise ValueError(f"a vision batch needs S > {N_IMG}")
        out["patches"] = rng.standard_normal((B, N_IMG, d)).astype(
            np.float32)
        out["labels"][:, :N_IMG] = IGNORE_LABEL
    return out


# ------------------------------------------------------- sharding specs

# the logical axes of each parameter by its name without a prefix (the
# reference's `ParamDef` axes, `models/common.py` and each family's
# `defs`); mamba2's conv_w differs from rglru's
_AXES = {
    "tok_embed": ("tp", "fsdp"), "final_norm": ("fsdp",),
    "lm_head": ("fsdp", "tp"), "patch_proj": ("fsdp", "tp"),
    "frame_proj": ("fsdp", "tp"),
    "attn_norm": (None, "fsdp"), "mlp_norm": (None, "fsdp"),
    "moe_norm": (None, "fsdp"), "norm": (None, "fsdp"),
    "wq": (None, "fsdp", "tp"), "wk": (None, "fsdp", "tp"),
    "wv": (None, "fsdp", "tp"), "wo": (None, "tp", "fsdp"),
    "bq": (None, "tp"), "bk": (None, "tp"), "bv": (None, "tp"),
    "w1": (None, "fsdp", "tp"), "w3": (None, "fsdp", "tp"),
    "w2": (None, "tp", "fsdp"),
    "router": (None, "fsdp", None),
    "we1": (None, "expert", "fsdp", None),
    "we3": (None, "expert", "fsdp", None),
    "we2": (None, "expert", None, "fsdp"),
    "w_xz": (None, "fsdp", "tp"), "w_bc": (None, "fsdp", None),
    "w_dt": (None, "fsdp", "tp"), "dt_bias": (None, "tp"),
    "A_log": (None, "tp"), "D": (None, "tp"), "ssm_norm": (None, "tp"),
    "w_out": (None, "tp", "fsdp"), "conv_w": (None, None, "tp"),
    "w_in": (None, "fsdp", "tp"), "w_gate": (None, "fsdp", "tp"),
    "w_rx": (None, "fsdp", "tp"), "b_rx": (None, "tp"), "lam": (None, "tp"),
}
_FAMILY_AXES = {"mamba2": {"conv_w": (None, None, None)}}
_PREFIX = re.compile(r"^(?:enc_|dec_)?(?:s\d+_|tail\d+_)?(?:cross_)?")


def param_shapes(cfg: ModelConfig, layout: Optional["TPLayout"] = None
                 ) -> Dict[str, tuple]:
    """name -> shape of every parameter of `cfg`'s model (of the rank's
    part under a tensor-parallel `layout`)."""
    shapes = {n: shape for n, (shape, _) in
              FAMILIES[cfg.family].shapes(cfg).items()}
    if layout is None:
        return shapes
    return {n: layout.local_shape(n, s) for n, s in shapes.items()}


def param_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> logical axes of every parameter (the reference's
    `param_specs`, flattened to the port's names)."""
    axes = {**_AXES, **_FAMILY_AXES.get(cfg.family, {})}
    return {n: axes[_PREFIX.sub("", n)] for n in param_shapes(cfg)}


def batch_struct(cfg: ModelConfig, shape: ShapeConfig
                 ) -> Dict[str, torch.Tensor]:
    """Meta tensors (shape and dtype, no storage) of one train batch of
    `shape`, as the reference's `batch_struct`."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")
    if cfg.family == "encdec":
        return {"frames": meta((B, S, cfg.d_model), torch.bfloat16),
                "dec_tokens": meta((B, S // DEC_RATIO)),
                "labels": meta((B, S // DEC_RATIO))}
    out = {"tokens": meta((B, S)), "labels": meta((B, S))}
    if cfg.modality == "vision":
        out["patches"] = meta((B, N_IMG, cfg.d_model), torch.bfloat16)
    return out


def batch_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical axes of each batch input (rows on "batch")."""
    if cfg.family == "encdec":
        return {"frames": ("batch", None, None),
                "dec_tokens": ("batch", None), "labels": ("batch", None)}
    out = {"tokens": ("batch", None), "labels": ("batch", None)}
    if cfg.modality == "vision":
        out["patches"] = ("batch", None, None)
    return out


def cache_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical axes of the serving cache's tensors by their names (the
    reference's `cache_specs` of each family)."""
    kv = (None, "batch", None, "tp", None)
    if cfg.family == "encdec":
        return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv}
    if cfg.family == "mamba2":
        return {"h": (None, "batch", "tp", None, None),
                "conv": (None, "batch", None, None)}
    if cfg.family == "rglru":
        pat = cfg.rglru.pattern
        specs: Dict[str, tuple] = {}
        for i, c in enumerate(pat):
            if c == "r":
                specs[f"s{i}_h"] = (None, "batch", "tp")
                specs[f"s{i}_conv"] = (None, "batch", None, "tp")
            else:
                specs[f"s{i}_k"] = kv
                specs[f"s{i}_v"] = kv
        for j in range(cfg.num_layers % len(pat)):
            if pat[j] == "r":
                specs[f"tail{j}_h"] = ("batch", "tp")
                specs[f"tail{j}_conv"] = ("batch", None, "tp")
            else:
                specs[f"tail{j}_k"] = kv[1:]
                specs[f"tail{j}_v"] = kv[1:]
        return specs
    if cfg.kv_quant:
        return {"k": kv, "v": kv, "k_s": kv[:-1], "v_s": kv[:-1]}
    return {"k": kv, "v": kv}


# ------------------------------------------------ tensor-parallel serving

# the attention weights, cut on head boundaries only: the query side by
# query heads, the kv side by kv heads (a dimension of heads x head_dim)
Q_SIDE = ("wq", "bq", "wo")
KV_SIDE = ("wk", "wv", "bk", "bv")
# "tp" entries that stay whole: the vision stub's projection (its output
# would need a gather before the tokens' embeddings)
TP_WHOLE = ("patch_proj",)


class TPLayout(NamedTuple):
    """Rank `rank`'s part of a dense model on a "model" axis of size
    `tp`. `cuts`: name -> (dim, start, length) of every weight cut (the
    others are whole on every rank). The attention splits (`attn`) when
    the rank's `heads` query heads (from `q0`) all read its `kv_heads`
    kv heads (from `kv0`); the FFN (`ffn`: w1, w3 on their outputs, w2 on
    its input) and the vocabulary (`vocab`: tok_embed's rows, lm_head's
    columns) where they divide."""
    tp: int
    rank: int
    attn: bool
    heads: int
    kv_heads: int
    q0: int
    kv0: int
    ffn: bool
    vocab: bool
    cuts: Dict[str, Tuple[int, int, int]]

    def local_shape(self, name: str, shape: tuple) -> tuple:
        """The rank's shape of parameter `name` of whole `shape`."""
        if name not in self.cuts:
            return tuple(shape)
        dim, _, n = self.cuts[name]
        return tuple(shape[:dim]) + (n,) + tuple(shape[dim + 1:])

    def part(self, name: str) -> int:
        """Which part of parameter `name` the rank holds (0 for a whole
        one): the ranks that hold the same part hold the same values."""
        if name not in self.cuts:
            return 0
        _, start, n = self.cuts[name]
        return start // n


def splits_heads(H: int, G: int, tp: int) -> bool:
    """Whether tp ranks split the attention on head boundaries: H % tp
    == 0, and G % tp == 0 (each rank G / tp kv heads) or tp % G == 0
    (kv head g on the tp / G ranks of its query heads)."""
    return H % tp == 0 and (G % tp == 0 or tp % G == 0)


def tp_layout(cfg: ModelConfig, tp: int, rank: int) -> TPLayout:
    """Rank `rank` of a "model" axis of size `tp`: the dimension of each
    weight that `param_specs` names "tp" (pruned by
    `sharding.logical_to_spec`: cut where tp divides it), with the
    attention cut on head boundaries only (`splits_heads`; else whole
    on every rank). Where the kv heads do not split, rank r holds kv
    head floor(r G / tp), the group of its H / tp query heads."""
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} of a tp {tp} axis")
    H, G, hd = cfg.num_heads, max(cfg.num_kv_heads, 1), \
        cfg.resolved_head_dim
    attn = splits_heads(H, G, tp)
    heads, kv_heads = (H // tp, max(G // tp, 1)) if attn else (H, G)
    q0, kv0 = (rank * heads, rank * G // tp) if attn else (0, 0)
    model = SimpleNamespace(shape={"model": tp})
    shapes = param_shapes(cfg)
    cuts = {}
    for name, axes in param_specs(cfg).items():
        base = _PREFIX.sub("", name)
        if "tp" not in axes or base in TP_WHOLE:
            continue
        dim = axes.index("tp")
        if base in Q_SIDE + KV_SIDE:
            if attn:
                first, n = (q0, heads) if base in Q_SIDE else (kv0, kv_heads)
                cuts[name] = (dim, first * hd, n * hd)
            continue
        spec = sh.logical_to_spec(model, axes, shapes[name])
        if spec[dim] is not None:
            n = shapes[name][dim] // tp
            cuts[name] = (dim, rank * n, n)
    return TPLayout(tp, rank, attn, heads, kv_heads, q0, kv0,
                    "w1" in cuts, "tok_embed" in cuts, cuts)
