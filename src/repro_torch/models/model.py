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
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.config import ModelConfig
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
