"""The port's model families behind one constructor (the serving part
of `repro.models.model`): `build_model` picks the family's model by
`cfg.family`, and `supports_paged` says whether the continuous engine
serves a config, with the reference's exclusions."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.dense import LM, DenseLM
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.mamba2 import Mamba2LM
from repro_torch.models.moe import MoELM
from repro_torch.models.rglru import RGLRULM

FAMILIES = {"dense": DenseLM, "moe": MoELM, "encdec": EncDecLM,
            "rglru": RGLRULM, "mamba2": Mamba2LM}


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
