"""The port's model families behind one constructor (the serving part
of `repro.models.model`): `build_model` picks `DenseLM` or `MoELM` by
`cfg.family`, and `supports_paged` says whether the continuous engine
serves a config, with the reference's exclusions."""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.models.dense import DenseLM
from repro_torch.models.moe import MoELM

FAMILIES = {"dense": DenseLM, "moe": MoELM}


def supports_paged(cfg: ModelConfig) -> bool:
    """Whether the paged path (continuous batching) covers `cfg`: every
    dense config, sliding-window (ring pages) and int8-KV included, and
    MoE without either, since the reference's MoE wave path (the parity
    baseline and `continuous=False`) implements neither ring rolls nor
    KV quantization. A non-causal encoder (gte-small) is excluded, as
    in the reference."""
    if not cfg.causal:
        return False
    if cfg.family == "dense":
        return True
    return (cfg.family == "moe" and not cfg.kv_quant
            and cfg.sliding_window is None)


def build_model(cfg: ModelConfig, **kw) -> DenseLM:
    """The model of `cfg.family` (keywords: `DenseLM`'s device, seed,
    params)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not ported "
                         f"(ported: {sorted(FAMILIES)})")
    return FAMILIES[cfg.family](cfg, **kw)
