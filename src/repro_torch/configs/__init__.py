"""Architecture registry of the port (the models it can run)."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCH_IDS = ["qwen25_0_5b", "h2o_danube_1_8b", "granite_moe_1b_a400m",
            "gte_small"]


def get_config(arch: str) -> ModelConfig:
    name = arch.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"{arch!r} is not ported (ported: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return get_config(arch).reduced()
