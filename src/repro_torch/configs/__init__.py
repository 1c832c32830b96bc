"""Architecture registry of the port: the reference's ten assigned
architectures and the paper's two models (`repro.configs.ARCH_IDS +
PAPER_IDS`)."""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

ARCH_IDS = [
    "arctic_480b",
    "granite_moe_1b_a400m",
    "qwen2_72b",
    "mistral_large_123b",
    "nemotron_4_15b",
    "h2o_danube_1_8b",
    "whisper_small",
    "qwen2_vl_2b",
    "recurrentgemma_9b",
    "mamba2_780m",
    "gte_small",
    "qwen25_0_5b",
]


def get_config(arch: str) -> ModelConfig:
    name = arch.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"{arch!r} is not a configuration of the repo "
                       f"({ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return get_config(arch).reduced()
