"""Architecture registry of the port: the reference's ten assigned
architectures and the paper's two models (`repro.configs.ARCH_IDS +
PAPER_IDS`), and the (architecture x shape) cells of the dry run."""
from __future__ import annotations

import importlib

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig

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


def cells(arch: str) -> list[ShapeConfig]:
    """The shapes `arch` takes in the dry run: every one of `SHAPES` but
    long_500k, which needs a sub-quadratic attention path."""
    cfg = get_config(arch)
    return [s for s in SHAPES.values()
            if s.name != "long_500k" or cfg.subquadratic]


def skipped_cells(arch: str) -> list[str]:
    return [] if get_config(arch).subquadratic else ["long_500k"]
