"""PyTorch + CUDA port of the MobileRAG system, held against `repro`.

The JAX package `repro` is the reference; this package computes the same
functions in PyTorch, with every Pallas kernel of the ported path replaced
by a hand-written CUDA kernel for Hopper (`kernels/csrc/`). It imports
neither `jax` nor anything under `repro.`.

Entry points take `device="cuda"` by default and raise when no GPU is
present (`resolve_device`); the CPU tests pass `device="cpu"` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device without a GPU is
    an error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev
