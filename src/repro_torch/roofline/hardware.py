"""The card the port's cost model prices work on, from its datasheet:
NVIDIA H100 SXM5 80GB at 700 W. Every peak the port states (the dry
run's terms, the kernels' bounds in `kernels.cost`, chip_smoke's bound
column) is read from here.

The production mesh is laid onto 8-GPU nodes rank-major: rank r sits on
node r // GPUS_PER_NODE. A collective whose ranks share a node moves at
NVLink 4's rate; one that spans nodes moves at the rate of one NIC a GPU
(400 Gb/s), the slowest link of its ring. The 16 x 16 mesh over
("data", "model") is 32 nodes: a "model" group (16 consecutive ranks)
spans two nodes, a "data" group (stride 16) sixteen.
"""
from __future__ import annotations

from typing import Iterable

import torch

NAME = "NVIDIA H100 SXM5 80GB"
POWER_W = 700
BF16_FLOPS_S = 989e12      # bf16 on the tensor cores, dense
F32_FLOPS_S = 67e12        # f32 outside the tensor cores (TF32 is off)
HBM_BYTES_S = 3.35e12      # HBM3
HBM_BYTES = 80e9
NVLINK_BYTES_S = 450e9     # NVLink 4, each way, within an 8-GPU node
NIC_BYTES_S = 50e9         # one 400 Gb/s NIC a GPU, between nodes
GPUS_PER_NODE = 8

PEAKS = {"bf16": BF16_FLOPS_S, "f32": F32_FLOPS_S}


def peak_kind(dtype: torch.dtype) -> str:
    """The peak that work in `dtype` runs at: "bf16" for the 16-bit
    floats (the tensor cores), "f32" for the rest."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def node_of(rank: int) -> int:
    return rank // GPUS_PER_NODE


def link_bytes_s(ranks: Iterable[int]) -> float:
    """The rate of a collective over the global `ranks`: NVLink's when
    they share a node, the NIC's when they do not."""
    return NVLINK_BYTES_S if len({node_of(r) for r in ranks}) <= 1 \
        else NIC_BYTES_S


def seconds(flops_by_kind, nbytes: float) -> tuple:
    """(t_compute, t_memory) of work: FLOPs by peak kind over their
    peaks, bytes over the HBM rate."""
    return (sum(f / PEAKS[k] for k, f in flops_by_kind.items()),
            nbytes / HBM_BYTES_S)
