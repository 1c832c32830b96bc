"""Mesh builders (the port of `repro.launch.mesh`) on
`torch.distributed.device_mesh.init_device_mesh`.

Functions, never module-level constants, so importing this module
touches no process group. Each needs the default process group up with
as many ranks as the mesh has devices (`torch.distributed.
init_process_group`, given its address, world size and rank).
"""
from __future__ import annotations


def _mesh(shape, axes, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 single pod (256 devices) or 2 x 16 x 16 across two pods
    (512): `config.MeshConfig.multi_pod`."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_test_mesh(data: int = 2, tp: int = 2, pod: int = 1,
                   device_type: str = "cuda"):
    """A small mesh over ("data", "model"), or ("pod", "data", "model")
    with pod > 1: the multi-rank tests' 2 x 2 on gloo, and (1, 1) on one
    H100."""
    if pod > 1:
        return _mesh((pod, data, tp), ("pod", "data", "model"), device_type)
    return _mesh((data, tp), ("data", "model"), device_type)
