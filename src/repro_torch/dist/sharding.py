"""Logical-axis sharding on torch.distributed (the port of
`repro.dist.sharding`).

Models and the trainer name every tensor dimension with a *logical*
axis; this module owns the one mapping from logical axes to the axes of
whatever mesh (a `torch.distributed.device_mesh.DeviceMesh` with named
dimensions) is installed:

  logical      mesh axes                        carried by
  "batch"      ("pod", "data")                  data parallelism
  "fsdp"       ("data",) or ("pod", "data")     ZeRO-3 parameter shards
  "tp"         ("model",)                       tensor parallelism
  "expert"     ("model",)                       MoE expert parallelism
  "seq_sp"     ("model",)                       sequence parallelism
  "pod"        ("pod",)                         cross-pod placement

"fsdp" spans the pod axis only while `set_fsdp_spans_pods(True)` holds.

Every mapping is pruned against reality: mesh axes that do not exist on
the mesh, are already taken by an earlier dimension, or do not evenly
divide the dimension are dropped (that dimension is replicated).
`logical_to_spec` returns the reference's `PartitionSpec` entries as a
plain tuple (None, an axis name, or a tuple of names, major to minor);
`sharding_for` turns one into DTensor placements, one a mesh dimension:
`Shard(i)` on every mesh axis that splits tensor dimension i. A
dimension split over two mesh axes ("pod", "data") is cut by the first
(major) and then each part by the second, which is how DTensor orders
several `Shard(i)` over mesh dimensions taken left to right, so the
axes of an entry must come in the mesh's order. The stub meshes of the
tests work too: the pure-logic functions read only `mesh.shape` (a dict
of axis sizes, or a DeviceMesh's shape with its dimension names).

The mesh is ambient state installed with `use_mesh(mesh)`. With no mesh
installed `axis_size` is 1 and `shard` is the identity; `shard` is also
the identity on a one-device mesh and for a plain tensor (only a DTensor
carries a placement to change). There is no `shard_map`: the port's
collectives are explicit (`moe.ep_ffn`, `core.distributed`, the mesh
branch of `train.trainer`).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.convert import tree_map

# --------------------------------------------------------------- mesh state

_MESH_STACK: list = []
_FSDP_SPANS_PODS = [False]


def get_mesh():
    """The innermost mesh installed by `use_mesh`, or None off-mesh."""
    return _MESH_STACK[-1] if _MESH_STACK else None


@contextmanager
def use_mesh(mesh):
    """Install `mesh` as the ambient mesh for the dynamic extent."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def set_fsdp_spans_pods(flag: bool) -> None:
    """ZeRO-3 state spans the "pod" axis too (400B+ multi-pod configs)."""
    _FSDP_SPANS_PODS[0] = bool(flag)


def fsdp_spans_pods() -> bool:
    return _FSDP_SPANS_PODS[0]


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of `mesh` ({} for None): a DeviceMesh's shape by
    its dimension names, or a stub's `shape` dict."""
    if mesh is None:
        return {}
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def mesh_size(mesh) -> int:
    n = 1
    for s in mesh_shape(mesh).values():
        n *= int(s)
    return n


# ------------------------------------------------------- logical -> physical

_RULES = {
    "batch": ("pod", "data"),
    "tp": ("model",),
    "expert": ("model",),
    "seq_sp": ("model",),
    "pod": ("pod",),
    # raw mesh-axis names pass through (launch code occasionally uses them)
    "data": ("data",),
    "model": ("model",),
}


def mesh_axes_for(logical: Optional[str]) -> Tuple[str, ...]:
    """The mesh axes a logical axis maps to, before pruning."""
    if logical is None:
        return ()
    if logical == "fsdp":
        return ("pod", "data") if fsdp_spans_pods() else ("data",)
    try:
        return _RULES[logical]
    except KeyError:
        raise ValueError(f"unknown logical axis {logical!r}; "
                         f"expected one of {sorted(_RULES) + ['fsdp']}")


def axis_size(mesh, logical: Optional[str]) -> int:
    """Total device count behind a logical axis (1 off-mesh / unmapped)."""
    if mesh is None:
        return 1
    sizes = mesh_shape(mesh)
    n = 1
    for a in mesh_axes_for(logical):
        n *= int(sizes.get(a, 1))
    return n


Spec = Tuple[object, ...]       # entries: None | axis name | tuple of names


def logical_to_spec(mesh, axes: Sequence[Optional[str]],
                    shape: Optional[Sequence[int]] = None) -> Spec:
    """Map logical axes to PartitionSpec entries on `mesh`.

    Pruning rules (per dimension, in order): a mesh axis is kept only if
    it exists on `mesh`, was not already used by an earlier dimension,
    and, when `shape` is given, the accumulated shard count still divides
    the dimension. Dropped axes leave the dimension replicated.
    """
    sizes = mesh_shape(mesh)
    used: set = set()
    entries = []
    for i, lg in enumerate(axes):
        keep = []
        size = 1
        for a in mesh_axes_for(lg):
            asz = int(sizes.get(a, 0))
            if asz <= 0 or a in used:
                continue
            if shape is not None and (i >= len(shape) or
                                      shape[i] % (size * asz) != 0):
                continue
            keep.append(a)
            size *= asz
        used.update(keep)
        if not keep:
            entries.append(None)
        elif len(keep) == 1:
            entries.append(keep[0])
        else:
            entries.append(tuple(keep))
    return tuple(entries)


def _fit(axes: Sequence[Optional[str]], ndim: int
         ) -> Tuple[Optional[str], ...]:
    ax = tuple(axes)[:ndim]
    return ax + (None,) * (ndim - len(ax))


class NamedSharding(NamedTuple):
    """One tensor's placement on a mesh: its spec entries and the DTensor
    placements they give (one a mesh dimension)."""
    mesh: object
    spec: Spec
    placements: tuple


def placements_for(mesh, spec: Spec) -> tuple:
    """DTensor placements of spec entries on a DeviceMesh: `Shard(i)` on
    each mesh dimension that entry i names, `Replicate()` elsewhere. The
    axes of one entry must come in the mesh's order (major first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        dims = [names.index(a) for a in spec_axes(entry)]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {names}")
        for md in dims:
            out[md] = Shard(i)
    return tuple(out)


def sharding_for(mesh, *axes: Optional[str],
                 shape: Optional[Sequence[int]] = None) -> NamedSharding:
    """The placement of one tensor from its logical axes (shape-pruned;
    a spec shorter or longer than the rank is padded or cut)."""
    ax = _fit(axes, len(shape)) if shape is not None else axes
    spec = logical_to_spec(mesh, ax, shape=shape)
    return NamedSharding(mesh, spec, placements_for(mesh, spec))


def is_spec(x) -> bool:
    """A spec leaf: a tuple of logical axis names / None."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x)


def spec_tree_to_shardings(mesh, spec_tree, struct_tree):
    """A tree of NamedShardings from a logical-spec tree and the matching
    shape-bearing tree (tensors or meta tensors), pruned per leaf. A
    spec shorter (or longer) than a leaf's rank is padded (or cut) with
    replication, so scalar leaves may use `()`."""
    return tree_map(lambda spec, leaf: sharding_for(
        mesh, *spec, shape=tuple(leaf.shape)), spec_tree, struct_tree,
        is_leaf=is_spec)


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """`t` (the whole tensor, the same on every rank) as a DTensor placed
    by `sharding`, on the mesh's device type: each rank keeps its own
    part, cut locally (no collective)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = sharding.mesh
    t = t.to(mesh.device_type)
    rep = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, sharding.placements)


def shard(x, *axes: Optional[str]):
    """Constrain `x` to its logical placement; the identity off-mesh, on
    a one-device mesh and for a plain tensor. Extra axes beyond `x.ndim`
    are ignored and missing ones replicate."""
    mesh = get_mesh()
    if mesh is None or mesh_size(mesh) == 1:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    sh = sharding_for(mesh, *axes, shape=tuple(x.shape))
    return x.redistribute(mesh, sh.placements)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_index(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's part, the number of parts) of a dimension split over
    `axes`, major to minor."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = mesh_shape(mesh)
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    return idx, n


def batch_part(mesh, n: int) -> Tuple[int, int, Tuple[str, ...]]:
    """This rank's rows [start, stop) of n rows on "batch" (over ("pod",
    "data"), as far as they divide n: `logical_to_spec`'s pruning), and
    the mesh axes that split them (() off-mesh: all n rows)."""
    if mesh is None:
        return 0, n, ()
    axes = spec_axes(logical_to_spec(mesh, ("batch",), (n,))[0])
    idx, parts = local_index(mesh, axes)
    return idx * (n // parts), (idx + 1) * (n // parts), axes


def local_slice(t: torch.Tensor, mesh, spec: Spec) -> torch.Tensor:
    """This rank's part of the whole tensor `t` under spec entries `spec`
    (a view: each split dimension cut to its own chunk)."""
    for i, entry in enumerate(spec):
        idx, n = local_index(mesh, spec_axes(entry))
        if n > 1:
            size = t.shape[i] // n
            t = t.narrow(i, idx * size, size)
    return t


def spec_of(t) -> Spec:
    """The spec entries of DTensor `t`'s placements (the inverse of
    `placements_for`)."""
    from torch.distributed.tensor import Shard
    names = t.device_mesh.mesh_dim_names
    axes = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            axes[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in axes)


def from_local(local: torch.Tensor, like):
    """A DTensor of this rank's part `local`, placed and shaped as the
    DTensor `like`."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())
