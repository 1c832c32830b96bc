"""Host-side checkpoints with atomic directory commits (the port of
`repro.dist.checkpoint`, in its on-disk format byte for byte).

Layout (one directory per step):

  <dir>/step_00000042/manifest.json      # shapes/dtypes + leaf file list
  <dir>/step_00000042/arrays/00000.bin   # raw little-endian leaf bytes

Writers stage everything under ``step_XXXXXXXX.tmp`` and commit with one
``os.replace`` (`core.store.atomic_replace_dir`); readers
(`available_steps`, `latest_step`) trust only directories whose manifest
exists at the final path (`core.store.numbered_dirs`), so a crash
mid-write leaves at worst a stale ``.tmp`` that the next save of the
same step overwrites.

Leaves are numbered in `convert.tree_leaves` order, which is
`jax.tree.leaves` order (dict keys sorted at every level): save the
trainer's state as `convert.state_tree(masters, opt_state)`, and the
files are the reference's for the same `(params, opt_state)`. The
manifest carries numpy's dtype names ("float32", "int32", "int8",
"bfloat16", ...); bfloat16 bytes are written and read as torch's
bfloat16 (numpy has none), never through float32. So the port restores
the reference's checkpoints and the reference's `restore_host` reads the
port's, bit for bit.

A mesh's state (DTensor leaves) is gathered whole and written once, by
rank 0. `save(..., blocking=False)` snapshots the tree to host memory on
the caller's thread (once it returns, the training loop may overwrite every
buffer) and writes on a background thread, returned started; its
`join()` re-raises the writer's error.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.convert import tree_leaves, tree_map, tree_unflatten
from repro_torch.core.store import atomic_replace_dir, numbered_dirs

_MANIFEST = "manifest.json"

# numpy's dtype names (the manifest's) <-> torch dtypes
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _host_copy(x) -> torch.Tensor:
    """A CPU tensor holding a copy of leaf x (a tensor, a DTensor whole,
    a numpy array or a Python scalar, as numpy would type it)."""
    if _is_dtensor(x):
        return x.full_tensor().to("cpu", copy=True).contiguous()
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).contiguous()
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 array
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bytes_of(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a contiguous CPU tensor as a uint8 array (no
    copy)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(np.uint8)


class _SaveThread(threading.Thread):
    """Writer thread that re-raises its failure from join(): an async
    save that died (disk full, permissions) must surface to the caller,
    since a silently lost checkpoint voids the durability contract."""

    def __init__(self, fn, name: str):
        super().__init__(name=name)
        self._fn = fn
        self._exc: Optional[BaseException] = None

    def run(self):
        try:
            self._fn()
        except BaseException as e:  # noqa: BLE001 - transported to join()
            self._exc = e

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if self._exc is not None and not self.is_alive():
            exc, self._exc = self._exc, None
            raise exc


def save(ckpt_dir: str, step: int, tree: Any, *,
         blocking: bool = True) -> Optional[threading.Thread]:
    """Write `tree` as checkpoint `step`. Returns the writer thread when
    ``blocking=False`` (already started; join() to wait), else None.

    A tree of DTensors (a mesh's state) is saved by every rank of the
    default process group together: each gathers the leaves whole, rank
    0 writes (the others return None), and a blocking save returns on
    every rank only once the checkpoint is committed."""
    leaves = tree_leaves(tree)
    on_mesh = any(_is_dtensor(x) for x in leaves)
    # device -> host snapshot on the caller's thread
    host = [_host_copy(x) for x in leaves]
    for t in host:
        if t.dtype not in _NAMES:
            raise TypeError(f"checkpoint leaf of dtype {t.dtype}")

    def write():
        final = _step_dir(ckpt_dir, step)
        tmp = final + ".tmp"
        arrays = os.path.join(tmp, "arrays")
        os.makedirs(arrays, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, t in enumerate(host):
            fname = f"{i:05d}.bin"
            with open(os.path.join(arrays, fname), "wb") as f:
                f.write(_bytes_of(t))
            manifest["leaves"].append({"file": fname,
                                       "shape": list(t.shape),
                                       "dtype": _NAMES[t.dtype]})
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        atomic_replace_dir(tmp, final)  # re-save of the same step is ok

    if on_mesh and dist.get_rank() != 0:
        if blocking:
            dist.barrier()
        return None
    if blocking:
        write()
        if on_mesh:
            dist.barrier()
        return None
    th = _SaveThread(write, name=f"ckpt-save-{step}")
    th.start()
    return th


def _read_leaf(path: str, entry: dict) -> torch.Tensor:
    if entry["dtype"] not in _DTYPES:
        raise ValueError(f"{path}: unknown dtype {entry['dtype']!r}")
    dtype = _DTYPES[entry["dtype"]]
    shape = tuple(entry["shape"])
    raw = torch.empty(int(np.prod(shape)) * dtype.itemsize, dtype=torch.uint8)
    with open(path, "rb") as f:
        n = f.readinto(raw.numpy())
        if n != raw.numel() or f.read(1):
            raise ValueError(f"{path}: {os.path.getsize(path)} bytes where "
                             f"{shape} {entry['dtype']} takes {raw.numel()}")
    return raw.view(dtype).reshape(shape)


def restore_host(ckpt_dir: str, step: int, like: Any) -> Any:
    """Checkpoint `step` as CPU tensors in `like`'s structure (dtypes from
    the manifest, bit-identical to the save). A leaf of `like` with a
    shape (a tensor, an array, a meta tensor) must match the saved
    one's."""
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    slots = tree_leaves(like)
    entries = manifest["leaves"]
    if len(slots) != len(entries):
        raise ValueError(
            f"checkpoint {d} has {len(entries)} leaves, expected "
            f"{len(slots)} (model/optimizer structure changed?)")
    out: List[torch.Tensor] = []
    for i, (e, want) in enumerate(zip(entries, slots)):
        shape = getattr(want, "shape", None)
        if shape is not None and tuple(shape) != tuple(e["shape"]):
            raise ValueError(f"checkpoint {d} leaf {i}: shape {e['shape']}"
                             f", expected {tuple(shape)}")
        out.append(_read_leaf(os.path.join(d, "arrays", e["file"]), e))
    return tree_unflatten(like, out)


def restore(ckpt_dir: str, step: int, like: Any, device="cuda") -> Any:
    """Checkpoint `step` as tensors on `device` (no mesh placement; see
    `fault.reshard_restore` for a mesh)."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev),
                    restore_host(ckpt_dir, step, like))


def available_steps(ckpt_dir: str) -> list:
    """Committed checkpoint steps, ascending (partial writes, directories
    without a manifest, are ignored, as uncommitted index generations
    are)."""
    return numbered_dirs(ckpt_dir, "step_", _MANIFEST)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None
