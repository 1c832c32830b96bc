"""The cost of one step of the port, counted from a trace on fake tensors:
the port's counterpart of `repro.roofline.hlo`. The reference reads the
HLO that XLA compiled; the port has no HLO, so it runs its own eager step
once on fake tensors and counts what each op would do on the card.

`trace_cost(fn, *args, mode=, live=())` runs fn(*args) under the args'
`FakeTensorMode` (`fake_mode()` makes one) and `CostMode`, a
`TorchDispatchMode` that sees every aten op the step issues (autograd's
backward, DTensor's local work and the collectives included) and the
nodes the kernel wrappers record (`kernels.cost`). Nothing is computed
and no device memory is taken. It returns the keys of the reference's
`structural_cost` (`flops`, `bytes`, `collective_total`,
`collective_ops`, `coll_<kind>`, `n_<kind>`) and `peak_bytes`, with the
H100 terms (`t_compute_s`, `t_memory_s`, `t_collective_s`) and the
breakdown `roofline.breakdown` prints. The rules:

- FLOPs: the matmul family (`mm`, `bmm`, `addmm`, `baddbmm`, the
  convolutions and SDPA), exact from shapes by the formulas of
  `torch.utils.flop_counter`, plus each kernel node's (`kernels.cost`).
  An op's FLOPs run at the peak of its first tensor's type (16-bit
  floats on the tensor cores, else f32; `roofline.hardware`).
- Bytes: each op's tensor operands plus its outputs, an operand's
  distinct elements only (a broadcast dimension, of stride 0, once).
  Views cost nothing (`FREE`: `view`, `expand`, `permute`, `transpose`,
  `slice`, `select`, `as_strided`, `t`, `detach`, `alias` and their
  kin, the counterparts of the reference's `_FREE_OPS`), nor do
  allocations (`ALLOC`: `empty` and its kin) and metadata. Casts
  (`_to_copy`, `copy_`) count, unlike the reference's `convert`: eager
  PyTorch runs each as a kernel, where XLA fuses it.
- Windows: an in-place write into a window (`copy_` into a view,
  `index_put_`, `slice_scatter` and the other `WINDOW_WRITES`) bills
  twice the window (the reference's rule for `dynamic-update-slice`),
  plus its indices; a gather (`GATHERS`: `index`, `embedding`,
  `index_select`, `gather`) bills twice its output plus its indices: the
  rows it reads, not its whole table (the reference's rule for
  `dynamic-slice`).
- Collectives: the c10d and `_c10d_functional` ops that
  `dist/collectives.py` and DTensor issue, by the ring formulas of the
  reference's `_wire_bytes` over the group's size (all-gather out (n-1)/n,
  reduce-scatter in (n-1)/n, all-reduce 2 in (n-1)/n, all-to-all in
  (n-1)/n, broadcast in), each priced at `hardware.link_bytes_s` of the
  group's global ranks; their operands and outputs count as bytes too.
- Peak: the high-water mark of the live fake storages (this module's
  own tracker, `_Live`: a storage counts from the op that made it until
  its last tensor is freed; those of the args and of `live`, say the
  weights, count from the start).
- A Python layer loop is traced unrolled, so there is no trip count to
  find; a remat layer (`torch.utils.checkpoint`) runs its forward again
  in the backward pass, and both runs count: the card does that work.
- A scalar read on the host (`.item()` of a float) has no value in a
  trace: it reads 1.0 (the mesh train step's loss share, which scales a
  scalar). Any other value read raises: a data-dependent shape cannot be
  traced.
- An op on DTensors runs as DTensor runs it and counts as one op over
  the local tensors of its arguments and outputs.
"""
from __future__ import annotations

import heapq
import math
import weakref
from collections import defaultdict
from typing import Dict, Iterable

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost
from repro_torch.roofline import hardware as hw

# views (no new storage, no traffic) and metadata
FREE = frozenset(f"aten.{n}" for n in (
    "view", "_unsafe_view", "_reshape_alias", "reshape", "expand",
    "permute", "transpose", "t", "slice", "select", "as_strided", "detach",
    "alias", "unsqueeze", "squeeze", "split", "split_with_sizes", "unbind",
    "narrow", "diagonal", "view_as_real", "view_as_complex", "unfold",
    "movedim", "lift_fresh", "detach_", "squeeze_", "unsqueeze_",
    "transpose_", "t_", "as_strided_", "is_same_size",
    "_has_compatible_shallow_copy_type", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset")) | {
    "_c10d_functional.wait_tensor", "prim.device", "c10d.barrier"}
# allocations: new storage, no traffic
ALLOC = frozenset(f"aten.{n}" for n in (
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "resize_", "set_"))
# in-place writes into a window -> the argument that holds the window's
# values (copy_ bills its source and its destination)
WINDOW_WRITES = {"aten.copy_": 1, "aten.index_put_": 2,
                 "aten._index_put_impl_": 2, "aten.slice_scatter": 1,
                 "aten.select_scatter": 1, "aten.index_copy_": 3,
                 "aten.scatter_": 3, "aten.scatter_add_": 3,
                 "aten.index_add_": 3}
GATHERS = frozenset(f"aten.{n}" for n in (
    "index", "embedding", "index_select", "gather", "take_along_dim"))
# collective op -> (kind, output argument or None for the op's result,
# input argument)
COLLECTIVES = {
    "c10d.allgather_": ("all-gather", 0, 1),
    "c10d._allgather_base_": ("all-gather", 0, 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 0, 1),
    "c10d.allreduce_": ("all-reduce", 0, 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0, 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 0, 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 0, 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 1),
    "c10d.alltoall_": ("all-to-all", 0, 1),
    "c10d.alltoall_base_": ("all-to-all", 0, 1),
    "c10d.broadcast_": ("broadcast", 0, 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", None, 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather",
                                                          None, 0),
    "_c10d_functional.all_reduce": ("all-reduce", None, 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0, 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", None, 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                         None, 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", None, 0),
    "_c10d_functional.broadcast": ("broadcast", None, 0),
}
TOP = 40            # single ops kept for the breakdown, by bytes
_PRIM_DEVICE = torch.ops.prim.device.default


def fake_mode() -> FakeTensorMode:
    """A fake-tensor mode for a dry run's inputs (real tensors that reach
    it, say a constant, are taken in as fakes)."""
    return FakeTensorMode(allow_non_fake_inputs=True)


_DTENSOR = []


def _dtensor_type():
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return _DTENSOR[0]


def _tensors(tree, out=None) -> list:
    """The tensors in `tree` (lists, tuples, dicts), a DTensor's local
    tensor in its place."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree._local_tensor if isinstance(tree, _dtensor_type())
                   else tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def nbytes(t: torch.Tensor) -> int:
    """The bytes of t's distinct elements (a stride-0 dimension once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _sum_bytes(tree) -> int:
    return sum(nbytes(t) for t in _tensors(tree))


class _Live:
    """The live fake storages' bytes and their high-water mark."""

    def __init__(self):
        self.now = self.peak = 0
        self._sizes: Dict[int, int] = {}

    def add(self, tree) -> None:
        for t in (tree if isinstance(tree, list) else _tensors(tree)):
            st = t.untyped_storage()
            key = id(st)
            if key in self._sizes:
                continue
            n = st.nbytes()
            self._sizes[key] = n
            self.now += n
            self.peak = max(self.peak, self.now)
            weakref.finalize(st, self._drop, key)

    def _drop(self, key: int) -> None:
        self.now -= self._sizes.pop(key, 0)


def _group(func_key: str, args):
    """The process group a collective runs over."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    if func_key.startswith("_c10d_functional."):
        return _resolve_process_group(args[-1])
    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name(
                ).endswith("c10d.ProcessGroup"):
            return dist.ProcessGroup.unbox(a)
    raise ValueError(f"{func_key}: no process group among its arguments")


def wire_bytes(kind: str, n: int, in_bytes: float, out_bytes: float
               ) -> float:
    """Bytes a rank sends over a ring of n ranks (the reference's
    `_wire_bytes`)."""
    f = (n - 1) / n
    return {"all-gather": out_bytes * f, "reduce-scatter": in_bytes * f,
            "all-reduce": 2 * in_bytes * f,
            "all-to-all": in_bytes * f}.get(kind, in_bytes)


class CostMode(TorchDispatchMode):
    """Counts each op as the module's docstring says (see `trace_cost`)."""

    def __init__(self, live: _Live):
        super().__init__()
        self.live = live
        self.flops = defaultdict(float)          # peak kind -> FLOPs
        self.bytes = 0.0
        self.coll = defaultdict(float)           # kind -> wire bytes
        self.coll_n = defaultdict(int)
        self.t_coll = 0.0
        self.ops = defaultdict(lambda: [0, 0.0, 0.0])  # n, bytes, flops
        self.kernels = defaultdict(lambda: [0, 0.0, 0.0])
        self.top: list = []
        self._seq = 0

    def _note(self, key: str, nb: float, fl: float, args) -> None:
        rec = self.ops[key]
        rec[0] += 1
        rec[1] += nb
        rec[2] += fl
        self.bytes += nb
        if len(self.top) < TOP or nb > self.top[0][0]:
            shapes = args if isinstance(args, str) else str(
                [tuple(t.shape) for t in _tensors(args)][:3])
            item = (nb, self._seq, key, shapes)
            self._seq += 1
            if len(self.top) < TOP:
                heapq.heappush(self.top, item)
            else:
                heapq.heapreplace(self.top, item)

    def kernel(self, name: str, c: kcost.Cost) -> None:
        """A kernel node recorded by its wrapper (`kernels.cost.node`)."""
        rec = self.kernels[name]
        rec[0] += 1
        rec[1] += c.bytes
        rec[2] += c.flops
        self.flops[c.peak] += c.flops
        self._note(f"kernel.{name}", c.bytes, c.flops, name)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _PRIM_DEVICE and isinstance(args[0], FakeTensor):
            return args[0].fake_device
        key = str(func._overloadpacket)
        if key in FREE:
            return func(*args, **kwargs)
        if key == "aten._local_scalar_dense":
            if args[0].dtype.is_floating_point:
                return 1.0
            raise RuntimeError(
                f"a {args[0].dtype} value read on the host in a dry-run "
                "trace: it has no value there")
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self.live.add(outs)
        if key in ALLOC:
            return out
        if _dtensor_type() in types:
            self._note(key, _sum_bytes((args, kwargs)) + _sum_bytes(outs),
                       0.0, args)
            return out
        if key in COLLECTIVES:
            self._collective(key, args, outs)
            return out
        if not outs:
            return out
        fl = 0.0
        if func._overloadpacket in flop_registry:
            fl = float(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
            self.flops[hw.peak_kind(_tensors(args)[0].dtype)] += fl
        src = WINDOW_WRITES.get(key)
        if src is not None and isinstance(args[src], torch.Tensor):
            window = nbytes(args[src])
            if key == "aten.copy_":
                nb = window + nbytes(args[0])
            else:
                nb = 2 * window + sum(nbytes(t) for i, a in enumerate(args)
                                      if i not in (0, src)
                                      for t in _tensors(a))
        elif key in GATHERS:
            nb = 2 * _sum_bytes(outs) + _sum_bytes(args[1:])
        else:
            nb = _sum_bytes((args, kwargs)) + _sum_bytes(outs)
        self._note(key, nb, fl, args)
        return out

    def _collective(self, key: str, args, outs) -> None:
        import torch.distributed as dist
        kind, oi, ii = COLLECTIVES[key]
        in_b = _sum_bytes(args[ii])
        out_b = _sum_bytes(outs if oi is None else args[oi])
        pg = _group(key, args)
        wire = wire_bytes(kind, pg.size(), in_b, out_b)
        self.coll[kind] += wire
        self.coll_n[kind] += 1
        self.t_coll += wire / hw.link_bytes_s(
            dist.get_process_group_ranks(pg))
        self._note(key, in_b + out_b, 0.0, args)

    def result(self) -> dict:
        t_compute, t_memory = hw.seconds(self.flops, self.bytes)
        out = {
            "flops": sum(self.flops.values()),
            "bytes": self.bytes,
            "collective_total": sum(self.coll.values()),
            "collective_ops": sum(self.coll_n.values()),
            "peak_bytes": self.live.peak,
            "flops_bf16": self.flops.get("bf16", 0.0),
            "flops_f32": self.flops.get("f32", 0.0),
            "t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": self.t_coll,
            "kernel_nodes": {n: r[0] for n, r in self.kernels.items()},
            "kernels": {n: {"n": r[0], "bytes": r[1], "flops": r[2]}
                        for n, r in self.kernels.items()},
            "ops": {k: {"n": r[0], "bytes": r[1], "flops": r[2]}
                    for k, r in self.ops.items()},
            "top": [{"bytes": b, "op": k, "shapes": s} for b, _, k, s in
                    sorted(self.top, reverse=True)],
        }
        for k, v in self.coll.items():
            out[f"coll_{k}"] = v
            out[f"n_{k}"] = self.coll_n[k]
        return out


def trace_cost(fn, *args, mode: FakeTensorMode, live: Iterable = (),
               **kwargs) -> dict:
    """The cost of fn(*args, **kwargs) on fake tensors (the module's
    rules). `mode`: the FakeTensorMode the args were made in; `live`:
    tensors held throughout besides the args (a model's weights), for the
    peak. Returns the cost dict, with the step's output under "output"."""
    tracker = _Live()
    tracker.add((args, kwargs, list(live)))
    cm = CostMode(tracker)
    with mode, kcost.tracing(cm.kernel), cm:
        output = fn(*args, **kwargs)
    res = cm.result()
    res["output"] = output
    return res


def dominant(t_compute: float, t_memory: float, t_coll: float) -> str:
    return max((t_compute, "compute"), (t_memory, "memory"),
               (t_coll, "collective"))[1]


def roofline_fraction(model_flops: float, chips: int, terms) -> float:
    """The share of the card's bf16 peak that the model's useful FLOPs
    reach at the largest term (the reference's `roofline_fraction`)."""
    t = max(terms)
    return model_flops / hw.BF16_FLOPS_S / chips / t if t > 0 else math.nan
