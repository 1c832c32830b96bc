"""The port's explicit collectives over named mesh axes (what the
reference's `shard_map` bodies spell as `lax.all_gather`, `psum` and
`psum_scatter`).

A collective over several mesh axes runs as one collective an axis, in
the order that keeps the reference's layout: a tensor dimension split
over axes (a, b) is cut by a (major) and each part by b, so gathers go
minor axis first and reduce-scatters major axis first. The autograd
functions are the pairs tensor and expert parallelism need:

  AllReduce      forward: sum over the axes; backward: identity (the
                 gradient is already the same on every rank)
  GradAllReduce  forward: identity; backward: sum over the axes (a
                 replicated input read by ranks that each compute part)
  AllGather      forward: all-gather along a dimension; backward:
                 reduce-scatter of the gradient (sum)

Serving has no gradients: `AxisGroup` is the ranks of some mesh axes as
one group of no-grad collectives, the one tensor-parallel serving
(`models.dense`) runs over "model"; `all_gather_object` collects a
picklable value of every rank of some axes (the wave engine's tokens).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _group(mesh, axis: str):
    return mesh.get_group(mesh_dim=axis)


def all_gather(t: torch.Tensor, mesh, axes: Sequence[str], dim: int
               ) -> torch.Tensor:
    """t's parts on the ranks of `axes`, concatenated along `dim` in the
    axes' major-to-minor rank order."""
    for a in reversed(tuple(axes)):
        g = _group(mesh, a)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, t.contiguous(), group=g)
        t = torch.cat(parts, dim)
    return t


def reduce_scatter(t: torch.Tensor, mesh, axes: Sequence[str], dim: int
                   ) -> torch.Tensor:
    """The sum of t over the ranks of `axes`, of which each keeps its own
    part along `dim` (the inverse layout of `all_gather`)."""
    for a in tuple(axes):
        g = _group(mesh, a)
        chunks = [c.contiguous() for c in
                  t.chunk(dist.get_world_size(g), dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=g)
        t = out
    return t


def all_reduce(t: torch.Tensor, mesh, axes: Sequence[str],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """t reduced by `op` over the ranks of `axes`, in place."""
    for a in tuple(axes):
        dist.all_reduce(t, op=op, group=_group(mesh, a))
    return t


class AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class GradAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axes), None, None


class AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None,
                None)



class AxisGroup:
    """The ranks of `axes` of `mesh` as one group: `size`, and the sum
    (`all_reduce`, in place) and the concatenation (`all_gather`) over
    them, without autograd."""

    def __init__(self, mesh, axes: Sequence[str]):
        self.mesh, self.axes = mesh, tuple(axes)
        self.size = 1
        for a in self.axes:
            self.size *= dist.get_world_size(_group(mesh, a))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self.mesh, self.axes)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather(t, self.mesh, self.axes, dim % t.ndim)


def all_gather_object(obj, mesh, axes: Sequence[str]) -> list:
    """The list of every rank's `obj` over `axes` (picklable values), in
    the axes' major-to-minor rank order: one list a rank."""
    out = [obj]
    for a in reversed(tuple(axes)):
        g = _group(mesh, a)
        parts = [None] * dist.get_world_size(g)
        dist.all_gather_object(parts, out, group=g)
        out = [o for p in parts for o in p]
    return out
