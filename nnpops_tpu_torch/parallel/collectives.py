"""The collectives of the sharded paths, with the gradients of JAX's
``shard_map`` (``psum``, ``all_gather(tiled=True)``, ``ppermute``).

Each function is called on every rank of ``group``. In JAX a value is
either replicated over the mesh axis or varying along it, and the
transpose of each collective follows from that; here the functions carry
the same contract by hand:

* :func:`psum`: the sum over the group; its output is replicated, and
  every rank differentiates the same replicated result, so the backward
  passes the cotangent through unchanged (``torch.distributed.nn``'s
  all-reduce sums the cotangents again and would scale every gradient by
  the group size);
* :func:`replicated`: marks a replicated input (positions, parameters)
  that each rank consumes in its own share of the work; identity forward,
  the backward sums the ranks' partial cotangents, so every rank gets the
  full gradient;
* :func:`all_gather_rows`: rank blocks concatenated in rank order along
  dim 0; the backward sums the ranks' cotangents and keeps this rank's
  block (a reduce-scatter);
* :func:`ring_shift`: each rank's tensor to the next rank of the group
  (``ppermute`` over ``i -> i + 1 mod n``); the backward shifts back.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        size = dist.get_world_size(group)
        x = x.contiguous()
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        ctx.group, ctx.rows = group, x.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        start = dist.get_rank(ctx.group) * ctx.rows
        return g[start:start + ctx.rows], None


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    size = dist.get_world_size(group)
    if size == 1:
        return x
    rank = dist.get_rank(group)
    flat = x.contiguous().reshape(1, -1)
    out = torch.empty_like(flat)
    send, recv = [0] * size, [0] * size
    send[(rank + step) % size] = 1
    recv[(rank - step) % size] = 1
    dist.all_to_all_single(out, flat, output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out.reshape(x.shape)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; replicated output, pass-through cotangent."""
    return _Psum.apply(x, group)


def replicated(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated input: its gradient is summed over the group. A tensor
    that needs no gradient is returned as it is."""
    return _Replicated.apply(x, group) if x.requires_grad else x


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's blocks along dim 0, in rank order."""
    return _AllGatherRows.apply(x, group)


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's tensor to the next rank; the previous rank's back (the
    identity on a group of one)."""
    return _RingShift.apply(x, group)
