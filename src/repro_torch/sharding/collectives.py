"""Collectives inside ``local_map`` bodies, with the backward passes the
port's sharded code needs.

``local_map`` hands its body plain local tensors, so a body's collectives
are ``torch.distributed``'s own; these wrap them in autograd:

* :func:`sum_over`: ``all_reduce`` (sum) over groups, optionally divided,
  whose backward scales the cotangent and moves nothing.  The result is
  replicated over the groups, and each rank's input is one term of the
  sum, so each term's gradient is the whole cotangent (the reference's
  ``psum`` under ``shard_map``); a ``grad_scale`` below 1 divides the
  cotangent among ranks that each computed the same value whole.
* :func:`gather_over`: ``all_gather`` along a dimension (tiled), whose
  backward reduce-scatters the cotangent (the FSDP gather).
* :func:`max_over`: ``all_reduce`` (max), with no gradient.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, divide, grad_scale):
        ctx.grad_scale = grad_scale
        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        return x / divide if divide != 1 else x

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.grad_scale, None, None, None


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        xt = x.movedim(dim, 0).contiguous()
        out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
        dist.all_gather_into_tensor(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        gt = grad.movedim(ctx.dim, 0).contiguous()
        out = gt.new_empty((gt.shape[0] // n, *gt.shape[1:]))
        dist.reduce_scatter_tensor(out, gt, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def sum_over(x: torch.Tensor, groups: Sequence, divide: float = 1,
             grad_scale: float = 1.0) -> torch.Tensor:
    return _SumOver.apply(x, list(groups), divide, grad_scale)


def gather_over(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _GatherOver.apply(x, group, dim)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x
