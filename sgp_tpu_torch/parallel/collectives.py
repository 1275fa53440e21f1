"""The collectives of the node-sharded path, each on one axis's group.

A one-rank axis has no group (``None``): each function then returns its
input, as a collective over one rank would, and calls nothing. NCCL takes
CUDA tensors; this torch build's gloo takes CPU tensors and CUDA ones in
all four collectives here (``chip_smoke.py``'s phase 21 probes it on the
card), so several ranks can share one card under gloo.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def all_to_all(t: torch.Tensor, group: Optional[dist.ProcessGroup]
               ) -> torch.Tensor:
    """``all_to_all_single`` over dim 0 in equal sections, one per rank of
    ``group``: section ``j`` of the result is what rank ``j`` sent."""
    if group is None:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def all_reduce_(t: torch.Tensor, group: Optional[dist.ProcessGroup]
                ) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group: Optional[dist.ProcessGroup]
                   ) -> torch.Tensor:
    """``t`` summed over ``group`` (a new tensor), differentiable: its
    gradient is summed over the ranks too, since every rank's loss
    depends on every rank's ``t``."""
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)


def all_gather(t: torch.Tensor, group: Optional[dist.ProcessGroup]
               ) -> torch.Tensor:
    """Every rank's ``t`` stacked along dim 0 in rank order."""
    if group is None:
        return t
    t = t.contiguous()
    out = t.new_empty((dist.get_world_size(group) * t.shape[0],)
                      + t.shape[1:])
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def broadcast_(t: torch.Tensor, group: Optional[dist.ProcessGroup],
               src: int = 0) -> torch.Tensor:
    """``t`` of the group's rank ``src`` on every rank, in place."""
    if group is not None:
        dist.broadcast(t, group=group, group_src=src)
    return t
