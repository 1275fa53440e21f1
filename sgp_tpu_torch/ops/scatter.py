"""Segment reductions over the leading axis (``torch_scatter``'s role).

Counterpart of ``sgp_tpu/ops/scatter.py``: ``index_add_`` for sums and
``scatter_reduce`` with ``"amax"`` for maxima. ``segment_ids`` index the
leading axis of ``data``; segments with no entry sum to 0.
"""
from __future__ import annotations

import torch


def _expand(ids: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return ids.long().view((-1,) + (1,) * (like.ndim - 1)).expand_as(like)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, segment_ids.long(), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment maximum; an empty segment gives ``-inf``, as
    ``jax.ops.segment_max`` does."""
    out = torch.full((num_segments,) + data.shape[1:], -torch.inf,
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, _expand(segment_ids, data), data, "amax")


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(torch.ones(segment_ids.shape, dtype=torch.float32,
                                 device=data.device),
                      segment_ids, num_segments)
    return tot / torch.clamp(cnt, min=1.0).view(
        (num_segments,) + (1,) * (data.ndim - 1))


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax within segments (sparse softmax,
    ``tsl/nn/functional.py:73-112``), with the JAX package's ``+ 1e-16`` in
    the denominator."""
    ids = segment_ids.long()
    scores = scores - segment_max(scores, ids, num_segments)[ids]
    exp = torch.exp(scores)
    seg_sum = segment_sum(exp, ids, num_segments)
    return exp / (seg_sum[ids] + 1e-16)
