"""Functional NN ops (``tsl/nn/functional.py`` counterparts).

Counterpart of ``sgp_tpu/ops/functional.py``: ``expand_then_cat``,
``gated_tanh``, ``reverse_tensor``, ``sparse_softmax`` and the edge-list
``sparse_multi_head_attention``, the oracle of the block form in
``ops/sddmm.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from sgp_tpu_torch.ops.scatter import segment_softmax, segment_sum


def expand_then_cat(tensors: Sequence[torch.Tensor],
                    axis: int = -1) -> torch.Tensor:
    """Broadcast all tensors to a common shape (except ``axis``) then
    concatenate."""
    ndim = max(t.ndim for t in tensors)
    tensors = [t.reshape((1,) * (ndim - t.ndim) + tuple(t.shape))
               for t in tensors]
    ax = axis % ndim
    target = [max(t.shape[d] for t in tensors) if d != ax else -1
              for d in range(ndim)]
    out = [t.expand([target[d] if d != ax else t.shape[d]
                     for d in range(ndim)]) for t in tensors]
    return torch.cat(out, dim=ax)


def gated_tanh(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``tanh(a) * sigmoid(b)`` with a/b the two halves of ``axis``."""
    a, b = torch.chunk(x, 2, dim=axis)
    return torch.tanh(a) * torch.sigmoid(b)


def reverse_tensor(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    return torch.flip(x, dims=(axis,))


def sparse_softmax(scores: torch.Tensor, index: torch.Tensor,
                   num_nodes: int) -> torch.Tensor:
    """Edge-score softmax per destination node."""
    return segment_softmax(scores, index, num_nodes)


def sparse_multi_head_attention(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, src: torch.Tensor,
                                dst: torch.Tensor, num_nodes: int,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Sparse (edge-list) multi-head attention: per-edge logits
    ``<q_dst, k_src>``, softmax over incoming edges, weighted value
    aggregation. q/k/v ``[n, h, d]``; returns ``[n, h, d]``. As in the JAX
    op, ``scale`` falls back to ``d ** -0.5`` when it is falsy (0 too)."""
    d = q.shape[-1]
    scale = scale or d ** -0.5
    src, dst = src.long(), dst.long()
    logits = (q[dst] * k[src]).sum(-1) * scale              # [e, h]
    att = segment_softmax(logits, dst, num_nodes)
    return segment_sum(v[src] * att[..., None], dst, num_nodes)
