"""The AZ-whiteness test of forecast residuals on a graph (torch).

Counterpart of ``sgp_tpu/analysis/whiteness.py`` (``tsl/ops/test.py:81-288``;
Zambon & Alippi, "AZ-whiteness test", NeurIPS 2022): a statistic of the
signs of residual products over the spatial edges and between consecutive
steps, standard normal under the null of uncorrelated noise.

The statistic is computed in float64 on the residuals' device, so a
monitor beside a forecaster on the card copies no ``[W, N, C]`` window to
the host; only its scalars come back. Two parts stay on the host: the
edge list's symmetrization (``graph/sparse.py``'s ``coalesce`` and
``remove_self_loops``, once a call, or once a monitor through
:func:`prepare_edges`) and the p-value's ``erf`` of one scalar. numpy
inputs are taken as CPU tensors. As in the JAX package, the symmetrized
edge weights are float32 (``Graph``'s type).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Union

import numpy as np
import torch

from sgp_tpu_torch.graph.sparse import Graph, coalesce, remove_self_loops


@dataclasses.dataclass
class AZWhitenessTestResult:
    statistic: float
    pvalue: float


@dataclasses.dataclass
class AZWhitenessMultiTestResult:
    statistic: float
    pvalue: float
    componentwise_tests: List[AZWhitenessTestResult]


@dataclasses.dataclass
class UndirectedEdges:
    """The test's spatial edges: each undirected edge once per direction,
    no self-loops, ``index [2, E]`` (int64) and ``weight [E]`` (float32)
    on one device."""
    index: torch.Tensor
    weight: torch.Tensor

    def to(self, device) -> "UndirectedEdges":
        return UndirectedEdges(self.index.to(device), self.weight.to(device))


def _pval(c: float) -> float:
    """Two-sided standard-normal p-value."""
    return 2.0 * (1.0 - 0.5 * (1.0 + math.erf(abs(c) / math.sqrt(2.0))))


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def prepare_edges(edge_index, edge_weight=None, device=None
                  ) -> UndirectedEdges:
    """Symmetrize ``edge_index [2, E]`` (weights: None for 1, a scalar, or
    ``[E]``, all > 0) on the host: duplicates merged by their largest
    weight, self-loops dropped, each reverse edge added, merged again by
    the largest weight (the reference's ``_to_undirected_no_selfloops``);
    the result on ``device``."""
    edge_index = _host(edge_index)
    if edge_weight is None:
        edge_weight = 1.0
    if np.isscalar(edge_weight) or (isinstance(edge_weight, torch.Tensor)
                                    and edge_weight.ndim == 0):
        edge_weight = float(edge_weight) * np.ones(edge_index.shape[1])
    edge_weight = _host(edge_weight)
    assert np.all(edge_weight > 0)
    g = Graph(edge_index[0], edge_index[1], edge_weight,
              int(edge_index.max()) + 1)
    g = remove_self_loops(coalesce(g, reduce="max"))
    both = coalesce(Graph(np.concatenate([g.src, g.dst]),
                          np.concatenate([g.dst, g.src]),
                          np.concatenate([g.weight, g.weight]), g.num_nodes),
                    reduce="max")
    index = torch.as_tensor(np.stack([both.src, both.dst]).astype(np.int64),
                            device=device)
    return UndirectedEdges(index, torch.as_tensor(both.weight, device=device))


def _as_tensor(a, dtype, device=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dtype=dtype, device=device if device is not None
                    else a.device)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """numpy's ``nanmedian`` over the last axis, keeping it: the mean of
    the two middle values of an even count (``torch.nanmedian`` takes the
    lower one), NaN where every value is NaN."""
    v, _ = torch.sort(x, dim=-1)               # NaNs sort last
    k = (~torch.isnan(x)).sum(-1, keepdim=True)
    lo = torch.gather(v, -1, torch.clamp((k - 1) // 2, min=0))
    hi = torch.gather(v, -1, torch.clamp(k // 2, max=x.shape[-1] - 1))
    return torch.where(k > 0, (lo + hi) / 2, torch.full_like(lo, math.nan))


def az_whiteness_test(x, edge_index, mask=None,
                      edge_weight: Union[np.ndarray, torch.Tensor, float,
                                         None] = None,
                      edge_weight_temporal: Optional[float] = None,
                      lamb: float = 0.5, multivariate: bool = False,
                      remove_median: bool = False
                      ) -> Union[AZWhitenessTestResult,
                                 AZWhitenessMultiTestResult]:
    """The test on residuals ``x [T, N, F]`` (or ``[T, N]``) over the
    static topology ``edge_index [2, E]``, or over the edges of
    :func:`prepare_edges` (then ``edge_weight`` is theirs). ``mask``
    (``x``'s shape) marks the valid residuals. ``edge_weight_temporal``:
    None or ``"auto"`` balances the temporal edges' total weight with the
    valid spatial edges'. One feature, or ``multivariate``: one test over
    the channels' summed products; otherwise a test a channel, combined as
    ``sum(c_i) / sqrt(F)``. ``remove_median``: each residual less the
    median of its valid channels."""
    x = _as_tensor(x, torch.float64)
    if x.ndim == 2:
        x = x[..., None]
    if mask is not None:
        mask = _as_tensor(mask, torch.bool, x.device)
        if mask.ndim == 2:
            mask = mask[..., None]
    if not isinstance(edge_index, UndirectedEdges):
        edge_index = prepare_edges(edge_index, edge_weight, x.device)
    edges = edge_index.to(x.device)
    if remove_median:
        valid = x if mask is None else torch.where(
            mask, x, torch.full_like(x, math.nan))
        x = x - _nanmedian(valid)
    f = x.shape[-1]
    if f == 1 or multivariate:
        return _az_test(x, mask, edges, edge_weight_temporal, lamb)
    res = [_az_test(x[..., i:i + 1],
                    None if mask is None else mask[..., i:i + 1], edges,
                    edge_weight_temporal, lamb) for i in range(f)]
    c_multi = float(np.sum([r.statistic for r in res]) / np.sqrt(len(res)))
    return AZWhitenessMultiTestResult(c_multi, _pval(c_multi), res)


def _sign(v: torch.Tensor) -> torch.Tensor:
    """numpy's sign: NaN stays NaN (``torch.sign`` gives 0). A residual
    whose channels are all masked has a NaN median, and with
    ``remove_median`` the test's result is NaN, as in the JAX package."""
    return torch.where(torch.isnan(v), v, torch.sign(v))


def _az_test(x, mask, edges: UndirectedEdges, edge_weight_temporal,
             lamb) -> AZWhitenessTestResult:
    t = x.shape[0]
    src, dst = edges.index
    weight = edges.weight.to(torch.float64)
    mask = torch.ones_like(x) if mask is None else mask.to(torch.float64)
    mask_node = mask.amax(dim=-1)                          # [T, N]
    x = x * mask
    edge_valid = mask_node[:, src] * mask_node[:, dst]     # [T, E], 0 / 1
    # the squared weights of the valid (t, e) pairs
    w_spatial = (edge_valid.sum(0) * weight.square()).sum()
    if t == 1:
        n_temporal = torch.zeros((), dtype=torch.float64, device=x.device)
        edge_weight_temporal = 1.0
    else:
        n_temporal = (mask[1:] * mask[:-1]).sum()
        if edge_weight_temporal is None or edge_weight_temporal == "auto":
            edge_weight_temporal = torch.sqrt(
                w_spatial / torch.clamp(n_temporal, min=1.0))
    w_temporal = edge_weight_temporal ** 2 * n_temporal
    xxs = (x[:, src] * x[:, dst]).sum(-1)                  # [T, E]
    xxt = (x[1:] * x[:-1]).sum(-1)                         # [T-1, N]
    c_spatial = (weight[None] * _sign(xxs)).sum()
    c_temporal = edge_weight_temporal * _sign(xxt).sum()
    assert 0 <= lamb <= 1
    c_tilde = lamb * c_spatial + (1 - lamb) * c_temporal
    w = lamb ** 2 * w_spatial + (1 - lamb) ** 2 * w_temporal
    c = float(c_tilde / torch.sqrt(torch.clamp(w, min=1e-300)))
    return AZWhitenessTestResult(c, _pval(c))
