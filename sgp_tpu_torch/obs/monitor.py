"""Online model-health monitoring for serving (torch).

Counterpart of ``sgp_tpu/obs/monitor.py``: the AZ-whiteness test
(``analysis/whiteness.py``) as a rolling monitor over live one-step
residuals. When the residual stream stops being white over time and over
the graph, the model no longer captures the process (drift, a regime
change, a failed sensor) and the monitor flags it. The window holds
tensors on the residuals' device, where the test runs in float64; the
symmetrized edges are built once a device.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from sgp_tpu_torch.analysis.whiteness import (UndirectedEdges,
                                              az_whiteness_test,
                                              prepare_edges)


class ResidualWhitenessMonitor:
    """A rolling AZ-whiteness test over the last ``window`` residuals.

    Args:
        edge_index: the spatial topology ``[2, E]`` (or a ``Graph``, whose
            edge weights then weigh the spatial statistic).
        window: the most recent steps tested.
        alpha: significance level: ``update``'s result has ``flagged``
            set when the test's p-value falls below it.
        min_steps: no test before this many residuals have arrived.
        edge_weight: ``[E]`` spatial edge weights (over a ``Graph``'s; 1.0
            when there are none).
    """

    def __init__(self, edge_index, window: int = 64,
                 alpha: float = 0.05, min_steps: int = 8,
                 edge_weight=None):
        if hasattr(edge_index, "src"):          # a Graph
            if edge_weight is None:
                edge_weight = np.asarray(edge_index.weight, np.float64)
            edge_index = np.stack([np.asarray(edge_index.src),
                                   np.asarray(edge_index.dst)])
        self.edge_index = np.asarray(edge_index)
        self.edge_weight = (None if edge_weight is None
                            else np.asarray(edge_weight, np.float64))
        if min_steps > window:
            raise ValueError(
                f"min_steps={min_steps} > window={window}: the rolling "
                f"buffer caps at `window` residuals, so the monitor "
                f"would never run a test")
        if min_steps < 2:
            raise ValueError("min_steps must be >= 2 (the temporal "
                             "statistic needs consecutive residuals)")
        self.window = window
        self.alpha = alpha
        self.min_steps = min_steps
        self._buf: deque = deque(maxlen=window)
        self._mask: deque = deque(maxlen=window)
        self._edges: dict = {}
        self.last_result = None

    def edges(self, device) -> UndirectedEdges:
        """The symmetrized edges on ``device``, built on the first use."""
        key = str(torch.device(device))
        if key not in self._edges:
            self._edges[key] = prepare_edges(self.edge_index,
                                             self.edge_weight, device)
        return self._edges[key]

    def update(self, residual, mask=None):
        """Take one step's residuals ``[N, C]`` (a tensor stays on its
        device; numpy goes to the CPU) and an optional mask; returns the
        test's result, with ``flagged`` set by ``alpha``, or None before
        ``min_steps``."""
        residual = torch.as_tensor(residual).to(torch.float64)
        self._buf.append(residual)
        self._mask.append(None if mask is None else torch.as_tensor(
            mask, device=residual.device).to(torch.bool))
        if len(self._buf) < self.min_steps:
            self.last_result = None
            return None
        x = torch.stack(tuple(self._buf))             # [W, N, C]
        masks = None
        if any(m is not None for m in self._mask):
            masks = torch.stack([
                torch.ones(x.shape[1:], dtype=torch.bool, device=x.device)
                if m is None else m for m in self._mask])
        res = az_whiteness_test(x, self.edges(x.device), mask=masks)
        res.flagged = res.pvalue < self.alpha
        self.last_result = res
        return res

    def reset(self):
        self._buf.clear()
        self._mask.clear()
        self.last_result = None
