"""Dataset base: raw arrays + the similarity→connectivity pipeline.

A numpy copy of ``sgp_tpu/data/datasets/base.py`` without the datetime
encoding (its splitters are not ported yet). Subclasses implement
:meth:`load` and :meth:`compute_similarity`.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from sgp_tpu_torch.graph.similarities import top_k
from sgp_tpu_torch.graph.sparse import (Graph, normalize_adj,
                                        remove_self_loops, to_undirected)
from sgp_tpu_torch.utils.config import config


class TabularDataset:
    """Base dataset: target ``[T, N, C]``, optional mask, datetime index
    and covariates; similarity-based graph construction."""

    similarity_options: set = set()

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.path.join(config["data_dir"],
                                         type(self).__name__)
        self.target: Optional[np.ndarray] = None
        self.mask: Optional[np.ndarray] = None
        self.index: Optional[np.ndarray] = None
        self.covariates: Dict[str, np.ndarray] = {}
        self._similarity_cache: Dict[str, np.ndarray] = {}
        self.load()

    # -- to be implemented by subclasses ----------------------------------
    def load(self):
        raise NotImplementedError

    def compute_similarity(self, method: str, **kwargs) -> np.ndarray:
        raise NotImplementedError

    # -- shapes ------------------------------------------------------------
    @property
    def n_steps(self):
        return self.target.shape[0]

    @property
    def n_nodes(self):
        return self.target.shape[1]

    @property
    def n_channels(self):
        return self.target.shape[2] if self.target.ndim == 3 else 1

    # -- graph construction ------------------------------------------------
    def get_similarity(self, method: Optional[str] = None,
                       **kwargs) -> np.ndarray:
        method = method or next(iter(self.similarity_options), None)
        key = f"{method}:{sorted(kwargs.items())}"
        if key not in self._similarity_cache:
            self._similarity_cache[key] = self.compute_similarity(
                method, **kwargs)
        return self._similarity_cache[key]

    def get_connectivity(self, method: Optional[str] = None,
                         threshold: Optional[float] = None,
                         knn: Optional[int] = None,
                         binary_weights: bool = False,
                         include_self: bool = True,
                         force_symmetric: bool = False,
                         normalize_axis: Optional[str] = None,
                         **kwargs) -> Graph:
        """Similarity → graph: apply threshold and/or k-nn row
        sparsification, optionally binarize, drop/keep self-loops,
        symmetrize, normalize. The operator is ``A[dst, src] =
        sim[dst, src]``, the similarity itself."""
        sim = np.array(self.get_similarity(method, **kwargs), np.float32)
        if threshold is not None:
            sim[sim < threshold] = 0.0
        if knn is not None:
            sim = top_k(sim, knn, include_self=include_self,
                        keep_values=True)
        if binary_weights:
            sim = (sim > 0).astype(np.float32)
        g = Graph.from_dense(sim)
        if not include_self:
            g = remove_self_loops(g)
        if force_symmetric:
            g = to_undirected(g, reduce="max")
        if normalize_axis:
            g = normalize_adj(g, "row")
        return g
