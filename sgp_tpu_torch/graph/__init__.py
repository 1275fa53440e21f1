from sgp_tpu_torch.graph.sparse import (
    Graph,
    add_self_loops,
    coalesce,
    edge_dropout,
    normalize_adj,
    remove_self_loops,
    to_undirected,
    transpose,
    weighted_degree,
)
from sgp_tpu_torch.graph.similarities import gaussian_kernel, top_k

__all__ = [
    "Graph", "add_self_loops", "coalesce", "edge_dropout", "normalize_adj",
    "remove_self_loops", "to_undirected", "transpose", "weighted_degree",
    "gaussian_kernel", "top_k",
]
