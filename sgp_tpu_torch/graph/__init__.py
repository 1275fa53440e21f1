from sgp_tpu_torch.graph.sparse import (
    Graph,
    add_self_loops,
    adjacency_rows,
    auto_band,
    band_windows,
    coalesce,
    edge_dropout,
    k_hop_subgraph,
    normalize_adj,
    padded_incoming,
    permute_nodes,
    rcm_order,
    remove_self_loops,
    spgemm,
    to_undirected,
    transpose,
    weighted_degree,
)
from sgp_tpu_torch.graph.similarities import gaussian_kernel, top_k

__all__ = [
    "Graph", "add_self_loops", "adjacency_rows", "auto_band",
    "band_windows", "coalesce", "edge_dropout", "k_hop_subgraph",
    "normalize_adj", "padded_incoming", "permute_nodes", "rcm_order",
    "remove_self_loops", "spgemm", "to_undirected", "transpose",
    "weighted_degree",
    "gaussian_kernel", "top_k",
]
