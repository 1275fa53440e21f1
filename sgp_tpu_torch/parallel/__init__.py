"""Node-sharded SGP over ``torch.distributed`` (one process a rank).

Counterpart of ``sgp_tpu/parallel``: the process groups (``mesh``), the
boundary-halo K-hop (``halo``; K1 under each shard's block in ``bsr``
mode), the sharded encode and ridge (``encode``), the node-sharded IID
step and eval (``sharding``), and a launcher of rank processes on one
machine (``launch``).
"""
from sgp_tpu_torch.parallel.encode import (encode_series_sharded,
                                           sharded_ridge_nodes)
from sgp_tpu_torch.parallel.halo import (HaloSpec, build_halo_spec,
                                         gather_nodes, halo_khop,
                                         shard_nodes)
from sgp_tpu_torch.parallel.launch import run_ranks
from sgp_tpu_torch.parallel.mesh import (Mesh, init_distributed, local_mesh,
                                         make_mesh, rank_device)
from sgp_tpu_torch.parallel.sharding import (make_sharded_iid_eval,
                                             make_sharded_iid_step,
                                             rank_generator)

__all__ = ["HaloSpec", "Mesh", "build_halo_spec", "encode_series_sharded",
           "gather_nodes", "halo_khop", "init_distributed", "local_mesh",
           "make_mesh", "make_sharded_iid_eval", "make_sharded_iid_step",
           "rank_device", "rank_generator", "run_ranks", "shard_nodes",
           "sharded_ridge_nodes"]
