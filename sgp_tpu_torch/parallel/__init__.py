"""Multi-device SGP over ``torch.distributed`` (one process a rank).

Counterpart of ``sgp_tpu/parallel``: the process groups (``mesh``), the
boundary-halo K-hop (``halo``; K1 under each shard's block in ``bsr``
mode), the sharded encode and ridge (``encode``), the node-sharded IID and
stratified steps, the data-parallel window step and the node-sharded eval
(``sharding``), and a launcher of rank processes on one machine
(``launch``). ``Predictor(mesh=)`` (``train/predictor.py``) takes a
:class:`Mesh` from here.
"""
from sgp_tpu_torch.parallel.encode import (encode_series_sharded,
                                           sharded_ridge_nodes)
from sgp_tpu_torch.parallel.halo import (HaloSpec, build_halo_spec,
                                         gather_nodes, halo_khop,
                                         shard_nodes)
from sgp_tpu_torch.parallel.launch import run_ranks
from sgp_tpu_torch.parallel.mesh import (Mesh, init_distributed, local_mesh,
                                         make_mesh, process_rank,
                                         rank_device)
from sgp_tpu_torch.parallel.sharding import (
    all_reduce_grads_, broadcast_module_, make_sharded_iid_eval,
    make_sharded_iid_step, make_sharded_iid_stratified_step,
    make_sharded_window_step, rank_generator)

__all__ = ["HaloSpec", "Mesh", "all_reduce_grads_", "broadcast_module_",
           "build_halo_spec", "encode_series_sharded", "gather_nodes",
           "halo_khop", "init_distributed", "local_mesh", "make_mesh",
           "make_sharded_iid_eval", "make_sharded_iid_step",
           "make_sharded_iid_stratified_step", "make_sharded_window_step",
           "process_rank", "rank_device", "rank_generator", "run_ranks",
           "shard_nodes", "sharded_ridge_nodes"]
