"""Multi-device SGP over ``torch.distributed`` (one process a rank).

Counterpart of ``sgp_tpu/parallel``: the process groups (``mesh``: the
``(data, model)`` grid and the two-level ``(host, chip)`` one), the
boundary-halo K-hop (``halo``; K1 under each shard's block in ``bsr``
mode, the flat or the two-level exchange), the sharded encode and ridge
(``encode``), the node-sharded IID and stratified steps, the
data-parallel window step, the node-sharded eval, the placements and
tensor parallelism (``sharding``), and a launcher of rank processes on one
machine (``launch``). ``Predictor(mesh=)`` (``train/predictor.py``) takes
a :class:`Mesh` from here.
"""
from sgp_tpu_torch.parallel.encode import (encode_series_sharded,
                                           sharded_ridge_nodes)
from sgp_tpu_torch.parallel.halo import (HaloSpec, build_halo_spec,
                                         gather_nodes, halo_khop,
                                         shard_nodes)
from sgp_tpu_torch.parallel.launch import run_ranks
from sgp_tpu_torch.parallel.mesh import (Mesh, init_distributed, local_mesh,
                                         make_hier_mesh, make_mesh,
                                         process_rank, rank_device)
from sgp_tpu_torch.parallel.sharding import (
    ColumnParallelLinear, all_reduce_grads_, allgather_khop,
    broadcast_module_, flax_to_tp, gather_params_tp, make_dp_tp_step,
    make_sharded_iid_eval, make_sharded_iid_step,
    make_sharded_iid_stratified_step, make_sharded_window_step,
    rank_generator, replicate, shard_batch, shard_operator,
    shard_params_tp, sharded_ridge, sharded_spmm, tp_clip_by_global_norm_)

__all__ = ["ColumnParallelLinear", "HaloSpec", "Mesh", "all_reduce_grads_",
           "allgather_khop", "broadcast_module_", "build_halo_spec",
           "encode_series_sharded", "flax_to_tp", "gather_nodes",
           "gather_params_tp", "halo_khop", "init_distributed",
           "local_mesh", "make_dp_tp_step", "make_hier_mesh", "make_mesh",
           "make_sharded_iid_eval", "make_sharded_iid_step",
           "make_sharded_iid_stratified_step", "make_sharded_window_step",
           "process_rank", "rank_device", "rank_generator", "replicate",
           "run_ranks", "shard_batch", "shard_nodes", "shard_operator",
           "shard_params_tp", "sharded_ridge", "sharded_ridge_nodes",
           "sharded_spmm", "tp_clip_by_global_norm_"]
