from sgp_tpu_torch.ops.bsr_kernel import bsr_spmm, bsr_spmm_plain
from sgp_tpu_torch.ops.linalg import spectral_radius_exact
from sgp_tpu_torch.ops.spmm import (
    BSROperator,
    COOOperator,
    DenseOperator,
    GlobalMeanOperator,
    build_operator,
    dense_adj_mask,
)

__all__ = [
    "BSROperator", "COOOperator", "DenseOperator", "GlobalMeanOperator",
    "build_operator", "bsr_spmm", "bsr_spmm_plain", "dense_adj_mask",
    "spectral_radius_exact",
]
