from sgp_tpu_torch.ops.bsr_kernel import bsr_spmm, bsr_spmm_plain
from sgp_tpu_torch.ops.functional import sparse_multi_head_attention
from sgp_tpu_torch.ops.linalg import (power_iteration_spectral_radius,
                                      spectral_radius_exact)
from sgp_tpu_torch.ops.spmm import (
    BSROperator,
    COOOperator,
    DenseOperator,
    GlobalMeanOperator,
    build_operator,
    dense_adj_mask,
)
from sgp_tpu_torch.ops.sddmm import (bsr_attention_structure, bsr_sddmm,
                                     bsr_multi_head_attention)

__all__ = [
    "BSROperator", "COOOperator", "DenseOperator", "GlobalMeanOperator",
    "build_operator", "bsr_spmm", "bsr_spmm_plain", "dense_adj_mask",
    "power_iteration_spectral_radius", "spectral_radius_exact",
    "bsr_attention_structure", "bsr_sddmm",
    "bsr_multi_head_attention", "sparse_multi_head_attention",
]
