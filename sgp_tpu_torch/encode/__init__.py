from sgp_tpu_torch.encode.encoders import (SGPEncoder, SGPSpatialEncoder,
                                           build_streaming_ops)
from sgp_tpu_torch.encode.reservoir import (Reservoir, ReservoirLayerParams,
                                            reservoir_scan)
from sgp_tpu_torch.encode.spatial import (prepare_propagation_graphs,
                                          propagate_khop,
                                          sgp_spatial_embedding)

__all__ = [
    "SGPEncoder", "SGPSpatialEncoder", "build_streaming_ops", "Reservoir",
    "ReservoirLayerParams", "reservoir_scan", "prepare_propagation_graphs",
    "propagate_khop", "sgp_spatial_embedding",
]
