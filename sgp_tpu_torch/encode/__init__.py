from sgp_tpu_torch.encode.encode_dataset import (encode_dataset,
                                                 encoder_input_array,
                                                 rewire_exog_keys)
from sgp_tpu_torch.encode.encoders import (GESNEncoder, SGPEncoder,
                                           SGPSpatialEncoder,
                                           SGPTemporalEncoder,
                                           build_streaming_ops,
                                           get_encoder_class,
                                           streaming_encode)
from sgp_tpu_torch.encode.graph_reservoir import GraphESN, gesn_scan
from sgp_tpu_torch.encode.reservoir import (Reservoir, ReservoirLayerParams,
                                            reservoir_scan)
from sgp_tpu_torch.encode.spatial import (prepare_propagation_graphs,
                                          propagate_khop,
                                          sgp_spatial_embedding,
                                          sgp_spatial_support)

__all__ = [
    "GESNEncoder", "GraphESN", "gesn_scan", "SGPEncoder",
    "SGPSpatialEncoder", "SGPTemporalEncoder",
    "build_streaming_ops", "encode_dataset", "encoder_input_array",
    "get_encoder_class", "rewire_exog_keys", "streaming_encode", "Reservoir",
    "ReservoirLayerParams", "reservoir_scan", "prepare_propagation_graphs",
    "propagate_khop", "sgp_spatial_embedding",
    "sgp_spatial_support",
]
