from sgp_tpu_torch.models.attention import (AttentionEncoder,
                                            CausalLinearAttention,
                                            MultiHeadAttention,
                                            PositionalEncoding,
                                            SpatioTemporalTransformerLayer,
                                            TransformerLayer,
                                            TransformerModel)
from sgp_tpu_torch.models.blocks import (MLP, Dense, GroupedLinear,
                                         LinearReadout, ResidualMLP,
                                         StaticGraphEmbedding, get_activation,
                                         maybe_cat_exog)
from sgp_tpu_torch.models.bridge import flax_to_torch
from sgp_tpu_torch.models.gated_gn import (GatedGraphNetworkMLPModel,
                                           full_graph_edges)
from sgp_tpu_torch.models.graph_layers import (GATConv, GatedGraphNetwork,
                                               SpatioTemporalAttention)
from sgp_tpu_torch.models.sgp import SGPModel

__all__ = ["MLP", "Dense", "GroupedLinear", "LinearReadout", "ResidualMLP",
           "StaticGraphEmbedding", "get_activation", "maybe_cat_exog",
           "SGPModel", "flax_to_torch", "GatedGraphNetwork",
           "GatedGraphNetworkMLPModel", "full_graph_edges", "GATConv",
           "SpatioTemporalAttention", "AttentionEncoder",
           "CausalLinearAttention", "MultiHeadAttention", "PositionalEncoding",
           "SpatioTemporalTransformerLayer", "TransformerLayer",
           "TransformerModel"]
