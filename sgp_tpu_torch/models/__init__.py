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
from sgp_tpu_torch.models.gated_gn import (CNNResidual, Conv1dResidual,
                                           GatedGraphNetworkConvModel,
                                           GatedGraphNetworkMLPModel,
                                           full_graph_edges)
from sgp_tpu_torch.models.graph_layers import (GATConv, GatedGraphNetwork,
                                               SpatioTemporalAttention)
from sgp_tpu_torch.models.sgp import SGPModel

# the JAX registry's models not ported yet, by the ROADMAP item that ports
# them
_NOT_PORTED = {"rnn": "A6", "fc_rnn": "A6", "dcrnn": "A6", "gwnet": "A6",
               "tcn": "A6", "stcn": "A9", "rnn2gcn": "A9", "esn": "A7",
               "online_sgp": "A7"}


def get_model_class(name: str):
    """The model registry of ``sgp_tpu/models/__init__.py``: the ported
    classes by name; a model of the JAX registry not ported yet raises
    ``NotImplementedError`` naming its ROADMAP item, an unknown name
    ``KeyError``."""
    ported = {"sgp": SGPModel, "gatedgn": GatedGraphNetworkMLPModel,
              "gatedgn_conv": GatedGraphNetworkConvModel,
              "transformer": TransformerModel}
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP {_NOT_PORTED[name]})")
    return ported[name]


__all__ = ["MLP", "Dense", "GroupedLinear", "LinearReadout", "ResidualMLP",
           "StaticGraphEmbedding", "get_activation", "maybe_cat_exog",
           "SGPModel", "flax_to_torch", "GatedGraphNetwork",
           "GatedGraphNetworkMLPModel", "GatedGraphNetworkConvModel",
           "CNNResidual", "Conv1dResidual", "full_graph_edges", "GATConv",
           "SpatioTemporalAttention", "AttentionEncoder",
           "CausalLinearAttention", "MultiHeadAttention", "PositionalEncoding",
           "SpatioTemporalTransformerLayer", "TransformerLayer",
           "TransformerModel", "get_model_class"]
