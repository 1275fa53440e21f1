from sgp_tpu_torch.models.attention import (AttentionEncoder,
                                            CausalLinearAttention,
                                            MultiHeadAttention,
                                            PositionalEncoding,
                                            SpatioTemporalTransformerLayer,
                                            TransformerLayer,
                                            TransformerModel)
from sgp_tpu_torch.models.blocks import (MLP, Dense, GroupedLinear,
                                         LinearReadout, MLPDecoder,
                                         ResidualMLP, StaticGraphEmbedding,
                                         get_activation, maybe_cat_exog)
from sgp_tpu_torch.models.bridge import flax_to_torch
from sgp_tpu_torch.models.dcrnn import DCRNN, DCRNNCell, DCRNNModel
from sgp_tpu_torch.models.esn import ESNModel
from sgp_tpu_torch.models.gated_gn import (CNNResidual, Conv1dResidual,
                                           GatedGraphNetworkConvModel,
                                           GatedGraphNetworkMLPModel,
                                           full_graph_edges)
from sgp_tpu_torch.models.grin import GRIL, GRINModel, SpatialDecoder
from sgp_tpu_torch.models.graph_layers import (ConditionalBlock, DiffConv,
                                               GATConv, GatedGraphNetwork,
                                               GraphConv,
                                               SpatioTemporalAttention,
                                               diff_conv_support,
                                               diff_conv_support_from_arrays)
from sgp_tpu_torch.models.gwnet import (DenseSpatialConvOrderK,
                                        GraphWaveNetModel)
from sgp_tpu_torch.models.rnn import FCRNNModel, RNNModel
from sgp_tpu_torch.models.rnni import BiRNNImputerModel, RNNImputerModel
from sgp_tpu_torch.models.sgp import SGPModel, SGPOnlineModel
from sgp_tpu_torch.models.stgn_extra import (AttPool, Concatenate,
                                             ConditionalTCNBlock,
                                             DenseDCRNNCell,
                                             DifferentiableBinarySampler,
                                             GCNDecoder, GraphConvGRUCell,
                                             GraphConvLSTMCell, GraphConvRNN,
                                             InputEncoder, Lambda,
                                             LinkPredictor,
                                             MultiHorizonMLPDecoder, NRIDCRNN,
                                             RNNEncGCNDecModel, Select,
                                             STCNBlock, STCNModel)
from sgp_tpu_torch.models.tcn import (Norm, TCNModel, TemporalConv,
                                      TemporalConvNet)


def get_model_class(name: str):
    """The model registry of ``sgp_tpu/models/__init__.py``: the ported
    classes by name, and the imputers of ``exp/run_imputation.py``
    (``grin``, ``rnni``, ``birnni``); an unknown name raises
    ``KeyError``."""
    ported = {"sgp": SGPModel, "online_sgp": SGPOnlineModel,
              "esn": ESNModel, "gatedgn": GatedGraphNetworkMLPModel,
              "gatedgn_conv": GatedGraphNetworkConvModel,
              "transformer": TransformerModel, "rnn": RNNModel,
              "fc_rnn": FCRNNModel, "dcrnn": DCRNNModel,
              "gwnet": GraphWaveNetModel, "tcn": TCNModel,
              "stcn": STCNModel, "rnn2gcn": RNNEncGCNDecModel,
              "grin": GRINModel, "rnni": RNNImputerModel,
              "birnni": BiRNNImputerModel}
    return ported[name]


__all__ = ["MLP", "Dense", "GroupedLinear", "LinearReadout", "ResidualMLP",
           "StaticGraphEmbedding", "get_activation", "maybe_cat_exog",
           "SGPModel", "SGPOnlineModel", "ESNModel", "flax_to_torch", "GatedGraphNetwork",
           "GatedGraphNetworkMLPModel", "GatedGraphNetworkConvModel",
           "CNNResidual", "Conv1dResidual", "full_graph_edges", "GATConv",
           "SpatioTemporalAttention", "AttentionEncoder",
           "CausalLinearAttention", "MultiHeadAttention", "PositionalEncoding",
           "SpatioTemporalTransformerLayer", "TransformerLayer",
           "TransformerModel", "get_model_class", "MLPDecoder", "DCRNN",
           "DCRNNCell", "DCRNNModel", "ConditionalBlock", "DiffConv",
           "GraphConv", "diff_conv_support", "diff_conv_support_from_arrays",
           "DenseSpatialConvOrderK", "GraphWaveNetModel", "FCRNNModel",
           "RNNModel", "Norm", "TCNModel", "TemporalConv", "TemporalConvNet",
           "GRIL", "GRINModel", "SpatialDecoder", "RNNImputerModel",
           "BiRNNImputerModel", "GraphConvGRUCell", "GraphConvLSTMCell",
           "GraphConvRNN", "DenseDCRNNCell", "ConditionalTCNBlock",
           "InputEncoder", "STCNBlock", "MultiHorizonMLPDecoder",
           "GCNDecoder", "AttPool", "STCNModel", "RNNEncGCNDecModel",
           "LinkPredictor", "DifferentiableBinarySampler", "NRIDCRNN",
           "Lambda", "Concatenate", "Select"]
