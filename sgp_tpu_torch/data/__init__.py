from sgp_tpu_torch.data.imputation import (ImputationDataset,
                                           add_missing_values, sample_mask)
from sgp_tpu_torch.data.loader import IIDLoader, WindowedLoader
from sgp_tpu_torch.data.scalers import (MinMaxScaler, RobustScaler, Scaler,
                                        ScalerParams, StandardScaler)
from sgp_tpu_torch.data.spatiotemporal import Batch, SpatioTemporalDataset
from sgp_tpu_torch.data.splitters import (AtTimeStepSplitter,
                                          DisjointMonthsSplitter,
                                          FixedIndicesSplitter, Split,
                                          Splitter, TemporalSplitter,
                                          datetime_encoded, datetime_onehot,
                                          disjoint_months, holidays_onehot,
                                          indices_between)
from sgp_tpu_torch.data.subgraph import (SubgraphLoader, SubsetLoader,
                                        cap_edges)
from sgp_tpu_torch.data.windowing import Windowing

__all__ = ["Batch", "IIDLoader", "ImputationDataset", "add_missing_values",
           "sample_mask", "MinMaxScaler", "RobustScaler", "Scaler", "ScalerParams", "Split",
           "Splitter", "SpatioTemporalDataset", "StandardScaler",
           "SubgraphLoader", "SubsetLoader", "TemporalSplitter",
           "WindowedLoader", "Windowing", "cap_edges", "datetime_encoded",
           "AtTimeStepSplitter", "DisjointMonthsSplitter",
           "FixedIndicesSplitter", "datetime_onehot", "disjoint_months",
           "holidays_onehot", "indices_between"]
