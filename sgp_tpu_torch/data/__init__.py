from sgp_tpu_torch.data.imputation import (ImputationDataset,
                                           add_missing_values, sample_mask)
from sgp_tpu_torch.data.loader import IIDLoader, WindowedLoader
from sgp_tpu_torch.data.scalers import (RobustScaler, Scaler, ScalerParams,
                                        StandardScaler)
from sgp_tpu_torch.data.spatiotemporal import Batch, SpatioTemporalDataset
from sgp_tpu_torch.data.splitters import (Split, Splitter, TemporalSplitter,
                                          datetime_encoded)
from sgp_tpu_torch.data.subgraph import (SubgraphLoader, SubsetLoader,
                                        cap_edges)
from sgp_tpu_torch.data.windowing import Windowing

__all__ = ["Batch", "IIDLoader", "ImputationDataset", "add_missing_values",
           "sample_mask", "RobustScaler", "Scaler", "ScalerParams", "Split",
           "Splitter", "SpatioTemporalDataset", "StandardScaler",
           "SubgraphLoader", "SubsetLoader", "TemporalSplitter",
           "WindowedLoader", "Windowing", "cap_edges", "datetime_encoded"]
