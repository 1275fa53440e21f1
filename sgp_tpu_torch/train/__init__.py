from sgp_tpu_torch.train.metrics import (MaskedMetrics, MetricSpec,
                                         masked_mae, masked_mape, masked_mre,
                                         masked_mse, masked_rmse)
from sgp_tpu_torch.train.predictor import Predictor

__all__ = ["MaskedMetrics", "MetricSpec", "Predictor", "masked_mae",
           "masked_mape", "masked_mre", "masked_mse", "masked_rmse"]
