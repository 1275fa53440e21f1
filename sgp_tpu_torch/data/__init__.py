from sgp_tpu_torch.data.scalers import RobustScaler, Scaler, ScalerParams
from sgp_tpu_torch.data.windowing import Windowing

__all__ = ["RobustScaler", "Scaler", "ScalerParams", "Windowing"]
