from sgp_tpu_torch.data.datasets.base import TabularDataset
from sgp_tpu_torch.data.datasets.synthetic import SyntheticDiffusion

__all__ = ["TabularDataset", "SyntheticDiffusion"]
