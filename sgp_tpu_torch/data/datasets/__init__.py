from sgp_tpu_torch.data.datasets.base import TabularDataset
from sgp_tpu_torch.data.datasets.synthetic import SyntheticDiffusion
from sgp_tpu_torch.data.datasets.metr_la import MetrLA
from sgp_tpu_torch.data.datasets.pems_bay import PemsBay
from sgp_tpu_torch.data.datasets.pv_us import PvUS
from sgp_tpu_torch.data.datasets.cer_en import CEREn
from sgp_tpu_torch.data.datasets.mts_benchmarks import (ElectricityBenchmark,
                                                        ExchangeBenchmark,
                                                        SolarBenchmark,
                                                        TrafficBenchmark)

__all__ = ["TabularDataset", "SyntheticDiffusion", "MetrLA", "PemsBay",
           "PvUS", "CEREn", "ElectricityBenchmark", "TrafficBenchmark",
           "SolarBenchmark", "ExchangeBenchmark"]
