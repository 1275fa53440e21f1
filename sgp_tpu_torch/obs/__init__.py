from sgp_tpu_torch.obs.monitor import ResidualWhitenessMonitor
from sgp_tpu_torch.obs.profiling import (StepTimer, Throughput, profile_trace,
                                         time_fn)
from sgp_tpu_torch.obs.run_logger import RunLogger

__all__ = ["ResidualWhitenessMonitor", "RunLogger", "StepTimer",
           "Throughput", "profile_trace", "time_fn"]
