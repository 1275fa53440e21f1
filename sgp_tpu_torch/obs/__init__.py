from sgp_tpu_torch.obs.run_logger import RunLogger

__all__ = ["RunLogger"]
