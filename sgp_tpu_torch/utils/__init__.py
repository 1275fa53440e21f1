from sgp_tpu_torch.utils.config import Config, config

__all__ = ["Config", "config"]
