from sgp_tpu_torch.utils.config import config

__all__ = ["config"]
