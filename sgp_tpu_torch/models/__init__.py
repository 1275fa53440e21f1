from sgp_tpu_torch.models.blocks import (MLP, Dense, GroupedLinear,
                                         LinearReadout, ResidualMLP,
                                         StaticGraphEmbedding, get_activation,
                                         maybe_cat_exog)
from sgp_tpu_torch.models.bridge import flax_to_torch
from sgp_tpu_torch.models.sgp import SGPModel

__all__ = ["MLP", "Dense", "GroupedLinear", "LinearReadout", "ResidualMLP",
           "StaticGraphEmbedding", "get_activation", "maybe_cat_exog",
           "SGPModel", "flax_to_torch"]
