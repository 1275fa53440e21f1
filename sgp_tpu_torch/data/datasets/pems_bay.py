"""PEMS-BAY traffic dataset loader: 325 Bay Area sensors, 5-min, Jan-May
2017 (52,116 steps). Local files only: ``<data_dir>/PemsBay/pems_bay.h5``
(h5py layout) + ``pems_bay_dist.npy`` (or ``distances_bay.csv``).
"""
from sgp_tpu_torch.data.datasets.metr_la import _PemsBayBase


class PemsBay(_PemsBayBase):
    def __init__(self, root=None, mask_zeros: bool = True):
        self.mask_zeros = mask_zeros
        super().__init__(root=root)
