"""Dense linear algebra helpers (counterpart of ``sgp_tpu/ops/linalg.py``)."""
from __future__ import annotations

import numpy as np


def spectral_radius_exact(w: np.ndarray) -> float:
    """Host-side exact |λ|max via LAPACK (init-time, small matrices)."""
    return float(np.abs(np.linalg.eigvals(np.asarray(w, np.float64))).max())
