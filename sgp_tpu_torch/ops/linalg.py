"""Dense linear algebra helpers (counterpart of ``sgp_tpu/ops/linalg.py``).

The reservoir's init rescales by the spectral radius: exactly on the host
(LAPACK) for small matrices, or by a two-column subspace iteration on the
device, which captures a dominant complex-conjugate pair (the generic case
for random reservoir matrices, where plain power iteration oscillates).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sgp_tpu_torch.utils.device import resolve_device


def spectral_radius_exact(w: np.ndarray) -> float:
    """Host-side exact |λ|max via LAPACK (init-time, small matrices)."""
    return float(np.abs(np.linalg.eigvals(np.asarray(w, np.float64))).max())


def power_iteration_spectral_radius(
        w, num_iters: int = 1500, seed: int = 0, q0=None,
        generator: Optional[torch.Generator] = None,
        device=None) -> torch.Tensor:
    """Estimate |λ|max of a real square matrix on ``device``.

    Orthogonal iteration on an ``[n, 2]`` block (``q0``, else a standard
    normal draw from ``generator``, else from a generator seeded with
    ``seed``), then the modulus of the dominant pair read off the projected
    2x2 matrix analytically: ``sqrt(|det|)`` when its discriminant is
    negative, its larger root's modulus otherwise."""
    w = torch.as_tensor(w, device=resolve_device(device))
    n = w.shape[0]
    if q0 is None:
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        q0 = torch.randn((n, 2), generator=generator, dtype=w.dtype)
    q = torch.linalg.qr(torch.as_tensor(q0, dtype=w.dtype,
                                        device=w.device))[0]
    for _ in range(num_iters):
        q = torch.linalg.qr(w @ q)[0]
    b = q.T @ (w @ q)   # 2x2 projected matrix holding the dominant pair
    tr = b[0, 0] + b[1, 1]
    det = b[0, 0] * b[1, 1] - b[0, 1] * b[1, 0]
    disc = tr * tr - 4.0 * det
    root = torch.sqrt(disc.abs())
    real_mod = torch.maximum((tr + root).abs(), (tr - root).abs()) / 2.0
    complex_mod = torch.sqrt(det.abs())
    return torch.where(disc >= 0, real_mod, complex_mod)
