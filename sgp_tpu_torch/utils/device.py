"""Where the port's entry points run: the card unless the caller names the
CPU.

``Predictor``, ``OnlineForecaster``, ``SGPEncoder`` (its ``Reservoir``) and
``dense_adj_mask`` take a ``device`` argument and pass it through
:func:`resolve_device`, so a caller that names none gets ``cuda:0``, and
one that names ``"cpu"`` gets the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0``; a string or ``torch.device`` as given.

    Raises ``RuntimeError`` when ``device`` is ``None`` and CUDA is not
    available: the port never falls back to the CPU on its own; pass
    ``device="cpu"`` to run there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)
