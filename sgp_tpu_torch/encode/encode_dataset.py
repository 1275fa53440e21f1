"""Whole-series encoder precompute and dataset rewiring.

Counterpart of ``sgp_tpu/encode/encode_dataset.py``: pull the scaled
series (and optionally the exogenous covariates) as ``[T, N, F]``, run the
training-free encoder over the whole series once, store the result as the
covariate ``encoded_x`` and rewire the input map —

    x <- encoded_x
    u <- (u if exogenous not encoded) + (scaled raw data if keep_raw)

with the same ``.npz`` cache. By default the encoding is stored on the
host (as float32 holding the values of ``store_dtype``) and the trainer
moves it to the card once (``train/iid.py::fused_iid_inputs``); with
``device_resident=True`` it stays a tensor (in ``store_dtype``) on the
encoder's device, and the dataset gathers batches from it there.
"""
from __future__ import annotations

import inspect
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from sgp_tpu_torch.data.spatiotemporal import SpatioTemporalDataset
from sgp_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def torch_dtype(name):
    """A torch dtype from its name (``"bfloat16"``) or as given."""
    return getattr(torch, name) if isinstance(name, str) else name


def encoder_input_array(dataset: SpatioTemporalDataset,
                        encode_exogenous: bool) -> np.ndarray:
    """The encoder input series ``[T, N, F]``: the scaled target plus
    (optionally) the exogenous covariates, broadcast over nodes. Shared by
    the precompute path and the streaming runner path, so their encoder
    inputs cannot diverge."""
    prev_keys = list(dataset.input_keys)
    keys = ["target_scaled"]
    if encode_exogenous:
        keys += [k for k in dataset.exog_keys if k in dataset.covariates]
    dataset.set_input_keys(keys)
    x = np.ascontiguousarray(dataset.input_array(), np.float32)
    dataset.set_input_keys(prev_keys)
    return x


def rewire_exog_keys(dataset: SpatioTemporalDataset,
                     encode_exogenous: bool, keep_raw: bool) -> None:
    """The decoder's exogenous input after the encode:
    ``u <- (exog if not already encoded) + (scaled raw if keep_raw)``."""
    exog = [] if encode_exogenous else \
        [k for k in dataset.exog_keys if k in dataset.covariates]
    if keep_raw:
        exog = exog + ["target_scaled"]
    dataset.exog_keys = exog


def _encoder_device(encoder, device):
    if device is not None:
        return resolve_device(device)
    reservoir = getattr(encoder, "reservoir", None) or \
        getattr(encoder, "gesn", None)
    if reservoir is not None:
        return reservoir.layers[0].w_ih.device
    return resolve_device(None)


def encode_dataset(dataset: SpatioTemporalDataset,
                   encoder,
                   encode_exogenous: bool = True,
                   keep_raw: bool = False,
                   save_path: Optional[str] = None,
                   time_chunk: Optional[int] = None,
                   device_resident: bool = False,
                   store_dtype: Optional[str] = None,
                   device=None) -> SpatioTemporalDataset:
    """Encode, attach ``encoded_x``, rewire the input and exogenous keys.
    Returns the (mutated) dataset and logs the encode's wall time.

    The encode runs where the encoder's reservoir lives (or on ``device``);
    ``store_dtype`` (e.g. ``"bfloat16"``) rounds each chunk as the encoder
    writes it. ``device_resident`` keeps the encoding there as a tensor
    (a cached one is moved there). A ``save_path`` that exists is loaded
    instead of encoding; one that does not is written after it."""
    dtype = torch_dtype(store_dtype)
    if save_path is not None and os.path.exists(save_path):
        encoded = torch.from_numpy(np.load(save_path)["encoded_x"])
        if dtype is not None:
            encoded = encoded.to(dtype)
        encoded = encoded.to(_encoder_device(encoder, device)) \
            if device_resident else encoded.float().numpy()
        logger.info(f"Loaded cached encoding from {save_path}")
    else:
        dev = _encoder_device(encoder, device)
        x = torch.as_tensor(encoder_input_array(dataset, encode_exogenous),
                            device=dev)
        start = time.time()
        enc_kwargs = {}
        if time_chunk is not None:
            enc_kwargs["time_chunk"] = time_chunk
        if dtype is not None:
            enc_kwargs["out_dtype"] = dtype
        sig = inspect.signature(encoder.__call__)
        supported = {k: v for k, v in enc_kwargs.items()
                     if k in sig.parameters}
        encoded = encoder(x, dataset.graph, **supported)
        if dtype is not None and "out_dtype" not in supported:
            encoded = encoded.to(dtype)
        if device_resident:
            if encoded.device.type == "cuda":
                torch.cuda.synchronize(encoded.device)
        else:
            encoded = encoded.float().cpu().numpy()
        logger.info(f"Dataset encoded in {time.time() - start:.1f}s "
                    f"-> encoded_x {tuple(encoded.shape)}")
        if save_path is not None:
            os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
            np.savez(save_path, encoded_x=encoded.float().cpu().numpy()
                     if device_resident else encoded)

    dataset.add_covariate("encoded_x", encoded, pattern="t n c")
    dataset.set_input_keys(["encoded_x"])
    rewire_exog_keys(dataset, encode_exogenous, keep_raw)
    return dataset
