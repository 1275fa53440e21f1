"""The port's entry points run on the card unless the caller names the CPU:
``device=None`` means ``cuda:0`` and, without a CUDA device, raises rather
than falling back to the CPU."""
import numpy as np
import pytest
import torch

from sgp_tpu_torch.encode import SGPEncoder
from sgp_tpu_torch.encode.reservoir import Reservoir
from sgp_tpu_torch.graph import Graph
from sgp_tpu_torch.ops import dense_adj_mask
from sgp_tpu_torch.serve import OnlineForecaster
from sgp_tpu_torch.train import Predictor
from sgp_tpu_torch.utils.device import resolve_device

_GRAPH = Graph(np.arange(4), np.arange(1, 5) % 4, np.ones(4, np.float32), 4)

ENTRY_POINTS = {
    "Predictor": lambda device: Predictor(torch.nn.Linear(2, 1),
                                          device=device).device,
    "OnlineForecaster": lambda device: OnlineForecaster(
        SGPEncoder(input_size=1, reservoir_size=4, device="cpu"), _GRAPH,
        torch.nn.Identity(), None, device=device).device,
    "SGPEncoder": lambda device: SGPEncoder(
        input_size=1, reservoir_size=4, device=device).reservoir.layers[0]
    .w_hh.device,
    "Reservoir": lambda device: Reservoir(
        input_size=1, hidden_size=4, device=device).layers[0].w_ih.device,
    "dense_adj_mask": lambda device: dense_adj_mask(_GRAPH,
                                                    device=device).device,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_device_none_is_the_card(name):
    make = ENTRY_POINTS[name]
    assert make("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert make(None) == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make(None)


def test_resolve_device_takes_a_named_device_as_given():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)
