"""The port's recurrent and temporal-convolution forecasters against the
JAX package's, on the CPU.

The same numpy inputs (from a seed) and the same weights (carried with
``models/bridge.py``) go through both: ``RNNModel`` and ``FCRNNModel`` with
GRU and LSTM cells (flax's ``GRUCell`` and ``OptimizedLSTMCell`` against
``torch.nn.GRU`` and ``torch.nn.LSTM``, whose extra biases the port holds
at 0) and ``TCNModel``, forward and a ``Predictor`` step. Tolerance: 1e-5
relative to the largest value (``test_torch_port_diffconv.rel_close``).
"""
import numpy as np
import pytest
import torch

from sgp_tpu.models.rnn import FCRNNModel as JFCRNNModel
from sgp_tpu.models.rnn import RNNModel as JRNNModel
from sgp_tpu.models.stgn_extra import TCNModel as JTCNModel

from sgp_tpu_torch.models import FCRNNModel, RNNModel, TCNModel
from test_torch_port_diffconv import (carry, predictor_step_matches,
                                      rel_close, t)

torch.set_num_threads(1)

N, B, S, C, U, H = 5, 3, 6, 2, 3, 8


def _batch(rng, with_u=True):
    batch = {"x": rng.standard_normal((B, S, N, C)).astype(np.float32),
             "y": rng.standard_normal((B, 3, N, C)).astype(np.float32),
             "mask": rng.random((B, 3, N, C)) > 0.2}
    if with_u:
        batch["u"] = rng.standard_normal((B, S, U)).astype(np.float32)
    return batch


def _forward_matches(jm, tm, batch):
    u = batch.get("u")
    params = carry(jm, tm, batch["x"], u=u)
    got = tm.eval()(t(batch["x"]), u=None if u is None else t(u))
    assert got.shape == (B, 3, N, C)
    rel_close(got.detach(), jm.apply(params, batch["x"], u=u))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("rec_layers,ff_layers,with_u", [
    (1, 1, True), (2, 2, False)])
def test_rnn_model_matches(rng, cell, rec_layers, ff_layers, with_u):
    kw = dict(hidden_size=H, ff_size=H, rec_layers=rec_layers,
              ff_layers=ff_layers, cell_type=cell)
    _forward_matches(JRNNModel(C, 3, **kw),
                     RNNModel(C + (U if with_u else 0), C, 3, **kw),
                     _batch(rng, with_u))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_fc_rnn_model_matches(rng, cell):
    kw = dict(hidden_size=H, ff_size=H, cell_type=cell)
    _forward_matches(JFCRNNModel(N, C, 3, **kw),
                     FCRNNModel(N * (C + U), N, C, 3, **kw), _batch(rng))


@pytest.mark.parametrize("gated,n_layers", [(False, 3), (True, 2)])
def test_tcn_model_matches(rng, gated, n_layers):
    kw = dict(n_layers=n_layers, gated=gated)
    _forward_matches(JTCNModel(H, H, C, 3, **kw),
                     TCNModel(C + U, H, H, C, 3, **kw), _batch(rng))


def _default_call(batch, training):
    kwargs = {"training": training}
    if "u" in batch:
        kwargs["u"] = batch["u"]
    return (batch["x"],), kwargs


@pytest.mark.parametrize("model", ["gru", "lstm", "fc_lstm", "tcn"])
def test_predictor_step_matches(rng, model):
    """One ``Predictor`` step (the runners' default call), then the biases
    flax's cells lack still 0 in the port's cuDNN-layout weights."""
    kw = dict(hidden_size=H, ff_size=H, cell_type=model[-4:].lstrip("_"))
    if model in ("gru", "lstm"):
        jm, tm = JRNNModel(C, 3, **kw), RNNModel(C + U, C, 3, **kw)
    elif model == "fc_lstm":
        jm, tm = JFCRNNModel(N, C, 3, **kw), FCRNNModel(N * (C + U), N, C, 3,
                                                        **kw)
    else:
        jm, tm = JTCNModel(H, H, C, 3, n_layers=1), TCNModel(C + U, H, H, C,
                                                             3, n_layers=1)
    predictor_step_matches(jm, tm, _batch(rng), _default_call, _default_call)
    if model != "tcn":
        rnn = tm.rnn
        for name, p in rnn.rnn.named_parameters():
            if name.startswith("bias_"):
                keep = rnn.keep_ih if name.startswith("bias_ih") \
                    else rnn.keep_hh
                assert torch.all(p[keep == 0] == 0), name
                assert torch.all(p.grad[keep == 0] == 0), name


def test_rnn_stack_rejects_other_cells():
    with pytest.raises(ValueError, match="gru"):
        RNNModel(C, C, 3, cell_type="rnn")


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_rnn_model_in_chunks_matches(rng, cell, monkeypatch):
    """The recurrence over ``CHUNK`` sequences at a time (15 series here,
    4 a chunk) gives the JAX model's forecast."""
    from sgp_tpu_torch.models.rnn import RNNStack
    monkeypatch.setattr(RNNStack, "CHUNK", 4)
    kw = dict(hidden_size=H, ff_size=H, cell_type=cell)
    _forward_matches(JRNNModel(C, 3, **kw), RNNModel(C + U, C, 3, **kw),
                     _batch(rng))
