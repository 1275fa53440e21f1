"""Load a flax parameter tree into a model of the port: :class:`SGPModel`,
:class:`SGPOnlineModel` (its decoder under ``SGPModel_0``),
:class:`ESNModel` (only its readout is a parameter),
:class:`GatedGraphNetworkMLPModel`, :class:`GatedGraphNetworkConvModel`,
:class:`TransformerModel`, or one of the attention layers on its own
(``MultiHeadAttention``, ``AttentionEncoder``, ``CausalLinearAttention``,
``TransformerLayer``, ``SpatioTemporalTransformerLayer``, ``GATConv``,
``SpatioTemporalAttention``).

The tree comes as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, params)``), with or without its top-level
``"params"`` key. Module names follow flax's creation order: for SGP
``GroupedLinear_0``, ``StaticGraphEmbedding_0``, ``Dense_0``,
``ResidualMLP_0/…`` or ``MLP_0/…``, ``LinearReadout_0/Dense_0``; for
GatedGN see :func:`_gated_gn_targets`; for the attention stack the flax
names of ``sgp_tpu/models/attention.py`` (``q``, ``k``, ``v``, ``out``,
``LayerNorm_i``, ``MultiHeadAttention_i``, ``MLP_0``, ``DenseGeneral_i``).
``Dense`` kernels are transposed from flax's ``[in, out]`` to
``nn.Linear``'s ``[out, in]``; ``DenseGeneral`` kernels ``[in, h, dh]`` and
``[h, dh, out]`` are flattened over ``h * dh`` first; ``Conv`` kernels
``[k, in, out]`` become ``Conv1d.weight``'s ``[out, in, k]``. Any key
missing from the tree or left over in it raises.

The diffusion baselines (``DCRNNModel``, ``GraphWaveNetModel``,
``RNNModel``, ``FCRNNModel``, ``TCNModel`` and their layers): flax's
``GRUCell`` and ``OptimizedLSTMCell`` keep one Dense a gate (``ir``,
``iz``, ``in``, ``hr``, ``hz``, ``hn``; ``ii`` .. ``ho``), each loaded into
its rows of ``nn.GRU``'s / ``nn.LSTM``'s stacked weights and biases (the
biases flax lacks stay 0). GraphWaveNet's layers lie under
``_GWNetBlock_i`` or, scanned, stacked along a leading block axis under
``ScanCheckpoint_GWNetBlock_0`` (``GraphWaveNetModel.flax_blocks``).

The imputers: ``GRINModel`` (``GRIL_0`` forward, ``GRIL_1`` backward,
``MLP_0`` the merge; see :func:`_gril`), ``RNNImputerModel``
(``rnn_cell``, ``readout``) and ``BiRNNImputerModel`` (``fwd_rnn``,
``bwd_rnn``, ``Dense_0``).

The rest of the zoo (``models/stgn_extra.py``): the GraphConv cells'
gates are ``GraphConv_0..2`` (r, u, c) or ``GraphConv_0..3`` (i, f, g, o)
under ``GraphConvGRUCell_l`` / ``GraphConvLSTMCell_l``; ``DenseDCRNNCell``'s
gates are named ``forget``, ``update`` and ``cand``; ``STCNBlock`` holds
``TemporalConvNet_0``, ``GraphConv_0``, ``Dense_0`` (the skip, when the
widths differ) and ``LayerNorm_0``; ``MultiHorizonMLPDecoder`` its
``step_emb`` beside ``MLP_0``; ``RNNEncGCNDecModel`` ``_RNNStack_0`` and
``GCNDecoder_0``; ``LinkPredictor`` ``Dense_0..1`` (source branch) and
``Dense_2..3`` (target branch); ``NRIDCRNN`` the embedding,
``LinkPredictor_0`` and ``DenseDCRNNCell_l``.
"""
from __future__ import annotations

import copy
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from sgp_tpu_torch.models.attention import (AttentionEncoder,
                                            CausalLinearAttention,
                                            MultiHeadAttention,
                                            SpatioTemporalTransformerLayer,
                                            TransformerLayer,
                                            TransformerModel)
from sgp_tpu_torch.models.blocks import MLP, MLPDecoder
from sgp_tpu_torch.models.dcrnn import DCRNNModel
from sgp_tpu_torch.models.esn import ESNModel
from sgp_tpu_torch.models.gated_gn import (CNNResidual,
                                           GatedGraphNetworkConvModel,
                                           GatedGraphNetworkMLPModel)
from sgp_tpu_torch.models.grin import GRIL, GRINModel, SpatialDecoder
from sgp_tpu_torch.models.graph_layers import (ConditionalBlock, DiffConv,
                                               GATConv, GatedGraphNetwork,
                                               GraphConv,
                                               SpatioTemporalAttention)
from sgp_tpu_torch.models.gwnet import (DenseSpatialConvOrderK, GWNetLayer,
                                        GraphWaveNetModel)
from sgp_tpu_torch.models.rnn import FCRNNModel, RNNModel, RNNStack
from sgp_tpu_torch.models.rnni import (BiRNNImputerModel, FlaxRNNCell,
                                       RNNImputerModel)
from sgp_tpu_torch.models.sgp import SGPModel, SGPOnlineModel
from sgp_tpu_torch.models.stgn_extra import (AttPool, ConditionalTCNBlock,
                                             DenseDCRNNCell, GCNDecoder,
                                             GraphConvGRUCell,
                                             GraphConvLSTMCell, GraphConvRNN,
                                             InputEncoder, LinkPredictor,
                                             MultiHorizonMLPDecoder, NRIDCRNN,
                                             RNNEncGCNDecModel, STCNBlock,
                                             STCNModel)
from sgp_tpu_torch.models.tcn import (Norm, TCNModel, TemporalConv,
                                      TemporalConvNet)

Path = Tuple[str, ...]


def _heads_in(a: np.ndarray) -> np.ndarray:
    """A ``DenseGeneral((h, dh))`` kernel ``[in, h, dh]`` as ``[h*dh, in]``
    (its bias ``[h, dh]`` as ``[h*dh]`` passes through ``_flat``)."""
    return a.reshape(a.shape[0], -1).T


def _heads_out(a: np.ndarray) -> np.ndarray:
    """A ``DenseGeneral(out, axis=(-2, -1))`` kernel ``[h, dh, out]`` as
    ``[out, h*dh]``."""
    return a.reshape(-1, a.shape[-1]).T


def _flat(a: np.ndarray) -> np.ndarray:
    return a.reshape(-1)


def to_torch_layout(value: np.ndarray, how) -> np.ndarray:
    """A flax array in its torch parameter's layout: ``how`` is ``True``
    (transpose), ``False`` (as it is) or a function of the array."""
    if how is True:
        return value.T
    return value if how is False else how(value)


def _linear(out: dict, prefix: Path, lin: nn.Linear):
    out[prefix + ("kernel",)] = (lin.weight, True)
    out[prefix + ("bias",)] = (lin.bias, False)


def _trunk(out: dict, scope: Path, trunk: nn.Module):
    """An ``MLP`` or ``ResidualMLP``: flax numbers every Dense-named
    submodule of the trunk with one shared counter, in creation order."""
    k = 0
    for layer in trunk.layers:
        dense = layer if isinstance(trunk, MLP) else layer.dense
        _linear(out, scope + (f"Dense_{k}", "Dense_0"), dense.linear)
        k += 1
        if not isinstance(trunk, MLP):
            _linear(out, scope + (f"Dense_{k}",), layer.linear)
            k += 1
            if layer.skip is not None:
                _linear(out, scope + (f"Dense_{k}",), layer.skip)
                k += 1
    if trunk.readout is not None:
        _linear(out, scope + (f"Dense_{k}",), trunk.readout)


def _targets(model: SGPModel) -> Dict[Path, Tuple[torch.Tensor, bool]]:
    """flax path -> (torch parameter, transpose?) for every parameter."""
    out: Dict[Path, Tuple[torch.Tensor, bool]] = {}
    n_dense = 0
    if isinstance(model.encoder, nn.Linear):
        _linear(out, (f"Dense_{n_dense}",), model.encoder)
        n_dense += 1
    else:
        out[("GroupedLinear_0", "kernel")] = (model.encoder.weight, False)
        out[("GroupedLinear_0", "bias")] = (model.encoder.bias, False)
    if model.emb is not None:
        out[("StaticGraphEmbedding_0", "emb")] = (model.emb.emb, False)
        _linear(out, (f"Dense_{n_dense}",), model.emb_proj)
    trunk = model.mlp
    _trunk(out, ("MLP_0",) if isinstance(trunk, MLP) else ("ResidualMLP_0",),
           trunk)
    _linear(out, ("LinearReadout_0", "Dense_0"), model.readout.linear)
    return out


def _sgp_online(out: dict, scope: Path, m: SGPOnlineModel):
    for path, target in _targets(m.sgp).items():
        out[scope + ("SGPModel_0",) + path] = target


def _esn(out: dict, scope: Path, m: ESNModel):
    """Only the readout: the reservoir is frozen buffers, as it lies
    outside the flax variables."""
    _linear(out, scope + ("LinearReadout_0", "Dense_0"), m.readout.linear)


def _gn_layer(out: dict, scope: Path, layer: GatedGraphNetwork):
    """One ``GatedGraphNetwork``: ``Dense_0`` p_i, ``Dense_1`` p_j (no
    bias), ``Dense_2`` message, ``Dense_3`` gate, ``Dense_4`` and
    ``Dense_5`` the update, ``Dense_6`` the skip when there is one."""
    _linear(out, scope + ("Dense_0",), layer.p_i)
    out[scope + ("Dense_1", "kernel")] = (layer.p_j.weight, True)
    for k, lin in enumerate((layer.msg, layer.gate, layer.update1,
                             layer.update2, layer.skip), start=2):
        if lin is not None:
            _linear(out, scope + (f"Dense_{k}",), lin)


def _gated_gn_targets(model: GatedGraphNetworkMLPModel
                      ) -> Dict[Path, Tuple[torch.Tensor, bool]]:
    """The MLP encoder's input Dense is ``Dense_0``; in each residual block
    ``Dense(h)(act(Dense(h)(h)))`` the outer Dense is constructed first and
    takes the lower number though it is applied second. Then the embedding,
    the ``GatedGraphNetwork_i`` layers, the decoder Dense and the readout
    Dense."""
    out: Dict[Path, Tuple[torch.Tensor, bool]] = {}
    _linear(out, ("Dense_0",), model.enc_in)
    k = 1
    for blk in model.enc:
        _linear(out, (f"Dense_{k}",), blk["outer"])
        _linear(out, (f"Dense_{k + 1}",), blk["inner"])
        k += 2
    if model.emb is not None:
        out[("StaticGraphEmbedding_0", "emb")] = (model.emb.emb, False)
    for i, layer in enumerate(model.gnn):
        _gn_layer(out, (f"GatedGraphNetwork_{i}",), layer)
    _linear(out, (f"Dense_{k}",), model.dec)
    _linear(out, (f"Dense_{k + 1}",), model.readout)
    return out


def _conv_kernel(a: np.ndarray) -> np.ndarray:
    """A flax ``nn.Conv`` kernel ``[k, in, out]`` as ``Conv1d.weight``'s
    ``[out, in, k]``."""
    return a.transpose(2, 1, 0)


def _conv(out: dict, prefix: Path, conv: nn.Conv1d):
    out[prefix + ("kernel",)] = (conv.weight, _conv_kernel)
    out[prefix + ("bias",)] = (conv.bias, False)


def _cnn_residual(out: dict, scope: Path, cnn: CNNResidual):
    """Layer i's strided ``Conv_i`` and ``Conv1dResidual_i`` (its inner
    ``Conv_0`` and outer ``Conv_1``), then ``Dense_0`` when there is one."""
    for i, (conv, res) in enumerate(zip(cnn.convs, cnn.res)):
        _conv(out, scope + (f"Conv_{i}",), conv)
        _conv(out, scope + (f"Conv1dResidual_{i}", "Conv_0"), res.inner)
        _conv(out, scope + (f"Conv1dResidual_{i}", "Conv_1"), res.outer)
    if cnn.out is not None:
        _linear(out, scope + ("Dense_0",), cnn.out)


def _gated_gn_conv_targets(model: GatedGraphNetworkConvModel
                           ) -> Dict[Path, Tuple[torch.Tensor, object]]:
    """``CNNResidual_0``, then the embedding, the ``GatedGraphNetwork_i``
    layers, the decoder ``Dense_0`` and the readout ``Dense_1``."""
    out: Dict[Path, Tuple[torch.Tensor, object]] = {}
    _cnn_residual(out, ("CNNResidual_0",), model.cnn)
    if model.emb is not None:
        out[("StaticGraphEmbedding_0", "emb")] = (model.emb.emb, False)
    for i, layer in enumerate(model.gnn):
        _gn_layer(out, (f"GatedGraphNetwork_{i}",), layer)
    _linear(out, ("Dense_0",), model.dec)
    _linear(out, ("Dense_1",), model.readout)
    return out


def _dense_general(out: dict, prefix: Path, lin: nn.Linear, heads_in: bool):
    out[prefix + ("kernel",)] = (lin.weight,
                                 _heads_in if heads_in else _heads_out)
    out[prefix + ("bias",)] = (lin.bias, _flat)


def _layer_norm(out: dict, prefix: Path, ln: nn.LayerNorm):
    out[prefix + ("scale",)] = (ln.weight, False)
    out[prefix + ("bias",)] = (ln.bias, False)


def _mha(out: dict, scope: Path, m: MultiHeadAttention):
    for name in ("q", "k", "v"):
        _dense_general(out, scope + (name,), getattr(m, name), True)
    _dense_general(out, scope + ("out",), m.out, False)


def _attention_encoder(out: dict, scope: Path, m: AttentionEncoder):
    for i, lin in enumerate((m.q_in, m.k_in, m.v_in)):
        _linear(out, scope + (f"Dense_{i}",), lin)
    _mha(out, scope + ("MultiHeadAttention_0",), m.mha)


def _linear_attention(out: dict, scope: Path, m: CausalLinearAttention):
    for i, lin in enumerate((m.q, m.k, m.v)):
        _dense_general(out, scope + (f"DenseGeneral_{i}",), lin, True)
    _dense_general(out, scope + ("DenseGeneral_3",), m.out, False)


def _transformer_layer(out: dict, scope: Path, m: TransformerLayer):
    if m.proj is not None:
        _linear(out, scope + ("Dense_0",), m.proj)
    _layer_norm(out, scope + ("LayerNorm_0",), m.norm1)
    _mha(out, scope + ("MultiHeadAttention_0",), m.attention)
    _layer_norm(out, scope + ("LayerNorm_1",), m.norm2)
    _trunk(out, scope + ("MLP_0",), m.mlp)


def _st_transformer_layer(out: dict, scope: Path,
                          m: SpatioTemporalTransformerLayer):
    _transformer_layer(out, scope + ("TransformerLayer_0",), m.temporal)
    _transformer_layer(out, scope + ("TransformerLayer_1",), m.spatial)


def _transformer_model(out: dict, scope: Path, m: TransformerModel):
    _linear(out, scope + ("Dense_0",), m.encoder)
    for i, layer in enumerate(m.layers):
        if isinstance(layer, SpatioTemporalTransformerLayer):
            _st_transformer_layer(
                out, scope + (f"SpatioTemporalTransformerLayer_{i}",), layer)
        else:
            _transformer_layer(out, scope + (f"TransformerLayer_{i}",), layer)
    _trunk(out, scope + ("MLP_0",), m.readout)


def _gat_conv(out: dict, scope: Path, m: GATConv):
    _dense_general(out, scope + ("DenseGeneral_0",), m.lin, True)
    out[scope + ("a_src",)] = (m.a_src, False)
    out[scope + ("a_dst",)] = (m.a_dst, False)


def _st_attention(out: dict, scope: Path, m: SpatioTemporalAttention):
    if m.proj is not None:
        _linear(out, scope + ("Dense_0",), m.proj)
    _mha(out, scope + ("MultiHeadAttention_0",), m.temporal)
    _layer_norm(out, scope + ("LayerNorm_0",), m.norm1)
    _mha(out, scope + ("MultiHeadAttention_1",), m.spatial)
    _layer_norm(out, scope + ("LayerNorm_1",), m.norm2)


def _mlp_decoder(out: dict, scope: Path, m: MLPDecoder):
    _trunk(out, scope + ("MLP_0",), m.mlp)


def _diff_conv(out: dict, scope: Path, m: DiffConv):
    _linear(out, scope + ("Dense_0",), m.linear)


def _conditional_block(out: dict, scope: Path, m: ConditionalBlock):
    for k, lin in enumerate((m.x_in, m.u_in, m.lin)):
        _linear(out, scope + (f"Dense_{k}",), lin)
    out[scope + ("Dense_3", "kernel")] = (m.u_out.weight, True)
    if m.skip is not None:
        _linear(out, scope + ("Dense_4",), m.skip)


def _graph_conv(out: dict, scope: Path, m: GraphConv):
    out[scope + ("Dense_0", "kernel")] = (m.lin.weight, True)
    if m.root is not None:
        out[scope + ("root", "kernel")] = (m.root.weight, True)
    if m.bias is not None:
        out[scope + ("bias",)] = (m.bias, False)


def _temporal_conv(out: dict, scope: Path, m: TemporalConv):
    _conv(out, scope + ("Conv_0",), m.conv)


def _temporal_conv_net(out: dict, scope: Path, m: TemporalConvNet):
    for i, layer in enumerate(m.layers):
        _temporal_conv(out, scope + (f"TemporalConv_{i}",), layer)


def _norm(out: dict, scope: Path, m: Norm):
    if m.scale is not None:
        out[scope + ("scale",)] = (m.scale, False)
        out[scope + ("bias",)] = (m.bias, False)
    elif m.layer_norm is not None:
        _layer_norm(out, scope + ("LayerNorm_0",), m.layer_norm)


def _dense_spatial(out: dict, scope: Path, m: DenseSpatialConvOrderK):
    _linear(out, scope + ("Dense_0",), m.linear)


def _dcrnn_model(out: dict, scope: Path, m: DCRNNModel):
    """``ConditionalBlock_0`` (or ``Dense_0``), ``DCRNN_0/DCRNNCell_i`` with
    ``DiffConv_0..2`` for r, u and c, ``MLPDecoder_0``."""
    if isinstance(m.encoder, ConditionalBlock):
        _conditional_block(out, scope + ("ConditionalBlock_0",), m.encoder)
    else:
        _linear(out, scope + ("Dense_0",), m.encoder)
    for i, cell in enumerate(m.dcrnn.cells):
        for k, conv in enumerate((cell.r, cell.u, cell.c)):
            _diff_conv(out, scope + ("DCRNN_0", f"DCRNNCell_{i}",
                                     f"DiffConv_{k}"), conv)
    _mlp_decoder(out, scope + ("MLPDecoder_0",), m.decoder)


def _gwnet_layer(out: dict, scope: Path, j: int, m: GWNetLayer):
    """Layer ``j`` of a ``_GWNetBlock``: its modules numbered ``j``."""
    _temporal_conv_net(out, scope + (f"TemporalConvNet_{j}",), m.tconv)
    _linear(out, scope + (f"Dense_{j}",), m.skip)
    _diff_conv(out, scope + (f"DiffConv_{j}",), m.diff)
    if m.dense is not None:
        _dense_spatial(out, scope + (f"DenseSpatialConvOrderK_{j}",),
                       m.dense)
    _norm(out, scope + (f"Norm_{j}",), m.norm)


def _gwnet_model(out: dict, scope: Path, m: GraphWaveNetModel):
    """The embeddings, ``Dense_0``, the layers in their blocks (a scanned
    tree holds each block's value of a path along its first axis: a list
    of targets, block by block) and ``MLPDecoder_0``."""
    if m.emb_src is not None:
        out[scope + ("StaticGraphEmbedding_0", "emb")] = (m.emb_src.emb, False)
        out[scope + ("StaticGraphEmbedding_1", "emb")] = (m.emb_dst.emb, False)
    _linear(out, scope + ("Dense_0",), m.encoder)
    stacked, blocks = m.flax_blocks()
    for b, layers in enumerate(blocks):
        block: dict = {}
        name = "ScanCheckpoint_GWNetBlock_0" if stacked \
            else f"_GWNetBlock_{b}"
        for j, i in enumerate(layers):
            _gwnet_layer(block, scope + (name,), j, m.layers[i])
        for path, target in block.items():
            if stacked:
                out.setdefault(path, []).append(target)
            else:
                out[path] = target
    _mlp_decoder(out, scope + ("MLPDecoder_0",), m.decoder)


def _rnn_stack(out: dict, scope: Path, m: RNNStack):
    """Layer ``l``'s ``GRUCell_l`` / ``OptimizedLSTMCell_l``: each gate's
    Dense into its rows of ``weight_ih_l`` / ``weight_hh_l`` and the
    biases."""
    h = m.hidden_size
    gru = m.cell == "gru"
    cell, gates = ("GRUCell", "rzn") if gru else ("OptimizedLSTMCell", "ifgo")
    for layer in range(m.rnn.num_layers):
        params = {side: [getattr(m.rnn, f"{kind}_{side}_l{layer}").detach()
                         for kind in ("weight", "bias")]
                  for side in ("ih", "hh")}
        for g, gate in enumerate(gates):
            rows = slice(g * h, (g + 1) * h)
            for side in ("ih", "hh"):
                name = f"{side[0]}{gate}"
                path = scope + (f"{cell}_{layer}", name)
                w, b = params[side]
                out[path + ("kernel",)] = (w[rows], True)
                # GRUCell: biases on ir, iz, in and hn; the LSTM cell: on
                # the hidden side only
                if (gru and name in ("ir", "iz", "in", "hn")) or \
                        (not gru and side == "hh"):
                    out[path + ("bias",)] = (b[rows], False)


def _rnn_model(out: dict, scope: Path, m):
    _rnn_stack(out, scope + ("_RNNStack_0",), m.rnn)
    _mlp_decoder(out, scope + ("MLPDecoder_0",), m.decoder)


def _tcn_model(out: dict, scope: Path, m: TCNModel):
    _linear(out, scope + ("Dense_0",), m.encoder)
    _temporal_conv_net(out, scope + ("TemporalConvNet_0",), m.tcn)
    _mlp_decoder(out, scope + ("MLPDecoder_0",), m.decoder)


def _spatial_decoder(out: dict, scope: Path, m: SpatialDecoder):
    _linear(out, scope + ("Dense_0",), m.lin_in)
    _diff_conv(out, scope + ("DiffConv_0",), m.conv)
    out[scope + ("prelu_slope",)] = (m.prelu_slope, False)
    _linear(out, scope + ("Dense_1",), m.lin_out)
    _linear(out, scope + ("Dense_2",), m.readout)


def _gril(out: dict, scope: Path, m: GRIL):
    """``DCRNNCell_i`` (``DiffConv_0..2``: r, u, c), ``LayerNorm_i``,
    ``Dense_0`` (the first stage), ``SpatialDecoder_0`` and
    ``StaticGraphEmbedding_i``."""
    for i, (cell, norm) in enumerate(zip(m.cells, m.norms)):
        for k, conv in enumerate((cell.r, cell.u, cell.c)):
            _diff_conv(out, scope + (f"DCRNNCell_{i}", f"DiffConv_{k}"),
                       conv)
        if isinstance(norm, nn.LayerNorm):
            _layer_norm(out, scope + (f"LayerNorm_{i}",), norm)
    _linear(out, scope + ("Dense_0",), m.first_stage)
    _spatial_decoder(out, scope + ("SpatialDecoder_0",), m.decoder)
    for i, emb in enumerate(m.h0 or ()):
        out[scope + (f"StaticGraphEmbedding_{i}", "emb")] = (emb.emb, False)


def _grin_model(out: dict, scope: Path, m: GRINModel):
    _gril(out, scope + ("GRIL_0",), m.fwd)
    _gril(out, scope + ("GRIL_1",), m.bwd)
    if m.merge is not None:
        _trunk(out, scope + ("MLP_0",), m.merge)


def _flax_cell(out: dict, scope: Path, m: FlaxRNNCell):
    """Each gate's Dense of flax's ``GRUCell`` (``ir``, ``iz``, ``in``,
    ``hr``, ``hz``, ``hn``) or ``OptimizedLSTMCell`` (``ii`` .. ``ho``)
    into its rows of the stacked weights and biases."""
    h = m.hidden_size
    gru = m.cell == "gru"
    for g, gate in enumerate("rzn" if gru else "ifgo"):
        rows = slice(g * h, (g + 1) * h)
        out[scope + (f"i{gate}", "kernel")] = (m.weight_ih.detach()[rows],
                                               True)
        out[scope + (f"h{gate}", "kernel")] = (m.weight_hh.detach()[rows],
                                               True)
        if gru:
            out[scope + (f"i{gate}", "bias")] = (m.bias_ih.detach()[rows],
                                                 False)
        else:
            out[scope + (f"h{gate}", "bias")] = (m.bias_hh.detach()[rows],
                                                 False)
    if gru:
        out[scope + ("hn", "bias")] = (m.bias_hn, False)


def _rnn_imputer(out: dict, scope: Path, m: RNNImputerModel):
    _flax_cell(out, scope + ("rnn_cell",), m.rnn_cell)
    _linear(out, scope + ("readout",), m.readout)


def _birnn_imputer(out: dict, scope: Path, m: BiRNNImputerModel):
    _rnn_imputer(out, scope + ("fwd_rnn",), m.fwd_rnn)
    _rnn_imputer(out, scope + ("bwd_rnn",), m.bwd_rnn)
    _linear(out, scope + ("Dense_0",), m.readout)


def _graph_conv_cell(out: dict, scope: Path, m):
    gates = (m.r, m.u, m.c) if isinstance(m, GraphConvGRUCell) \
        else (m.i, m.f, m.g, m.o)
    for k, conv in enumerate(gates):
        _graph_conv(out, scope + (f"GraphConv_{k}",), conv)


def _graph_conv_rnn(out: dict, scope: Path, m: GraphConvRNN):
    name = "GraphConvGRUCell" if m.cell == "gru" else "GraphConvLSTMCell"
    for i, cell in enumerate(m.cells):
        _graph_conv_cell(out, scope + (f"{name}_{i}",), cell)


def _dense_dcrnn_cell(out: dict, scope: Path, m: DenseDCRNNCell):
    for name in ("forget", "update", "cand"):
        _dense_spatial(out, scope + (name,), getattr(m, name))


def _conditional_tcn(out: dict, scope: Path, m: ConditionalTCNBlock):
    """``TemporalConv_0`` (x), ``TemporalConv_1`` (u), ``Dense_0``,
    ``Dense_1`` (no bias), ``Dense_2`` the skip."""
    _temporal_conv(out, scope + ("TemporalConv_0",), m.conv_x)
    _temporal_conv(out, scope + ("TemporalConv_1",), m.conv_u)
    _linear(out, scope + ("Dense_0",), m.x_lin)
    out[scope + ("Dense_1", "kernel")] = (m.u_lin.weight, True)
    if m.skip is not None:
        _linear(out, scope + ("Dense_2",), m.skip)


def _input_encoder(out: dict, scope: Path, m: InputEncoder):
    if m.conditional:
        _conditional_block(out, scope + ("ConditionalBlock_0",), m.encoder)
    else:
        _trunk(out, scope + ("MLP_0",), m.encoder)


def _stcn_block(out: dict, scope: Path, m: STCNBlock):
    _temporal_conv_net(out, scope + ("TemporalConvNet_0",), m.tcn)
    _graph_conv(out, scope + ("GraphConv_0",), m.conv)
    if m.skip is not None:
        _linear(out, scope + ("Dense_0",), m.skip)
    _layer_norm(out, scope + ("LayerNorm_0",), m.norm)


def _multi_horizon(out: dict, scope: Path, m: MultiHorizonMLPDecoder):
    out[scope + ("step_emb",)] = (m.step_emb, False)
    _trunk(out, scope + ("MLP_0",), m.mlp)


def _gcn_decoder(out: dict, scope: Path, m: GCNDecoder):
    for i, conv in enumerate(m.convs):
        _graph_conv(out, scope + (f"GraphConv_{i}",), conv)
    _mlp_decoder(out, scope + ("MLPDecoder_0",), m.readout)


def _att_pool(out: dict, scope: Path, m: AttPool):
    _linear(out, scope + ("Dense_0",), m.score)


def _stcn_model(out: dict, scope: Path, m: STCNModel):
    for i, block in enumerate(m.blocks):
        _stcn_block(out, scope + (f"STCNBlock_{i}",), block)
    _mlp_decoder(out, scope + ("MLPDecoder_0",), m.decoder)


def _rnn2gcn_model(out: dict, scope: Path, m: RNNEncGCNDecModel):
    _rnn_stack(out, scope + ("_RNNStack_0",), m.rnn)
    _gcn_decoder(out, scope + ("GCNDecoder_0",), m.decoder)


def _link_predictor(out: dict, scope: Path, m: LinkPredictor):
    for k, lin in enumerate((*m.src, *m.dst)):
        _linear(out, scope + (f"Dense_{k}",), lin)


def _nri_dcrnn(out: dict, scope: Path, m: NRIDCRNN):
    out[scope + ("StaticGraphEmbedding_0", "emb")] = (m.emb.emb, False)
    _link_predictor(out, scope + ("LinkPredictor_0",), m.link)
    for i, cell in enumerate(m.cells):
        _dense_dcrnn_cell(out, scope + (f"DenseDCRNNCell_{i}",), cell)


# model class -> the function that lists its flax paths
_TREES = {
    SGPOnlineModel: _sgp_online,
    ESNModel: _esn,
    DCRNNModel: _dcrnn_model,
    GraphWaveNetModel: _gwnet_model,
    RNNModel: _rnn_model,
    FCRNNModel: _rnn_model,
    TCNModel: _tcn_model,
    GRINModel: _grin_model,
    GRIL: _gril,
    SpatialDecoder: _spatial_decoder,
    RNNImputerModel: _rnn_imputer,
    BiRNNImputerModel: _birnn_imputer,
    MLPDecoder: _mlp_decoder,
    DiffConv: _diff_conv,
    ConditionalBlock: _conditional_block,
    GraphConv: _graph_conv,
    TemporalConv: _temporal_conv,
    TemporalConvNet: _temporal_conv_net,
    Norm: _norm,
    DenseSpatialConvOrderK: _dense_spatial,
    TransformerModel: _transformer_model,
    TransformerLayer: _transformer_layer,
    SpatioTemporalTransformerLayer: _st_transformer_layer,
    MultiHeadAttention: _mha,
    AttentionEncoder: _attention_encoder,
    CausalLinearAttention: _linear_attention,
    GATConv: _gat_conv,
    SpatioTemporalAttention: _st_attention,
    GraphConvGRUCell: _graph_conv_cell,
    GraphConvLSTMCell: _graph_conv_cell,
    GraphConvRNN: _graph_conv_rnn,
    DenseDCRNNCell: _dense_dcrnn_cell,
    ConditionalTCNBlock: _conditional_tcn,
    InputEncoder: _input_encoder,
    STCNBlock: _stcn_block,
    MultiHorizonMLPDecoder: _multi_horizon,
    GCNDecoder: _gcn_decoder,
    AttPool: _att_pool,
    STCNModel: _stcn_model,
    RNNEncGCNDecModel: _rnn2gcn_model,
    LinkPredictor: _link_predictor,
    NRIDCRNN: _nri_dcrnn,
}


def targets(model: nn.Module) -> Dict[Path, Tuple[torch.Tensor, object]]:
    """flax path -> (torch parameter, layout: see :func:`to_torch_layout`)
    for every parameter of ``model``."""
    if isinstance(model, GatedGraphNetworkMLPModel):
        return _gated_gn_targets(model)
    if isinstance(model, GatedGraphNetworkConvModel):
        return _gated_gn_conv_targets(model)
    if isinstance(model, SGPModel):
        return _targets(model)
    if type(model) in _TREES:
        out: Dict[Path, Tuple[torch.Tensor, object]] = {}
        _TREES[type(model)](out, (), model)
        return out
    raise TypeError(f"no flax mapping for {type(model).__name__}")


def _flatten(tree: dict, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            flat.update(_flatten(value, prefix + (key,)))
        else:
            flat[prefix + (key,)] = np.asarray(value)
    return flat


def flax_to_torch(params_np: dict, model: nn.Module) -> nn.Module:
    """Copy the flax tree ``params_np`` into ``model`` (any model of
    :func:`targets`) in place; returns the model."""
    _load(params_np, targets(model))
    return model


def flax_trials_to_torch(stacked_np: dict, model: nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """Carry a flax tree of K stacked trials (every leaf ``[K, ...]``, as
    ``vmap(model.init)`` gives them) across: each trial's slice goes into a
    copy of ``model`` through :func:`flax_to_torch`, and the copies'
    parameters are stacked as ``torch.func.stack_module_state`` stacks
    them (name -> ``[K, ...]``)."""
    k = len(next(iter(_flatten(stacked_np).values())))
    trials = []
    for i in range(k):
        one = _map_tree(stacked_np, lambda a: np.asarray(a)[i])
        trials.append(flax_to_torch(one, copy.deepcopy(model)))
    params, _ = torch.func.stack_module_state(trials)
    return {name: v.detach() for name, v in params.items()}


def _map_tree(tree: dict, fn) -> dict:
    return {key: _map_tree(v, fn) if isinstance(v, dict) else fn(v)
            for key, v in tree.items()}


def _load(params_np: dict, wanted: Dict[Path, Tuple[torch.Tensor, object]]):
    """Copy ``params_np`` into the ``wanted`` parameters, raising on any
    key missing or left over and on any shape that does not fit."""
    if set(params_np) == {"params"}:
        params_np = params_np["params"]
    flat = _flatten(params_np)
    missing = sorted("/".join(p) for p in wanted.keys() - flat.keys())
    extra = sorted("/".join(p) for p in flat.keys() - wanted.keys())
    if missing or extra:
        raise KeyError(f"flax tree does not match the model: missing "
                       f"{missing}, left over {extra}")
    with torch.no_grad():
        for path, target in wanted.items():
            # a list: the tree stacks one value a target along its first axis
            pairs = zip(target, flat[path]) if isinstance(target, list) \
                else [(target, flat[path])]
            for (param, how), array in pairs:
                value = torch.from_numpy(np.array(
                    to_torch_layout(array, how), np.float32))
                if value.shape != param.shape:
                    raise ValueError(f"{'/'.join(path)}: flax shape "
                                     f"{tuple(array.shape)} does not fit "
                                     f"{tuple(param.shape)}")
                param.copy_(value)
