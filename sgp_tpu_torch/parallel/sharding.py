"""Data-parallel fused training and evaluation: node-sharded and batched.

Counterpart of ``make_sharded_iid_step``, ``make_sharded_iid_stratified_step``,
``make_sharded_window_step`` and ``make_sharded_iid_eval`` of
``sgp_tpu/parallel/sharding.py``. The IID and stratified steps and the eval
hold the large arrays (the encoding or its packed rows, the temporal
embedding, the targets, the masks, node-level exogenous inputs) as node
slabs, one per rank of a mesh axis (``shard_nodes`` cuts them):
multi-device scales memory, not only operations. The window step keeps the
traffic-sized series whole on every rank and splits each batch.

A training step: each rank draws its share of the batch with its own
generator, gathers and runs the forward; the masked loss's sum and count
are summed over the ranks, the gradients are summed with one
``all_reduce`` (a parameter the local samples do not reach gets zeros
first), then come the clip by global norm and Adam, the same on every
rank, so the parameters stay bit-identical across ranks. The parameters
are broadcast from rank 0 when the step is built. The stratified step's
ranks share the batch's time steps and all-gather only those steps' rows
of the embedding before propagating them through the supports (K1 for a
``BSROperator``). The eval: each rank evaluates every window on its node
slab and keeps its metric states; they are summed once at the end. With
``support_ops`` it all-gathers each batch's windows over the nodes and
contracts its own rows of each support against them.

Padding rows (past the true N) carry ``mask=False``: ``shard_nodes``
pads with zeros, and the node ids the model, the scaler and the supports
see are clamped to N - 1 there (JAX clamps ``op.mat[ids]`` the same way;
its ``take`` fills NaN). The JAX package derives each shard's draws with
``fold_in(rng, shard_id)``, which torch cannot repeat:
:func:`rank_generator` seeds rank 0 with the seed itself, so at one rank
every step draws what its single-device counterpart draws.

The placements of ``sgp_tpu/parallel/sharding.py``, where JAX lays arrays
out on the mesh and XLA inserts the collectives, are explicit here:
:func:`shard_operator` keeps a rank's row block of a dense operator and
:func:`sharded_spmm` computes its rows of a hop (:func:`allgather_khop`
all-gathers the activation between hops, the route the halo exchange
replaces); :func:`shard_batch` slices a batch along its samples,
:func:`replicate` broadcasts rank 0's tensors, :func:`sharded_ridge` sums
the Gram and the moments over ``"data"``. :func:`shard_params_tp` swaps
each large ``nn.Linear`` for a :class:`ColumnParallelLinear` holding this
rank's slice of the output features, and :func:`make_dp_tp_step` trains
such a model with data parallelism over ``"data"``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.parallel import collectives
from sgp_tpu_torch.parallel.mesh import Mesh
from sgp_tpu_torch.ops.spmm import DenseOperator
from sgp_tpu_torch.train.fused_window import (make_fused_window_step,
                                              make_offset_gather,
                                              pad_eval_items)
from sgp_tpu_torch.train.iid import (_build_iid_sample_and_loss, _host,
                                     assemble_stratified, stratified_sums,
                                     unpack_iid_rows)
from sgp_tpu_torch.train.metrics import (_METRIC_FNS, MaskedMetrics,
                                         _masked_reduce)
from sgp_tpu_torch.train.predictor import (apply_gradients,
                                           clip_by_global_norm_)
from sgp_tpu_torch.train.ridge import solve_ridge_normal

# rank r > 0 seeds its generator with seed + r * this (odd, < 2^62)
_RANK_STRIDE = 0x2545F4914F6CDD1D


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """Rank ``rank``'s sampling generator: rank 0 seeded with ``seed``
    (the single-device trainer's stream), the others with seeds apart."""
    return torch.Generator(device=device).manual_seed(
        (seed + rank * _RANK_STRIDE) % (1 << 63))


def broadcast_module_(model: torch.nn.Module, group) -> None:
    """Every parameter and buffer of rank 0 on every rank of ``group``."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            collectives.broadcast_(t.data, group)


def _flat_grads_(params, group, collective) -> None:
    """``collective(flat, group)`` on every gradient in one flat tensor; a
    parameter without a gradient takes zeros first, so every rank's
    optimizer updates the same parameters."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if group is None:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    collective(flat, group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def all_reduce_grads_(params, group) -> None:
    """Sum the gradients over ``group`` in one flat ``all_reduce``."""
    _flat_grads_(params, group, collectives.all_reduce_)


def broadcast_grads_(params, group) -> None:
    """Rank 0's gradients on every rank of ``group``: after a batch that
    every rank computed whole, whose gradients the card's atomic sums may
    round apart."""
    _flat_grads_(params, group, collectives.broadcast_)


def _node_ids(mesh: Mesh, axis: str, n_local: int, n_nodes: int, device):
    """Global ids of this rank's slab rows and which are real nodes."""
    ids = mesh.index[axis] * n_local + torch.arange(n_local, device=device)
    return ids.clamp_max(n_nodes - 1), ids < n_nodes


def _gather_nodes(x: torch.Tensor, dim: int, n_nodes: int, group):
    """Every rank's node slab of ``x`` along ``dim`` in rank order, cut to
    the true N, contiguous; at one rank ``x`` itself."""
    if group is None:
        return x
    whole = collectives.all_gather(x.movedim(dim, 0), group)
    return whole[:n_nodes].movedim(0, dim).contiguous()


def _summed_loss(v, cnt, group):
    """``(v / count, the loss over every rank)`` with the count summed over
    ``group``: the first's gradient, summed over the ranks, is the whole
    batch's."""
    total = collectives.all_reduce_(
        torch.stack([v.detach(), cnt.detach().float()]), group)
    count = torch.clamp(total[1], min=1.0)
    return v / count, total[0] / count


def make_sharded_iid_step(model, optimizer, encoded, target, mask,
                          valid_starts, horizon_offsets,
                          scaler: ScalerParams, mesh: Mesh, u=None,
                          batch_size: int = 4096, loss: str = "mae",
                          scale_target: bool = False, axis: str = "data",
                          steps_per_call: int = 1, packed=False,
                          grad_clip: Optional[float] = None,
                          n_nodes: int = None) -> Callable:
    """Build ``step(generator) -> mean loss`` (a device tensor) over
    ``steps_per_call`` steps on this rank's slabs ``encoded [T, Nl, D]``,
    ``target``/``mask [T, Nl, C]`` (``u`` node-level ``[T, Nl, F]`` or
    global ``[T, F]``); ``packed`` True packs the slabs
    (``train/iid.py::pack_iid_data``), a tensor is this rank's slab of the
    prebuilt packed rows (``encoded``, ``target`` and ``mask`` may then be
    None). ``n_nodes`` is the true N over all ranks (default: the slabs'
    rows times the axis size). Every rank of the axis calls each step with
    its own generator (:func:`rank_generator`).

    Hooks for the tests: ``step.train_on(t, n_loc)`` takes one step on
    given local draws; ``step.sample_and_loss.sample(generator)`` draws
    ``(t, n_loc)`` and ``.loss(t, n_loc)`` gives ``(this rank's part, the
    loss over every rank's draws)``, each rank passing its own draws."""
    s = mesh.size(axis)
    if batch_size % s:
        raise ValueError(f"batch_size {batch_size} is not a multiple of "
                         f"the {s} ranks of axis {axis!r}")
    group = mesh.group(axis)
    slab = packed if isinstance(packed, torch.Tensor) else encoded
    n_local = slab.shape[1]
    n_nodes = n_local * s if n_nodes is None else n_nodes
    data, core = _build_iid_sample_and_loss(
        model, encoded, target, mask, valid_starts, horizon_offsets,
        scaler, u=u, batch_size=batch_size // s, loss=loss,
        scale_target=scale_target, packed=packed)
    offset = mesh.index[axis] * n_local
    params = [p for p in model.parameters() if p.requires_grad]
    broadcast_module_(model, group)

    def loss_fn(t, n_loc):
        """``(this rank's part, the loss over every rank)``: the part's
        gradient, summed over the ranks, is the whole batch's."""
        x, y, m, _, u_rows = core.gather(t, n_loc)
        # padding rows have mask False; their ids are clamped for the
        # embedding and the scaler
        n_glob = (offset + n_loc).clamp_max(n_nodes - 1)
        return _summed_loss(*core.sums_on((x, y, m, n_glob, u_rows)), group)

    def train_on(t, n_loc):
        optimizer.zero_grad(set_to_none=True)
        part, loss_val = loss_fn(t, n_loc)
        part.backward()
        all_reduce_grads_(params, group)
        if grad_clip is not None:
            clip_by_global_norm_([p.grad for p in params], grad_clip)
        optimizer.step()
        return loss_val

    def step(generator):
        return torch.stack([train_on(*core.sample(generator))
                            for _ in range(steps_per_call)]).mean()

    core.loss = loss_fn
    step.train_on = train_on
    step.sample_and_loss = core
    step.data = data
    step.n_local = n_local
    step.packed = core.packed
    return step


def make_sharded_iid_stratified_step(model, optimizer, h_temporal, target,
                                     mask, valid_starts, horizon_offsets,
                                     scaler: ScalerParams, support_ops,
                                     mesh: Mesh, global_attr: bool = True,
                                     u=None, times_per_batch: int = 32,
                                     nodes_per_time: int = 128,
                                     loss: str = "mae",
                                     scale_target: bool = False,
                                     steps_per_call: int = 1,
                                     axis: str = "data",
                                     grad_clip: Optional[float] = None,
                                     seed: int = 0,
                                     n_nodes: int = None) -> Callable:
    """Build ``step(generator) -> mean loss`` (a device tensor) over
    ``steps_per_call`` stratified steps (``train/iid.py::
    make_fused_iid_stratified_step``) on this rank's node slabs of the
    temporal embedding ``h_temporal [T, Nl, Ht]`` and of ``target``/``mask
    [T, Nl, C]`` (``u`` node-level ``[T, Nl, F]`` or global ``[T, F]``);
    ``n_nodes`` is the true N (default: the slabs' rows times the axis
    size). The supports stay whole on every rank.

    A step draws ``times_per_batch`` starts shared by every rank and
    ``nodes_per_time / S`` local nodes a start on each rank, all-gathers
    only the selected steps' rows of the embedding (``[Tb, N, Ht]``) and
    assembles ``[h, A_1 h, ..., mean(h)]`` at its own nodes: a dense
    support's rows at those nodes, any other operator ``op @ h_sel`` over
    every node (K1 at F ``Tb * Ht`` for a ``BSROperator``). Every rank
    calls ``step`` with a generator seeded alike (the shared stream): the
    starts and rank 0's nodes come from it, in the single-device step's
    order, so at one rank the step draws what that step draws; a rank r >
    0 also steps it for rank 0's nodes and draws its own from
    ``rank_generator(seed, r)``.

    Hooks for the tests: ``step.train_on(t, n_loc)`` takes one step on
    given draws (``n_loc [Tb, P/S]`` local rows), ``step.sample(generator)``
    draws them."""
    s = mesh.size(axis)
    if nodes_per_time % s:
        raise ValueError(f"nodes_per_time {nodes_per_time} is not a "
                         f"multiple of the {s} ranks of axis {axis!r}")
    group = mesh.group(axis)
    rank = mesh.index[axis]
    device = h_temporal.device
    n_local = h_temporal.shape[1]
    n_nodes = n_local * s if n_nodes is None else n_nodes
    p_local = nodes_per_time // s
    batch_local = times_per_batch * p_local
    loss_pt = _METRIC_FNS[loss]
    ops = list(support_ops)
    valid = torch.as_tensor(valid_starts, device=device)
    h_off = torch.as_tensor(_host(horizon_offsets), device=device)
    offset = rank * n_local
    own = rank_generator(seed, rank, device) if rank else None
    params = [p for p in model.parameters() if p.requires_grad]
    broadcast_module_(model, group)

    def global_ids(n_loc):
        # padding rows have mask False; their ids are clamped for the
        # supports, the embedding and the scaler
        return (offset + n_loc).clamp_max(n_nodes - 1)

    @torch.no_grad()
    def features(t, n_loc):
        h_sel = _gather_nodes(h_temporal[t], 1, n_nodes, group)
        return assemble_stratified(h_sel, global_ids(n_loc), ops,
                                   global_attr).reshape(batch_local, -1)

    def loss_fn(t, n_loc):
        """``(this rank's part, the loss over every rank)``."""
        n_flat = n_loc.reshape(-1)
        v, cnt = stratified_sums(
            model, features(t, n_loc), target, mask, u,
            t.repeat_interleave(p_local), n_flat, global_ids(n_flat), h_off,
            scaler, loss_pt, scale_target)
        return _summed_loss(v, cnt, group)

    def train_on(t, n_loc):
        optimizer.zero_grad(set_to_none=True)
        part, loss_val = loss_fn(t, n_loc)
        part.backward()
        all_reduce_grads_(params, group)
        if grad_clip is not None:
            clip_by_global_norm_([p.grad for p in params], grad_clip)
        optimizer.step()
        return loss_val

    def sample(generator: torch.Generator):
        t = valid[torch.randint(len(valid), (times_per_batch,),
                                generator=generator, device=device)]
        n_loc = torch.randint(n_local, (times_per_batch, p_local),
                              generator=generator, device=device)
        if own is not None:
            n_loc = torch.randint(n_local, (times_per_batch, p_local),
                                  generator=own, device=device)
        return t, n_loc

    def step(generator: torch.Generator):
        return torch.stack([train_on(*sample(generator))
                            for _ in range(max(steps_per_call, 1))]).mean()

    step.train_on = train_on
    step.sample = sample
    step.n_local = n_local
    # this rank's own node stream (ranks past 0), for checkpoints
    step.generators = () if own is None else (own,)
    return step


def make_sharded_window_step(model, optimizer, x_full, target, mask,
                             item_starts, window_offsets, horizon_offsets,
                             scaler: ScalerParams, mesh: Mesh, u=None,
                             support_ops=None, batch_size: int = 64,
                             loss: str = "mae", scale_target: bool = False,
                             steps_per_call: int = 1, axis: str = "data",
                             grad_clip: float = 5.0,
                             scheduler=None) -> Callable:
    """Build ``step(generator) -> mean loss`` (a device tensor) over
    ``steps_per_call`` windowed steps: the multi-device
    ``train/fused_window.py::make_fused_window_step``, whose arguments it
    takes, on the whole series held by every rank. Each rank draws
    ``batch_size / S`` window starts from its own generator
    (:func:`rank_generator`), appends ``op @ x`` for each support (K1 for a
    ``BSROperator``) and takes the masked loss; the loss's sum and count
    and the gradients are summed over the axis before the update (zero
    gradients for unreached parameters, the clip at ``grad_clip``, the
    optimizer, ``scheduler``). ``step.train_on(items)`` takes one step on
    this rank's given starts."""
    s = mesh.size(axis)
    if batch_size % s:
        raise ValueError(f"batch_size {batch_size} is not a multiple of "
                         f"the {s} ranks of axis {axis!r}")
    group = mesh.group(axis)
    local = make_fused_window_step(
        model, optimizer, x_full, target, mask, item_starts, window_offsets,
        horizon_offsets, scaler, u=u, support_ops=support_ops,
        batch_size=batch_size // s, loss=loss, scale_target=scale_target,
        grad_clip=grad_clip, scheduler=scheduler)
    params = [p for p in model.parameters() if p.requires_grad]
    broadcast_module_(model, group)

    def train_on(items):
        optimizer.zero_grad(set_to_none=True)
        part, loss_val = _summed_loss(*local.sums_on(
            torch.as_tensor(items, device=x_full.device)), group)
        part.backward()
        all_reduce_grads_(params, group)
        apply_gradients(model, optimizer, grad_clip, scheduler)
        return loss_val

    def step(generator: torch.Generator):
        return torch.stack([train_on(local.sample(generator))
                            for _ in range(steps_per_call)]).mean()

    step.train_on = train_on
    step.sample = local.sample
    return step


def _propagate_rows(ops, x: torch.Tensor, node_ids, n_nodes: int,
                    group) -> list:
    """Each support's hop of the node-sharded windows ``x [B, W, Nl, F]``
    at this rank's rows ``node_ids``, in x's dtype, as
    ``make_fused_eval`` propagates the whole windows."""
    x_all = _gather_nodes(x, 2, n_nodes, group)           # [B, W, N, F]
    hops = []
    for op in ops:
        if isinstance(op, DenseOperator):
            xm = x_all.to(torch.bfloat16) if op.precision == "default" \
                else x_all
            block = op.mat[node_ids]                       # [Nl, N]
            hops.append(torch.matmul(block, xm.to(block.dtype)).to(x.dtype))
        else:
            hops.append((op @ x_all).index_select(2, node_ids))
    return hops


def make_sharded_iid_eval(model, encoded, target, mask, item_starts,
                          window_offsets, horizon_offsets,
                          scaler: ScalerParams, metrics: MaskedMetrics,
                          mesh: Mesh, u=None, axis: str = "data",
                          batch_size: int = 32, x_slice: int = None,
                          unpack_targets: bool = False, support_ops=None,
                          n_nodes: int = None) -> Callable:
    """Build ``eval_fn() -> {metric: float}``: the fused evaluation of
    ``train/fused_window.py::make_fused_eval`` on this rank's slabs
    (``encoded [T, Nl, D]``, ``target``/``mask [T, Nl, C]``, ``u``), with
    the model's current weights; the metric states are summed over the
    axis once at the end, so every rank returns the same metrics.

    ``x_slice`` reads the first lanes of a packed row slab; with
    ``unpack_targets`` (a one-step window) the horizon targets and masks
    come from the packed lanes too and ``target``/``mask`` may be None.
    ``n_nodes`` is the true N (default: the slab's rows times the axis
    size); rows past it count nowhere.

    ``support_ops`` propagates the windows on the fly (the stratified
    layout): each batch all-gathers its windows ``[B, W, N, F]`` over the
    ranks, a ``DenseOperator`` contracts this rank's rows of the support
    against them, any other operator runs ``op @ x`` over every node (K1
    at F ``B * W * F`` for a ``BSROperator``) and keeps this rank's
    rows."""
    s = mesh.size(axis)
    group = mesh.group(axis)
    device = encoded.device
    n_local = encoded.shape[1]
    n_nodes = n_local * s if n_nodes is None else n_nodes
    n_h = int(np.asarray(horizon_offsets).shape[0])
    if unpack_targets:
        if x_slice is None or len(np.asarray(window_offsets)) != 1:
            raise ValueError("unpack_targets needs x_slice and a one-step "
                             "window")
        lanes = encoded.shape[-1] - x_slice
        if lanes <= 0 or lanes % (3 * n_h):
            raise ValueError(
                f"packed lane width {lanes} does not match 3*H*C for H="
                f"{n_h}: x_slice/horizon_offsets disagree with the "
                "pack_iid_data layout")
        n_c = lanes // (3 * n_h)
    elif target is None or mask is None:
        raise ValueError("target/mask required unless unpack_targets=True")
    node_ids, real = _node_ids(mesh, axis, n_local, n_nodes, device)
    sc = scaler.index_nodes(node_ids)
    ops = None if support_ops is None else list(support_ops)
    starts, valid = pad_eval_items(item_starts, batch_size, device)
    gw = make_offset_gather(window_offsets)
    gh = make_offset_gather(horizon_offsets)

    @torch.no_grad()
    def eval_fn():
        model.eval()
        state = metrics.init()
        for items, ok in zip(starts, valid):
            x = gw(encoded, items)                    # [B, W, Nl, F]
            if unpack_targets:
                b = x.shape[0]
                _, y, m = unpack_iid_rows(
                    x[:, -1].reshape(b * n_local, -1), x_slice, n_h, n_c)
                # contiguous, so that the metric sums run in the order of
                # the unsharded evaluation's
                y = y.reshape(b, n_local, n_h, n_c).transpose(1, 2) \
                    .contiguous()
                m = m.reshape(b, n_local, n_h, n_c).transpose(1, 2) \
                    .contiguous()
            else:
                y = gh(target, items)
                m = gh(mask, items)
            m = m & ok[:, None, None, None] & real[None, None, :, None]
            if x_slice is not None:
                x = x[..., :x_slice]
            if ops is not None:
                x = torch.cat([x] + _propagate_rows(ops, x, node_ids,
                                                    n_nodes, group), -1)
            kwargs = {} if u is None else {"u": gw(u, items)}
            y_hat = sc.inverse_transform(model(
                x.float(), node_index=node_ids, training=False, **kwargs))
            state = metrics.update(state, y_hat, y, m)
        names = list(state)
        flat = torch.stack([torch.stack([state[k][0].to(device).float(),
                                         state[k][1].to(device).float()])
                            for k in names])
        flat = collectives.all_reduce_(flat, group).cpu()
        return metrics.compute({k: (flat[i, 0], flat[i, 1])
                                for i, k in enumerate(names)})

    eval_fn.metrics = metrics
    return eval_fn


# -- placements (sgp_tpu/parallel/sharding.py:29-83, :676-696) --------------

def shard_operator(op: DenseOperator, mesh: Mesh,
                   axis: str = "model") -> DenseOperator:
    """This rank's row block (its destination nodes) of the dense operator:
    rows ``[i * Nl, (i + 1) * Nl)`` of ``op.mat`` padded with zero rows to
    ``S * Nl``, as a ``DenseOperator`` of the same precision (``[Nl,
    N]``)."""
    s, i = mesh.size(axis), mesh.index[axis]
    n = op.mat.shape[0]
    nl = -(-n // s)
    block = op.mat[min(i * nl, n):min((i + 1) * nl, n)]
    if block.shape[0] < nl:
        block = torch.cat([block, block.new_zeros(
            (nl - block.shape[0],) + block.shape[1:])])
    out = DenseOperator.__new__(DenseOperator)
    out.mat, out.precision = block.contiguous(), op.precision
    return out


def sharded_spmm(op_s: DenseOperator, x: torch.Tensor, mesh: Mesh,
                 axis: str = "model") -> torch.Tensor:
    """One hop: this rank's rows ``[..., Nl, F]`` of ``op @ x`` from its
    row block (:func:`shard_operator`) and the whole ``x [..., N, F]``."""
    return op_s @ x


def allgather_khop(op_s: DenseOperator, x: torch.Tensor, mesh: Mesh,
                   k: int = 1, axis: str = "model") -> torch.Tensor:
    """k >= 1 hops of :func:`sharded_spmm` with an ``all_gather`` of the
    whole activation between them (what XLA inserts between the JAX package's
    ``sharded_spmm`` hops): this rank's rows of ``A^k x``. ``x [..., N,
    F]`` is whole on every rank."""
    n = x.shape[-2]
    cur = x
    for _ in range(k - 1):
        rows = sharded_spmm(op_s, cur, mesh, axis)
        cur = collectives.all_gather(rows.movedim(-2, 0), mesh.group(axis)
                                     )[:n].movedim(0, -2)
    return sharded_spmm(op_s, cur, mesh, axis)


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This rank's slice of every batch tensor along its leading (sample)
    dimension, which the axis size must divide; ``ScalerParams`` stay
    whole."""
    s, i = mesh.size(axis), mesh.index[axis]

    def cut(v):
        if isinstance(v, ScalerParams):
            return v
        v = torch.as_tensor(v)
        if v.shape[0] % s:
            raise ValueError(f"batch dimension {v.shape[0]} is not a "
                             f"multiple of the {s} ranks of axis {axis!r}")
        part = v.shape[0] // s
        return v[i * part:(i + 1) * part]
    return {k: cut(v) for k, v in batch.items()}


def replicate(tree: Any, mesh: Mesh) -> Any:
    """``tree`` (tensors in dicts, lists and tuples) as rank 0 holds it, on
    every rank of the mesh: each tensor copied and broadcast."""
    group = mesh.world_group()
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return collectives.broadcast_(torch.as_tensor(tree).clone(), group)


def sharded_ridge(x_shard, y_shard, alpha: float, mesh: Mesh,
                  axis: str = "data") -> torch.Tensor:
    """Ridge without intercept on the rows of every rank of ``axis``: this
    rank's Gram ``x^T x`` and moment ``x^T y`` (of ``x_shard [n, D]``,
    ``y_shard [n, C]``) summed over the axis in one ``all_reduce``, then
    ``solve_ridge_normal`` on every rank; returns ``W [D, C]``."""
    x = torch.as_tensor(x_shard, dtype=torch.float32)
    y = torch.as_tensor(y_shard, dtype=torch.float32, device=x.device)
    d, c = x.shape[-1], y.shape[-1]
    flat = collectives.all_reduce_(
        torch.cat([(x.T @ x).reshape(-1), (x.T @ y).reshape(-1)]),
        mesh.group(axis))
    return solve_ridge_normal(flat[:d * d].reshape(d, d),
                              flat[d * d:].reshape(d, c), alpha)


# -- tensor parallelism ------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the input's gradient over the model
    axis (each rank's slice of the output reaches the input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return collectives.all_reduce_(grad.contiguous().clone(),
                                       ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    """Every rank's slice concatenated along the last dim in rank order;
    the backward keeps this rank's slice of the upstream gradient (every
    model rank computes the same loss on the same batch, so a sum would
    scale it by the axis size)."""

    @staticmethod
    def forward(ctx, y, group, rank: int):
        ctx.rank, ctx.part = rank, y.shape[-1]
        whole = collectives.all_gather(y.movedim(-1, 0), group)
        return whole.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.part
        return grad[..., lo:lo + ctx.part].contiguous(), None, None


class ColumnParallelLinear(nn.Module):
    """An ``nn.Linear`` whose output features are split over a mesh axis:
    this rank holds rows ``[r * O/m, (r + 1) * O/m)`` of the weight and
    the bias, computes its slice of the output and all-gathers the whole
    over the axis. The state dict keeps the linear's names."""

    def __init__(self, linear: nn.Linear, mesh: Mesh, axis: str = "model"):
        super().__init__()
        m, r = mesh.size(axis), mesh.index[axis]
        if linear.out_features % m:
            raise ValueError(f"{linear.out_features} output features do not "
                             f"split over {m} ranks")
        part = linear.out_features // m
        self.in_features, self.out_features = (linear.in_features,
                                               linear.out_features)
        self.group, self.rank = mesh.group(axis), r
        self.weight = nn.Parameter(
            linear.weight.detach()[r * part:(r + 1) * part].clone())
        self.bias = None if linear.bias is None else nn.Parameter(
            linear.bias.detach()[r * part:(r + 1) * part].clone())

    def forward(self, x):
        y = F.linear(_CopyToModel.apply(x, self.group), self.weight,
                     self.bias)
        return _GatherFromModel.apply(y, self.group, self.rank)


def shard_params_tp(model: nn.Module, mesh: Mesh, axis: str = "model",
                    min_size: int = 1024) -> nn.Module:
    """Tensor parallelism over ``axis``, in place: every ``nn.Linear`` with
    at least ``min_size`` weights whose output features the axis size
    divides becomes a :class:`ColumnParallelLinear` (the kernels the JAX
    package shards on their output axis; every other parameter stays
    whole). Rank 0's parameters are first broadcast to every rank. Returns
    the model."""
    broadcast_module_(model, mesh.world_group())
    m = mesh.size(axis)
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if (type(child) is nn.Linear
                    and child.weight.numel() >= min_size
                    and child.out_features % m == 0):
                setattr(parent, name, ColumnParallelLinear(child, mesh,
                                                           axis))
    return model


def flax_to_tp(params_np: dict, model: nn.Module, mesh: Mesh,
               axis: str = "model", min_size: int = 1024) -> nn.Module:
    """The flax tree ``params_np`` carried into ``model``
    (``models/bridge.py::flax_to_torch``), then :func:`shard_params_tp`."""
    from sgp_tpu_torch.models.bridge import flax_to_torch
    return shard_params_tp(flax_to_torch(params_np, model), mesh, axis,
                           min_size)


def _tp_split(model: nn.Module):
    """``(sharded, replicated)`` trainable parameters of ``model``."""
    sharded = {id(p) for m in model.modules()
               if isinstance(m, ColumnParallelLinear)
               for p in m.parameters()}
    params = [p for p in model.parameters() if p.requires_grad]
    return ([p for p in params if id(p) in sharded],
            [p for p in params if id(p) not in sharded])


def tp_clip_by_global_norm_(model: nn.Module, mesh: Mesh, max_norm: float,
                            axis: str = "model") -> torch.Tensor:
    """``clip_by_global_norm`` of the whole model's gradients: the squared
    norm of the sharded slices summed over ``axis``, the replicated
    parameters counted once. Returns the norm."""
    sharded, repl = _tp_split(model)
    dev = next(model.parameters()).device
    sq = torch.stack([sum(((p.grad.float() ** 2).sum() for p in part),
                          torch.zeros((), device=dev))
                      for part in (sharded, repl)])
    sq_sharded = collectives.all_reduce_(sq[:1].clone(), mesh.group(axis))
    norm = torch.sqrt(sq_sharded[0] + sq[1])
    keep = norm < max_norm
    with torch.no_grad():
        for p in sharded + repl:
            p.grad.copy_(torch.where(keep, p.grad, p.grad / norm * max_norm))
    return norm


def make_dp_tp_step(model: nn.Module, optimizer, mesh: Mesh,
                    grad_clip: Optional[float] = None, loss: str = "mae",
                    data_axis: str = "data",
                    model_axis: str = "model") -> Callable:
    """Build ``step(batch) -> loss over every rank's samples`` for a model
    under :func:`shard_params_tp`, ``batch`` this rank's
    :func:`shard_batch` slice (``x``, ``y``, ``mask``): the masked loss's
    sum and count summed over ``data_axis``, the gradients summed over it
    in one ``all_reduce``, the clip by the whole model's norm
    (:func:`tp_clip_by_global_norm_`), then the optimizer."""
    group = mesh.group(data_axis)
    params = [p for p in model.parameters() if p.requires_grad]
    fn = _METRIC_FNS[loss]

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        y_hat = model(batch["x"])
        part, loss_val = _summed_loss(
            *_masked_reduce(fn, y_hat, batch["y"], batch.get("mask")),
            group)
        part.backward()
        all_reduce_grads_(params, group)
        if grad_clip is not None:
            tp_clip_by_global_norm_(model, mesh, grad_clip, model_axis)
        optimizer.step()
        return loss_val
    return step


def gather_params_tp(model: nn.Module, mesh: Mesh, axis: str = "model",
                     grads: bool = False) -> dict:
    """The whole model's state dict (the unsharded names and shapes), or
    with ``grads`` its parameters' gradients: each
    :class:`ColumnParallelLinear`'s slices all-gathered over ``axis``."""
    whole = {}
    tensors = ({n: p.grad for n, p in model.named_parameters()} if grads
               else model.state_dict())
    for name, t in tensors.items():
        owner = model.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else model
        if isinstance(owner, ColumnParallelLinear):
            t = collectives.all_gather(t, mesh.group(axis))
        whole[name] = t
    return whole
