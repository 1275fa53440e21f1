"""Node-sharded fused IID training and evaluation.

Counterpart of ``make_sharded_iid_step`` and ``make_sharded_iid_eval`` of
``sgp_tpu/parallel/sharding.py``. The large arrays (the encoding or its
packed rows, the targets, the masks, node-level exogenous inputs) are
held as node slabs, one per rank of a mesh axis (``shard_nodes`` cuts
them): multi-device scales memory, not only operations.

A training step: each rank draws ``batch_size / S`` (time, local node)
pairs from its own slab with its own generator, gathers and runs the
forward; the masked loss's sum and count are summed over the ranks, the
gradients are summed with one ``all_reduce`` (a parameter the local
samples do not reach gets zeros first), then come the clip by global norm
and Adam, the same on every rank, so the parameters stay bit-identical
across ranks. The parameters are broadcast from rank 0 when the step is
built. The eval: each rank evaluates every window on its node slab and
keeps its metric states; they are summed once at the end.

Padding rows (past the true N) carry ``mask=False``: ``shard_nodes``
pads with zeros, and the node ids the model and the scaler see are
clamped to N - 1 there (JAX clamps the gather the same way). The JAX
package derives each shard's draws with ``fold_in(rng, shard_id)``, which
torch cannot repeat; :func:`rank_generator` seeds rank 0 with the seed
itself, so at one rank the step draws what ``make_fused_iid_multi_step``
draws. The stratified and windowed sharded steps, the on-the-fly
``support_ops`` of the eval and the tensor-parallel placements are not
ported yet (ROADMAP A10).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.parallel import collectives
from sgp_tpu_torch.parallel.mesh import Mesh
from sgp_tpu_torch.train.fused_window import make_offset_gather, pad_eval_items
from sgp_tpu_torch.train.iid import _build_iid_sample_and_loss, unpack_iid_rows
from sgp_tpu_torch.train.metrics import MaskedMetrics
from sgp_tpu_torch.train.predictor import clip_by_global_norm_

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


def all_reduce_grads_(params, group) -> None:
    """Sum the gradients over ``group`` in one flat ``all_reduce``; a
    parameter without a gradient takes zeros first, so every rank's
    optimizer updates the same parameters."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if group is None:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    collectives.all_reduce_(flat, group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def _node_ids(mesh: Mesh, axis: str, n_local: int, n_nodes: int, device):
    """Global ids of this rank's slab rows and which are real nodes."""
    ids = mesh.index[axis] * n_local + torch.arange(n_local, device=device)
    return ids.clamp_max(n_nodes - 1), ids < n_nodes


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
        v, cnt = core.sums_on((x, y, m, n_glob, u_rows))
        total = collectives.all_reduce_(
            torch.stack([v.detach(), cnt.detach().float()]), group)
        count = torch.clamp(total[1], min=1.0)
        return v / count, total[0] / count

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
    size); rows past it count nowhere."""
    if support_ops is not None:
        raise NotImplementedError(
            "make_sharded_iid_eval(support_ops=...) (the stratified layout) "
            "is not ported yet (ROADMAP A10)")
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
