"""Fused IID decoder training.

Counterpart of ``sgp_tpu/train/iid.py``: a training step draws uniform
(time, node) pairs, gathers their encoder features, horizon targets and
masks from arrays that live on the device, and runs the forward, the
masked loss, the backward, a clip by global norm and Adam, with nothing
read back to the host. PyTorch runs eagerly, so the multi-step call is a
Python loop over steps (the JAX package's ``lax.scan``) whose losses stay
on the device until the caller reads their mean.

Sampling draws from an explicit ``torch.Generator`` on the data's device;
its stream is not JAX's, so the parity tests feed the steps' ``train_on``
(and the core's ``sample_and_loss.loss``) the JAX package's draws. The
stratified trainer (:func:`make_fused_iid_stratified_step`) keeps only the
temporal embedding on the device and propagates the sampled steps through
the supports inside each step. The JAX package's ``take_time_rows`` (a TPU
gather trick) is plain indexing here; its ``pipeline`` option (a TPU
scheduling experiment) is not ported.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from sgp_tpu_torch.data.scalers import ScalerParams
from sgp_tpu_torch.data.spatiotemporal import SpatioTemporalDataset
from sgp_tpu_torch.ops.spmm import DenseOperator, GlobalMeanOperator
from sgp_tpu_torch.train.metrics import _METRIC_FNS, _masked_reduce
from sgp_tpu_torch.train.predictor import _cast_floats, clip_by_global_norm_
from sgp_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def _host(a) -> np.ndarray:
    """A numpy copy of an index vector given as a tensor or array-like."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _f32_to_bf16_pair(y: torch.Tensor):
    """Bit-exact split of f32 into two bf16 lanes (high and low 16 bits):
    the int16 view of a little-endian f32 holds its low half first."""
    halves = y.float().contiguous().view(torch.int16).reshape(
        y.shape + (2,))
    lo = halves[..., 0].contiguous().view(torch.bfloat16)
    hi = halves[..., 1].contiguous().view(torch.bfloat16)
    return hi, lo


def _bf16_pair_to_f32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    halves = torch.stack([lo.contiguous().view(torch.int16),
                          hi.contiguous().view(torch.int16)], dim=-1)
    return halves.view(torch.float32)[..., 0]


def pack_iid_data(encoded: torch.Tensor,    # [T, N, D] (any float dtype)
                  target: torch.Tensor,     # [T, N, C] f32
                  mask: torch.Tensor,       # [T, N, C] bool
                  horizon_offsets) -> torch.Tensor:
    """Pack features, horizon-shifted targets and masks into ONE bf16 row
    per (t, n), so that a training step gathers one row per sample.

    Layout per row: ``[enc(D) | y_hi(H*C) | y_lo(H*C) | mask(H*C)]``, the
    f32 targets split bit-exactly into two bf16 lanes. Rows whose horizon
    would wrap past T hold rolled values that ``valid_starts`` never
    samples. Returns ``[T, N, D + 3*H*C]`` in bf16."""
    h_np = _host(horizon_offsets).astype(np.int64)
    t_steps, n_nodes = target.shape[:2]
    ys = torch.stack([torch.roll(target, -int(h), 0) for h in h_np],
                     dim=2)                          # [T, N, H, C]
    ms = torch.stack([torch.roll(mask, -int(h), 0) for h in h_np], dim=2)
    hi, lo = _f32_to_bf16_pair(ys)
    parts = [encoded.to(torch.bfloat16),
             hi.reshape(t_steps, n_nodes, -1),
             lo.reshape(t_steps, n_nodes, -1),
             ms.reshape(t_steps, n_nodes, -1).to(torch.bfloat16)]
    return torch.cat(parts, dim=-1)


def unpack_iid_rows(rows: torch.Tensor, feat: int, n_horizon: int,
                    n_channels: int):
    """Split gathered packed rows ``[B, D+3HC]`` back into ``x [B, D]``
    bf16, ``y [B, H, C]`` f32 (bit-exact) and ``m [B, H, C]`` bool."""
    b = rows.shape[0]
    hc = n_horizon * n_channels
    x = rows[:, :feat]
    hi = rows[:, feat:feat + hc]
    lo = rows[:, feat + hc:feat + 2 * hc]
    m = rows[:, feat + 2 * hc:feat + 3 * hc]
    y = _bf16_pair_to_f32(hi, lo).reshape(b, n_horizon, n_channels)
    return x, y, (m > 0.5).reshape(b, n_horizon, n_channels)


def _packed_dtype_ok(encoded) -> bool:
    """Only bf16 encodings may be packed: the packed row stores features
    as bf16 lanes, so any other dtype would change precision."""
    if encoded is None or encoded.dtype == torch.bfloat16:
        return True
    logger.info("packed=True ignored: encoding is %s (packing would change "
                "its precision to bf16); using the unpacked gather path",
                encoded.dtype)
    return False


def _build_iid_sample_and_loss(model, encoded, target, mask,
                               valid_starts, horizon_offsets,
                               scaler: ScalerParams, u=None,
                               batch_size: int = 4096, loss: str = "mae",
                               scale_target: bool = False,
                               packed=False, compute_dtype=None,
                               gather_block: int = 1, node_perm=None):
    """The sampling and loss core of the fused steps: returns ``(data,
    sample_and_loss)``, where ``sample_and_loss(generator)`` is the masked
    loss of one freshly sampled batch (with autograd), in phases that the
    single-trial and the multi-trial steps share:

    - ``sample_and_loss.sample(generator) -> (t, n)``: the draws, time
      steps ``t`` from ``valid_starts`` and nodes ``n`` (with
      ``gather_block=G > 1``: ``batch/G`` draws of (time, node block));
    - ``sample_and_loss.gather(t, n) -> sampled``: the rows of the draws;
    - ``sample_and_loss.loss_on(sampled, params=None)``: the forward and
      masked loss on gathered rows, with ``model``'s own parameters or
      with ``params`` (a name -> tensor dict, through
      ``torch.func.functional_call``);
    - ``sample_and_loss.sums_on(sampled, params=None) -> (sum, count)``:
      the masked loss's sum and count before the division (the node-sharded
      step divides by the count over every rank);
    - ``sample_and_loss.loss(t, n)``: gather and loss on given draws,
      which the parity tests take from the JAX package.

    ``packed`` True packs the (bf16) encoding with :func:`pack_iid_data`; a
    tensor is taken as the prebuilt packed layout (``encoded`` may then be
    None). ``gather_block=G`` gathers G consecutive packed rows a draw
    (cluster sampling over a fixed node partition; ``G`` must divide the
    batch and the node count); ``node_perm [N]`` declares that the packed
    node axis is ordered by that permutation, and maps the sampled
    positions back to node ids. Packed rows reach the model as f32, as
    flax promotes bf16 inputs against f32 parameters.
    ``compute_dtype=torch.bfloat16`` casts the f32 parameters and the
    inputs x and u to bf16 inside the differentiable call, as the JAX
    package's ``_cast_floats`` does: the parameters and their gradients
    stay f32, and the output is cast to f32 before the loss."""
    loss_pt = _METRIC_FNS[loss]
    h_np = _host(horizon_offsets)
    n_h = int(h_np.shape[0])
    n_c = target.shape[-1]
    if isinstance(packed, torch.Tensor):
        big, packed = packed, True           # prebuilt packed layout
    elif packed and not _packed_dtype_ok(encoded):
        packed, big = False, None
    elif packed:
        big = pack_iid_data(encoded, target, mask, h_np)
    else:
        big = None
    device = (encoded if encoded is not None else big).device
    n_nodes = (encoded if encoded is not None else big).shape[1]
    feat = encoded.shape[-1] if encoded is not None \
        else big.shape[-1] - 3 * n_h * n_c
    if gather_block > 1:
        if not packed:
            raise ValueError("gather_block > 1 requires the packed "
                             "layout (packed=True or a prebuilt array)")
        if batch_size % gather_block or n_nodes % gather_block:
            raise ValueError(
                f"gather_block={gather_block} must divide both "
                f"batch_size={batch_size} and n_nodes={n_nodes}")
    elif node_perm is not None:
        raise ValueError("node_perm only applies to the blocked gather "
                         "(gather_block > 1); the per-pair IID path "
                         "samples nodes uniformly already")
    valid = torch.as_tensor(valid_starts, device=device)
    h_off = torch.as_tensor(h_np, device=device)
    perm = None if node_perm is None else torch.as_tensor(
        node_perm, device=device)
    data = ((big, valid) if packed else
            (encoded, target, mask, valid, h_off)) + \
        ((u,) if u is not None else ())
    g = gather_block
    draws = batch_size // g

    def sample(generator: torch.Generator):
        """Uniform draws: ``t`` from the valid starts, ``n`` a node (a
        node block when ``gather_block > 1``)."""
        t = valid[torch.randint(len(valid), (draws,), generator=generator,
                                device=device)]
        n = torch.randint(n_nodes // g, (draws,), generator=generator,
                          device=device)
        return t, n

    def gather(t, n):
        """``(x, y, m, node ids, u rows)`` of the draws."""
        if g > 1:
            width = big.shape[-1]
            blocks = big.reshape(-1, g, width)        # [T*N/g, g, W]
            rows = blocks[t * (n_nodes // g) + n].reshape(batch_size, width)
            n = (n[:, None] * g + torch.arange(g, device=device)).reshape(-1)
            if perm is not None:
                # sampled positions in the shuffled layout -> node ids
                n = perm[n]
            t = t.repeat_interleave(g)
            x, y, m = unpack_iid_rows(rows, feat, n_h, n_c)
        elif packed:
            x, y, m = unpack_iid_rows(big[t, n], feat, n_h, n_c)
        else:
            steps = t[:, None] + h_off[None, :]
            x = encoded[t, n]                          # [B, D]
            y = target[steps, n[:, None]]              # [B, H, C]
            m = mask[steps, n[:, None]]
        u_rows = None
        if u is not None:
            # node-level [T, N, F] (e.g. keep_raw) or global [T, F]
            u_rows = u[t, n] if u.ndim == 3 else u[t]
        return x, y, m, n, u_rows

    def sums_on(sampled, params: Optional[dict] = None):
        x, y, m, n, u_rows = sampled
        kwargs = {} if u_rows is None else {"u": u_rows}
        if compute_dtype is not None:
            params = _cast_floats(
                dict(model.named_parameters()) if params is None else params,
                compute_dtype)
            x = x.to(compute_dtype)
            if u_rows is not None:
                kwargs["u"] = u_rows.to(compute_dtype)
        else:
            x = x.float()
        kwargs.update(node_index=n, training=True, iid=True)
        model.train(True)
        y_hat = (model(x, **kwargs) if params is None else
                 torch.func.functional_call(model, params, (x,), kwargs))
        y_hat = y_hat.float()
        sc = scaler.index_nodes_iid(n)
        if scale_target:
            y_ref = sc.transform(y)
        else:
            y_hat, y_ref = sc.inverse_transform(y_hat), y
        return _masked_reduce(loss_pt, y_hat, y_ref, m)

    def loss_on(sampled, params: Optional[dict] = None):
        v, cnt = sums_on(sampled, params)
        return v / torch.clamp(cnt, min=1.0)

    def sample_and_loss(generator):
        return loss_on(gather(*sample(generator)))

    sample_and_loss.sample = sample
    sample_and_loss.gather = gather
    sample_and_loss.loss_on = loss_on
    sample_and_loss.sums_on = sums_on
    sample_and_loss.loss = lambda t, n: loss_on(gather(t, n))
    sample_and_loss.packed = packed
    return data, sample_and_loss


def make_fused_iid_step(model, optimizer, encoded, target, mask,
                        valid_starts, horizon_offsets, scaler: ScalerParams,
                        u: Optional[torch.Tensor] = None,
                        batch_size: int = 4096, loss: str = "mae",
                        scale_target: bool = False, packed=False,
                        compute_dtype=None, gather_block: int = 1,
                        node_perm=None,
                        grad_clip: Optional[float] = None) -> Callable:
    """Build ``step(generator) -> loss``: sample, gather, forward, masked
    loss, backward, clip by global norm (``grad_clip``, as
    ``optax.clip_by_global_norm``) and ``optimizer.step()`` on ``model``'s
    parameters in place. The loss stays a device tensor.
    ``step.train_on(t, n)`` takes one step on given draws; ``packed``,
    ``compute_dtype`` and the rest as in :func:`_build_iid_sample_and_loss`.
    """
    data, sample_and_loss = _build_iid_sample_and_loss(
        model, encoded, target, mask, valid_starts, horizon_offsets,
        scaler, u=u, batch_size=batch_size, loss=loss,
        scale_target=scale_target, packed=packed,
        compute_dtype=compute_dtype, gather_block=gather_block,
        node_perm=node_perm)
    params = list(model.parameters())

    def train_on(t, n):
        optimizer.zero_grad(set_to_none=True)
        loss_val = sample_and_loss.loss(t, n)
        loss_val.backward()
        if grad_clip is not None:
            clip_by_global_norm_([p.grad for p in params
                                  if p.grad is not None], grad_clip)
        optimizer.step()
        return loss_val.detach()

    def step(generator):
        return train_on(*sample_and_loss.sample(generator))

    step.train_on = train_on
    step.data = data
    step.sample_and_loss = sample_and_loss
    step.packed = sample_and_loss.packed
    return step


def make_fused_iid_multi_step(model, optimizer, encoded, target, mask,
                              valid_starts, horizon_offsets,
                              scaler: ScalerParams, u=None,
                              batch_size: int = 4096, loss: str = "mae",
                              scale_target: bool = False,
                              steps_per_call: int = 32, packed=False,
                              compute_dtype=None, gather_block: int = 1,
                              node_perm=None,
                              grad_clip: Optional[float] = None
                              ) -> Callable:
    """Like :func:`make_fused_iid_step`, but ``multi_step(generator)`` runs
    ``steps_per_call`` steps and returns their mean loss as a device
    tensor: no host sync inside the call."""
    single = make_fused_iid_step(
        model, optimizer, encoded, target, mask, valid_starts,
        horizon_offsets, scaler, u=u, batch_size=batch_size, loss=loss,
        scale_target=scale_target, packed=packed,
        compute_dtype=compute_dtype, gather_block=gather_block,
        node_perm=node_perm, grad_clip=grad_clip)

    def multi_step(generator):
        return torch.stack([single(generator)
                            for _ in range(steps_per_call)]).mean()

    multi_step.single = single
    multi_step.data = single.data
    multi_step.packed = single.packed
    return multi_step


def assemble_stratified(h_sel: torch.Tensor, n: torch.Tensor, support_ops,
                        global_attr: bool,
                        assembly: str = "gather_rows") -> torch.Tensor:
    """The sampled rows ``[Tb, P, D]`` of ``[h, A_1 h, ..., mean(h)]`` in
    ``h_sel``'s dtype, from the selected steps ``h_sel [Tb, N, Ht]`` (every
    node) and the sampled node ids ``n [Tb, P]``; ``assembly`` as in
    :func:`make_fused_iid_stratified_step`."""
    h_dim = h_sel.shape[-1]
    rows_of = n[:, :, None].expand(-1, -1, h_dim)
    parts = [torch.gather(h_sel, 1, rows_of)]          # [Tb, P, Ht]
    for op in support_ops:
        if isinstance(op, DenseOperator) and assembly == "gather_rows":
            # only the sampled destination rows of the support
            hs = (h_sel.to(torch.bfloat16) if op.precision == "default"
                  else h_sel)
            hop = torch.bmm(op.mat[n], hs.to(op.mat.dtype))
        else:
            hop = torch.gather(op @ h_sel, 1, rows_of)
        parts.append(hop.to(h_sel.dtype))
    if global_attr:
        mean = GlobalMeanOperator(h_sel.shape[1]) @ h_sel   # a broadcast
        parts.append(mean[:, :1].expand_as(parts[0]))
    return torch.cat(parts, -1)


def stratified_sums(model, x, target, mask, u, t_flat, rows, node_ids,
                    h_off, scaler: ScalerParams, loss_pt,
                    scale_target: bool):
    """The masked loss's ``(sum, count)`` on assembled rows ``x [B, D]``
    drawn at steps ``t_flat [B]``: the horizon targets, masks and a
    node-level ``u`` read at ``rows [B]`` of their arrays' node axis, the
    model's node embedding and the scaler at ``node_ids [B]`` (the same
    ids, unless the arrays are a node slab)."""
    steps = t_flat[:, None] + h_off[None, :]
    y = target[steps, rows[:, None]]                   # [B, H, C]
    m = mask[steps, rows[:, None]]
    kwargs = {}
    if u is not None:
        # node-level [T, N, F] or global [T, F]
        kwargs["u"] = u[t_flat, rows] if u.ndim == 3 else u[t_flat]
    model.train(True)
    y_hat = model(x.float(), node_index=node_ids, training=True, iid=True,
                  **kwargs).float()
    sc = scaler.index_nodes_iid(node_ids)
    if scale_target:
        y_ref = sc.transform(y)
    else:
        y_hat, y_ref = sc.inverse_transform(y_hat), y
    return _masked_reduce(loss_pt, y_hat, y_ref, m)


def make_fused_iid_stratified_step(model, optimizer,
                                   h_temporal: torch.Tensor,  # [T, N, Ht]
                                   target: torch.Tensor,      # [T, N, C]
                                   mask: torch.Tensor,        # [T, N, C]
                                   valid_starts, horizon_offsets,
                                   scaler: ScalerParams,
                                   support_ops,
                                   global_attr: bool = True,
                                   u: Optional[torch.Tensor] = None,
                                   times_per_batch: int = 32,
                                   nodes_per_time: int = 128,
                                   loss: str = "mae",
                                   scale_target: bool = False,
                                   steps_per_call: int = 1,
                                   assembly: str = "gather_rows",
                                   support_dtype=None,
                                   grad_clip: Optional[float] = None
                                   ) -> Callable:
    """Stratified IID training with the spatial propagation inside the
    step: only the temporal (reservoir) embedding ``h_temporal`` stays on
    the device, ``k + 1`` times smaller than the precomputed expansion.

    A step draws ``times_per_batch`` window starts ``t`` (uniform, with
    replacement) and ``nodes_per_time`` nodes a start ``n [Tb, P]``, a
    batch of ``Tb * P`` (time, node) pairs that share their times; takes
    the selected steps ``h_sel [Tb, N, Ht]``; and assembles the sampled
    rows of ``[h, A_1 h, ..., mean(h)]`` in ``h_temporal``'s dtype, with
    no autograd. ``assembly`` picks how a hop's rows are made:

    - ``"gather_rows"``: a dense support's rows at the sampled nodes, then
      one batched ``[Tb, P, N] x [Tb, N, Ht]`` product, f32 sums cast to
      the embedding's dtype (the JAX package's einsum). Other operators
      take the ``full_prop`` route.
    - ``"full_prop"``: ``op @ h_sel`` over all nodes, then the row gather;
      a ``BSROperator`` folds ``h_sel`` into one ``[N, Tb * Ht]`` product,
      kernel K1 on the card.

    ``support_dtype=torch.bfloat16`` rounds the dense supports to bf16
    (``precision="default"``: both operands bf16, sums f32). Then the
    forward, the masked loss, the backward, the clip by global norm at
    ``grad_clip`` and ``optimizer.step()``, ``steps_per_call`` times;
    ``step(generator)`` returns the mean loss as a device tensor.
    ``step.train_on(t, n)`` takes one step on given draws and
    ``step.features(t, n)`` returns the assembled ``[Tb * P, D]`` rows."""
    if assembly not in ("gather_rows", "full_prop"):
        raise ValueError(f"assembly must be 'gather_rows' or 'full_prop', "
                         f"got {assembly!r}")
    if support_dtype is not None:
        if support_dtype != torch.bfloat16:
            raise ValueError(f"support_dtype must be torch.bfloat16, got "
                             f"{support_dtype}")
        support_ops = [DenseOperator(op.mat, "default")
                       if isinstance(op, DenseOperator) else op
                       for op in support_ops]
    loss_pt = _METRIC_FNS[loss]
    device = h_temporal.device
    n_nodes = h_temporal.shape[1]
    batch_size = times_per_batch * nodes_per_time
    valid = torch.as_tensor(valid_starts, device=device)
    h_off = torch.as_tensor(_host(horizon_offsets), device=device)
    params = list(model.parameters())

    @torch.no_grad()
    def features(t, n):
        return assemble_stratified(h_temporal[t], n, support_ops,
                                   global_attr, assembly
                                   ).reshape(batch_size, -1)

    def loss_on(t, n):
        v, cnt = stratified_sums(
            model, features(t, n), target, mask, u,
            t.repeat_interleave(nodes_per_time), n.reshape(-1),
            n.reshape(-1), h_off, scaler, loss_pt, scale_target)
        return v / torch.clamp(cnt, min=1.0)

    def train_on(t, n):
        optimizer.zero_grad(set_to_none=True)
        loss_val = loss_on(t, n)
        loss_val.backward()
        if grad_clip is not None:
            clip_by_global_norm_([p.grad for p in params
                                  if p.grad is not None], grad_clip)
        optimizer.step()
        return loss_val.detach()

    def sample(generator: torch.Generator):
        t = valid[torch.randint(len(valid), (times_per_batch,),
                                generator=generator, device=device)]
        n = torch.randint(n_nodes, (times_per_batch, nodes_per_time),
                          generator=generator, device=device)
        return t, n

    def step(generator: torch.Generator):
        return torch.stack([train_on(*sample(generator))
                            for _ in range(max(steps_per_call, 1))]).mean()

    step.train_on = train_on
    step.sample = sample
    step.features = features
    return step


def fused_iid_inputs(dataset: SpatioTemporalDataset, dtype=torch.float32,
                     device=None):
    """Move the dataset arrays the fused step reads to ``device`` (default
    ``cuda:0``) once: ``(encoded, target, mask, valid, h_off, u)``, the
    float ones in ``dtype``."""
    device = resolve_device(device)
    encoded = torch.as_tensor(dataset.input_array(), device=device).to(dtype)
    if encoded.ndim != 3:
        raise ValueError("input_array must be [T, N, C]")
    target = torch.as_tensor(dataset.target, device=device).to(dtype)
    mask = torch.as_tensor(dataset.mask, device=device)
    u = dataset.exog_array()
    u = None if u is None else torch.as_tensor(u, device=device).to(dtype)
    valid = torch.as_tensor(dataset.indices(), device=device)
    h_off = torch.as_tensor(dataset.windowing.horizon_offsets(),
                            device=device)
    return encoded, target, mask, valid, h_off, u
