"""Training engine: train and eval steps, and the fit loop.

Counterpart of ``Predictor`` in ``sgp_tpu/train/predictor.py``: a train
step is the forward pass, the masked loss, the gradient, a clip by global
norm and an Adam (or AdamW) update, optionally on a piecewise-constant
learning-rate schedule; ``evaluate`` accumulates masked metrics; ``fit``
keeps the best epoch's weights and stops early on a monitored metric.

Loss semantics: with ``scale_target=False`` (the default) the model's
output is inverse-transformed and the loss taken in the raw data space;
with ``scale_target=True`` it is taken in scaled space. Metrics are always
in raw space.

What differs from the JAX trainer: PyTorch runs eagerly, so there is no
jitted step; the optimizer updates the model's parameters in place, so
``fit`` keeps a copy of the best ``state_dict``; weights are drawn at
:meth:`init` from a ``torch.Generator`` seeded with ``seed`` (flax's
distributions, not its bits — the tests carry flax weights across with
``models/bridge.py``); :meth:`save` writes the weights as a ``state_dict``
(``torch.save``), not msgpack, and :meth:`save_state` the restartable
state through ``train/checkpoint.py``. ``compute_dtype`` runs the forward
and backward with the parameters and the float batch tensors cast (through
``torch.func.functional_call``), as the JAX trainer casts them.

``mesh`` (a ``parallel.Mesh``, one process a rank) makes the loader-based
steps data-parallel: every rank's loader yields the same batches, and each
rank keeps its contiguous slice of the sample-dimension entries
(``_SAMPLE_DIM_KEYS``); the static batch, subgraph arrays, ``node_index``
and scalers stay whole. The loss's sum and count are summed over the
ranks, the gradients are summed before the clip and Adam, ``evaluate``
sums the metric states once, and a batch norm inside the step takes the
whole batch's statistics (``_split_batch_norms``). A ragged
tail batch (its size no multiple of the ranks) runs whole on every rank,
as the JAX trainer replicates it: nothing is summed over the ranks then,
and ``evaluate`` counts it on rank 0 only. ``predict`` runs whole batches
on every rank.

Subgraph batches (``data/subgraph.py``) carry ``target_nodes``, the roots'
positions: the training loss and :meth:`evaluate` read those nodes only.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import logging
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from sgp_tpu_torch.data.scalers import Scaler, ScalerParams
from sgp_tpu_torch.obs.run_logger import RunLogger
from sgp_tpu_torch.train.checkpoint import (_default_rng, _map_tensors,
                                            _set_default_rng,
                                            check_model_config, model_config,
                                            write_state)
from sgp_tpu_torch.train.metrics import (_METRIC_FNS, MaskedMetrics,
                                         _masked_reduce)
from sgp_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


def default_batch_to_call(batch, training: bool):
    """``(args, kwargs)`` for the model from a batch: x, and u and
    node_index when present; ``iid=True`` for per-(time, node) samples (a
    1-D node_index with x at most ``[b w f]``)."""
    kwargs = {"training": training}
    if "u" in batch:
        kwargs["u"] = batch["u"]
    if "node_index" in batch:
        kwargs["node_index"] = batch["node_index"]
        if np.ndim(batch["node_index"]) == 1 and batch["x"].ndim <= 3:
            kwargs["iid"] = True
    return (batch["x"],), kwargs


def clip_by_global_norm_(grads, max_norm: float):
    """``optax.clip_by_global_norm``: when the global norm reaches
    ``max_norm``, every gradient becomes ``g / norm * max_norm``. No epsilon
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6) and no host sync."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    with torch.no_grad():
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def apply_gradients(model: torch.nn.Module, optimizer, grad_clip: float,
                    scheduler=None):
    """The update after a backward, as the JAX trainer's optax chain takes
    it: a parameter the loss does not reach gets a zero gradient (optax
    updates every parameter: it still decays its Adam moments and its
    weight), every gradient is clipped by the global norm, then the
    optimizer steps and the learning-rate schedule advances."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_([p.grad for p in params], grad_clip)
    optimizer.step()
    if scheduler is not None:
        scheduler.step()


def lr_boundaries(lr_milestones, steps_per_epoch: int) -> list:
    """The steps at which the learning rate drops: ``optax``'s
    ``piecewise_constant_schedule`` runs step t at lr times every gamma
    whose boundary is <= t; the reference keys its boundaries in a dict,
    so milestones that land on one step apply gamma once."""
    return sorted({int(m * steps_per_epoch) for m in (lr_milestones or [])})


def make_optimizer(params, lr: float, weight_decay: float = 0.0,
                   boundaries=(), gamma: float = 0.25):
    """``(optimizer, scheduler)``: Adam, or AdamW with ``weight_decay`` >
    0 (optax's defaults), and the piecewise-constant schedule over
    ``boundaries`` (:func:`lr_boundaries`), stepped once an update."""
    if weight_decay > 0:
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: gamma ** sum(t >= b for b in boundaries))
    return opt, sched


def _cast_floats(v, dtype):
    """Every f32 tensor of ``v`` (a tensor, or parameters or a call's
    arguments in dicts, tuples and lists) in ``dtype``; everything else
    (integer and bool tensors, scaler parameters, operators) as it is.
    Mixed precision: f32 master weights, the forward and backward in
    ``dtype``; the gradient of the cast accumulates in f32."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype) if v.dtype == torch.float32 else v
    if isinstance(v, dict):
        return {k: _cast_floats(x, dtype) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(_cast_floats(x, dtype) for x in v)
    return v


def _to_device(v, device):
    if isinstance(v, np.ndarray):
        return torch.as_tensor(v).to(device)
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, ScalerParams):
        return ScalerParams(v.bias.to(device), v.scale.to(device))
    if isinstance(v, (tuple, list)):
        return type(v)(_to_device(x, device) for x in v)
    return v


class Predictor:
    def __init__(self, model: torch.nn.Module,
                 loss: str = "mae",
                 lr: float = 1e-3,
                 weight_decay: float = 0.0,
                 grad_clip: float = 5.0,
                 lr_milestones: Optional[list] = None,
                 lr_gamma: float = 0.25,
                 steps_per_epoch: int = 1,
                 scale_target: bool = False,
                 metrics: Optional[MaskedMetrics] = None,
                 batch_to_call: Optional[Callable] = None,
                 seed: int = 0,
                 mesh=None,
                 sync_batch_stats: bool = True,
                 static_batch: Optional[dict] = None,
                 compute_dtype: Optional[str] = None,
                 device=None):
        """``mesh``: a ``parallel.Mesh`` whose ``data`` axis splits every
        loader batch over its ranks (the module docstring); the parameters
        are broadcast from rank 0 at :meth:`init`. ``sync_batch_stats``
        False leaves a batch norm's statistics under a mesh those of the
        rank's slice (``nn.BatchNorm`` against ``nn.SyncBatchNorm``): not
        the one-process run's, nor the JAX trainer's. ``static_batch``:
        per-run graph state (ELL neighbour tables, edge lists) merged into
        every batch, moved to the device once. Keys already present in a
        batch win. ``compute_dtype`` (``"bfloat16"``): mixed-precision
        steps, the forward and backward with the f32 parameters and float
        batch tensors cast to it and the output cast back to f32; the
        master weights, Adam, the loss and the metrics stay f32.
        ``device``: where the model and the batches live (default
        ``cuda:0``; ``"cpu"`` for the CPU)."""
        self.model = model
        self.mesh = mesh
        self.sync_batch_stats = sync_batch_stats
        self.device = resolve_device(device)
        self.compute_dtype = None if compute_dtype is None else \
            getattr(torch, str(compute_dtype).replace("torch.", ""))
        self.static_batch = {k: _to_device(v, self.device)
                             for k, v in (static_batch or {}).items()}
        self.loss_kind = loss
        self.scale_target = scale_target
        self.metrics = metrics or MaskedMetrics.forecasting()
        self.batch_to_call = batch_to_call or default_batch_to_call
        self.seed = seed
        self.lr, self.weight_decay, self.grad_clip = lr, weight_decay, \
            grad_clip
        self._boundaries = lr_boundaries(lr_milestones, steps_per_epoch)
        self.lr_gamma = lr_gamma
        self.optimizer = None
        self.scheduler = None
        self.scaler: Optional[ScalerParams] = None

    # -- setup -------------------------------------------------------------
    def init(self, batch, scaler: ScalerParams):
        """Draw the weights from ``seed`` and build the optimizer. ``batch``
        is unused (the model's shapes are fixed at construction); it keeps
        the JAX trainer's signature."""
        del batch
        reset = getattr(self.model, "reset_parameters", None)
        if reset is not None and \
                "generator" in inspect.signature(reset).parameters:
            self.model.cpu()
            reset(torch.Generator().manual_seed(self.seed))
        self.model.to(self.device)
        params = list(self.model.parameters())
        self.optimizer, self.scheduler = make_optimizer(
            params, self.lr, self.weight_decay, self._boundaries,
            self.lr_gamma)
        self.scaler = _to_device(scaler, self.device)
        if self.mesh is not None:
            from sgp_tpu_torch.parallel.sharding import broadcast_module_
            broadcast_module_(self.model, self.mesh.group("data"))
        n_params = sum(p.numel() for p in params)
        logger.info(f"Initialized model with {n_params:,} parameters")
        return self

    # -- steps -------------------------------------------------------------
    # The entries whose leading dimension is the sample dimension, cut over
    # the ranks under a mesh; every other entry (node_index, target_nodes,
    # the subgraph arrays, scalers) is shared by the batch's samples. By
    # key, not by shape, as in the JAX trainer.
    _SAMPLE_DIM_KEYS = frozenset(
        {"x", "y", "mask", "u", "u_horizon", "eval_mask"})

    def _rank_share(self, batch):
        """``(the batch this rank runs, whether it is split)``: under a mesh
        a batch whose size the ranks divide is cut into their contiguous
        slices (this rank's kept); a ragged one stays whole."""
        if self.mesh is None:
            return batch, False
        s = self.mesh.size("data")
        b = np.shape(batch["x"])[0]
        if b % s:
            return batch, False
        lo = self.mesh.index["data"] * (b // s)
        return {k: v[lo:lo + b // s]
                if k in self._SAMPLE_DIM_KEYS and np.ndim(v)
                and np.shape(v)[0] == b else v
                for k, v in batch.items()}, True

    @contextlib.contextmanager
    def _split_batch_norms(self, split: bool):
        """Within the block, while this rank runs its slice of a batch
        (``split``), the model's batch norms (each module with a
        ``sum_over_ranks`` slot: ``models/tcn.py::Norm``) take their
        statistics over every rank's slice."""
        norms = [m for m in self.model.modules()
                 if hasattr(m, "sum_over_ranks")] \
            if split and self.sync_batch_stats else []
        if norms:
            from sgp_tpu_torch.parallel import collectives
            total = functools.partial(collectives.all_reduce_sum,
                                      group=self.mesh.group("data"))
        for m in norms:
            m.sum_over_ranks = total
        try:
            yield
        finally:
            for m in norms:
                m.sum_over_ranks = None

    def _check_dp_batch_size(self, loader):
        """Under a mesh the batches must split: a loader batch size the
        ranks do not divide would run every batch whole on every rank."""
        if self.mesh is None:
            return
        s = self.mesh.size("data")
        bs = getattr(loader, "batch_size", None)
        if bs is not None and bs % s:
            raise ValueError(
                f"Predictor DP: batch_size ({bs}) must be divisible by the "
                f"mesh's data-axis size ({s}); otherwise every batch runs "
                f"whole on every rank")

    def _place(self, batch) -> dict:
        out = dict(self.static_batch)
        out.update({k: _to_device(v, self.device) for k, v in batch.items()})
        return out

    def _forward(self, batch, training: bool):
        args, kwargs = self.batch_to_call(batch, training)
        self.model.train(training)
        cdt = self.compute_dtype
        if cdt is None:
            return self.model(*args, **kwargs)
        return torch.func.functional_call(
            self.model, _cast_floats(dict(self.model.named_parameters()), cdt),
            _cast_floats(tuple(args), cdt), _cast_floats(kwargs, cdt)
        ).float()

    @staticmethod
    def _slice_targets(batch, y_hat):
        """``(y_hat, y, mask)`` at the batch's ``target_nodes`` (the roots of
        a subgraph batch) when it has them, else whole."""
        y, mask = batch["y"], batch.get("mask")
        if "target_nodes" in batch:
            tn = batch["target_nodes"].long()
            y_hat, y = y_hat.index_select(-2, tn), y.index_select(-2, tn)
            mask = None if mask is None else mask.index_select(-2, tn)
        return y_hat, y, mask

    def loss_sums(self, batch):
        """The masked training loss's ``(sum, count)`` on a placed batch
        (with autograd)."""
        y_hat, y, mask = self._slice_targets(batch,
                                             self._forward(batch, True))
        sc = batch.get("scaler", self.scaler)
        if self.scale_target:
            y_ref = sc.transform(y)
        else:
            y_hat, y_ref = sc.inverse_transform(y_hat), y
        return _masked_reduce(_METRIC_FNS[self.loss_kind], y_hat, y_ref, mask)

    def compute_loss(self, batch) -> torch.Tensor:
        """The masked training loss of a placed batch (with autograd)."""
        v, n = self.loss_sums(batch)
        return v / torch.clamp(n, min=1.0)

    def train_step(self, batch) -> torch.Tensor:
        """One update on a host batch; returns the loss (a device tensor).
        Under a mesh, the loss over every rank's slice."""
        assert self.optimizer is not None, "call init() first"
        self.optimizer.zero_grad(set_to_none=True)
        batch, split = self._rank_share(batch)
        if self.mesh is None:
            loss = self.compute_loss(self._place(batch))
            loss.backward()
        else:
            from sgp_tpu_torch.parallel.sharding import (_summed_loss,
                                                         all_reduce_grads_,
                                                         broadcast_grads_)
            group = self.mesh.group("data")
            params = [p for p in self.model.parameters() if p.requires_grad]
            if split:
                with self._split_batch_norms(True):
                    part, loss = _summed_loss(
                        *self.loss_sums(self._place(batch)), group)
                    part.backward()
                all_reduce_grads_(params, group)
            else:
                # every rank ran the whole batch: rank 0's gradients and
                # loss keep the replicas and their epochs bit-identical
                from sgp_tpu_torch.parallel import collectives
                loss = self.compute_loss(self._place(batch))
                loss.backward()
                broadcast_grads_(params, group)
                loss = collectives.broadcast_(loss.detach().clone(), group)
        # (the last GraphWaveNet layer's diffusion branch reaches no loss)
        apply_gradients(self.model, self.optimizer, self.grad_clip,
                        self.scheduler)
        return loss.detach()

    # -- loops -------------------------------------------------------------
    def train_epoch(self, loader) -> float:
        self._check_dp_batch_size(loader)
        total, count = 0.0, 0
        for batch in loader:
            total += float(self.train_step(batch))
            count += 1
        return total / max(count, 1)

    @torch.no_grad()
    def evaluate(self, loader, prefix: str = "") -> Dict[str, float]:
        """Masked metrics over the loader's batches; under a mesh each rank
        evaluates its slices, rank 0 the ragged batches, and the metric
        states are summed once at the end."""
        state = self.metrics.init()
        group = None if self.mesh is None else self.mesh.group("data")
        for batch in loader:
            batch, split = self._rank_share(batch)
            if self.mesh is not None and not split \
                    and self.mesh.index["data"]:
                continue        # a ragged batch counts once, on rank 0
            b = self._place(batch)
            sc = b.get("scaler", self.scaler)
            with self._split_batch_norms(split):
                y_hat = self._forward(b, False)
            y_hat, y, mask = self._slice_targets(b, y_hat)
            state = self.metrics.update(state, sc.inverse_transform(y_hat),
                                        y, mask)
        if group is not None:
            from sgp_tpu_torch.parallel import collectives
            names = list(state)
            flat = collectives.all_reduce_(torch.stack([torch.stack([
                torch.as_tensor(state[k][0], device=self.device).float(),
                torch.as_tensor(state[k][1], device=self.device).float()])
                for k in names]), group).cpu()
            state = {k: (flat[i, 0], flat[i, 1]) for i, k in enumerate(names)}
        out = self.metrics.compute(state)
        return {f"{prefix}{k}": v for k, v in out.items()}

    @torch.no_grad()
    def predict(self, loader) -> np.ndarray:
        outs = []
        for batch in loader:
            b = self._place(batch)
            sc = b.get("scaler", self.scaler)
            outs.append(sc.inverse_transform(
                self._forward(b, False)).cpu().numpy())
        return np.concatenate(outs, axis=0)

    @torch.no_grad()
    def predict_loader(self, loader):
        """``(y, y_hat, mask)`` over ``loader``, numpy, concatenated over
        batches (``mask`` None when the batches have none); ``y_hat`` in raw
        space and over all nodes of each batch."""
        ys, yhs, ms = [], [], []
        for batch in loader:
            b = self._place(batch)
            sc = b.get("scaler", self.scaler)
            yhs.append(sc.inverse_transform(
                self._forward(b, False)).cpu().numpy())
            ys.append(np.asarray(batch["y"]))
            ms.append(None if batch.get("mask") is None
                      else np.asarray(batch["mask"]))
        mask = None if ms[0] is None else np.concatenate(ms, 0)
        return np.concatenate(ys, 0), np.concatenate(yhs, 0), mask

    def fit(self, train_loader, val_loader=None, epochs: int = 1,
            patience: Optional[int] = None, monitor: str = "mae",
            log_every: int = 1, scaler: Optional[ScalerParams] = None,
            logdir: Optional[str] = None):
        """Train for ``epochs``, keep the weights of the best epoch (by
        ``val_<monitor>``, or the train loss without a val loader) and
        restore them at the end; stop after ``patience`` epochs without a
        better one. With ``logdir`` each epoch's logs are appended to
        ``<logdir>/metrics.jsonl``. Returns the best value."""
        if self.optimizer is None:
            self.init(next(iter(train_loader)),
                      scaler if scaler is not None else Scaler().params())
        if val_loader is not None and monitor not in self.metrics.names:
            raise ValueError(
                f"monitor={monitor!r} is not a tracked metric; "
                f"available: {sorted(self.metrics.names)}")
        # one rank writes the run's metrics
        run_logger = RunLogger(logdir) if logdir is not None \
            and self._writes() else None
        best_metric, bad_epochs = np.inf, 0
        best_state = self._state_copy()
        for epoch in range(epochs):
            t0 = time.time()
            logs = {"train_loss": self.train_epoch(train_loader)}
            if val_loader is not None:
                logs.update(self.evaluate(val_loader, prefix="val_"))
                current = logs[f"val_{monitor}"]
            else:
                current = logs["train_loss"]
            if run_logger is not None:
                run_logger.log_metrics(logs, step=epoch)
            if current < best_metric:
                best_metric, best_state, bad_epochs = \
                    current, self._state_copy(), 0
            else:
                bad_epochs += 1
            if log_every and epoch % log_every == 0:
                msg = " ".join(f"{k}={v:.4f}" for k, v in logs.items())
                logger.info(f"epoch {epoch}: {msg} "
                            f"({time.time() - t0:.1f}s)")
            if patience is not None and bad_epochs > patience:
                logger.info(f"early stop at epoch {epoch}")
                break
        if run_logger is not None:
            run_logger.close()
        self.model.load_state_dict(best_state)   # restore the best epoch
        return best_metric

    def _state_copy(self) -> dict:
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    def _writes(self) -> bool:
        """Whether this process writes files: under a mesh, rank 0 alone
        (every rank holds the same weights)."""
        return self.mesh is None or not self.mesh.index["data"]

    # -- checkpoint --------------------------------------------------------
    def save_state(self, path: str, epoch: int = 0,
                   best_metric: float = float("inf")):
        """The restartable state in one file (``train/checkpoint.py``'s
        atomic write): the weights, the optimizer's and the learning-rate
        schedule's state, torch's default generators (dropout draws from
        them) and ``extra``: the epoch, the best metric and the model's
        config."""
        assert self.optimizer is not None, "call init() first"
        write_state(path, _map_tensors(lambda t: t.detach().clone(), {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "default_rng": _default_rng(self.model),
            "extra": {"epoch": int(epoch), "best_metric": float(best_metric),
                      "model_config": model_config(self.model)}}))

    def load_state(self, path: str) -> dict:
        """Restore what :meth:`save_state` wrote, after :meth:`init`;
        raises ``ValueError`` naming the fields where the stored model
        config differs from the live model's. Returns ``extra``."""
        if self.optimizer is None:
            raise RuntimeError("call init() before load_state()")
        state = torch.load(path, map_location="cpu", weights_only=False)
        extra = state["extra"]
        if "model_config" in extra:
            check_model_config(extra["model_config"], self.model)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        _set_default_rng(state["default_rng"], self.model)
        return extra

    # -- weights -----------------------------------------------------------
    def save(self, path: str):
        """The model's weights as a ``state_dict`` (``torch.save``); under a
        mesh rank 0 writes them."""
        if not self._writes():
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(self.model.state_dict(), path)

    def load(self, path: str):
        """Weights written by :meth:`save`, onto the model's device."""
        self.model.load_state_dict(torch.load(path, map_location=self.device,
                                              weights_only=True))
        return self
