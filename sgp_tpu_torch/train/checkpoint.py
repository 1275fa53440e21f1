"""Train-state checkpointing for restartable training.

Counterpart of ``sgp_tpu/train/checkpoint.py``: the model's and the
optimizer's state, the sampler's generator state, torch's default
generators' states (dropout draws from them) and the run's progress go
into ONE file with ``torch.save``, written to a temporary file and
renamed, so a killed run resumes deterministically from the last complete
checkpoint.

Under a process group of several ranks (a node-sharded run) the weights
and the optimizer's state are the same on every rank, but each rank draws
from its own generators: :func:`gather_rank_states` collects every rank's
states into the one file (``ranks``, with ``world_size``), which rank 0
writes, and :func:`restore_run_state` gives each rank its own back; a
resume under another world size raises.

PyTorch updates parameters in place, so a checkpoint (and the best-so-far
weights it holds) is a copy of the state taken at the moment of the save;
:class:`AsyncCheckpointer` takes that copy on the caller's thread and
writes it on a worker thread.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import torch


def model_config(model: torch.nn.Module) -> Dict[str, str]:
    """A fingerprint of a module's hyperparameters, stored in checkpoints
    and asserted on reload: its class, its printed structure (layer widths,
    dropout rates) and its public scalar attributes (e.g. the horizon)."""
    out = {"__class__": type(model).__name__, "__repr__": repr(model)}
    for name, value in sorted(vars(model).items()):
        if not name.startswith("_") and name != "training" and \
                isinstance(value, (bool, int, float, str)):
            out[name] = repr(value)
    return out


def check_model_config(stored: Dict[str, str], model):
    """Raise if the checkpoint's model config mismatches the live model."""
    live = model_config(model)
    mismatched = {k: (stored.get(k), live.get(k))
                  for k in set(stored) | set(live)
                  if stored.get(k) != live.get(k)}
    if mismatched:
        raise ValueError(
            "checkpoint model config mismatch (stored vs live): "
            f"{mismatched}")


def _map_tensors(fn, state):
    """``fn`` applied to every tensor of a nested state."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, dict):
        return {k: _map_tensors(fn, v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_map_tensors(fn, v) for v in state)
    return state


def _default_rng(model) -> dict:
    """The states of torch's default generators that ``model`` draws from:
    the host's and, on a card, that card's."""
    device = next(model.parameters()).device
    return {"cpu": torch.get_rng_state(),
            "cuda": (torch.cuda.get_rng_state(device)
                     if device.type == "cuda" else None)}


def _set_default_rng(states: dict, model):
    """Restore what :func:`_default_rng` took."""
    torch.set_rng_state(states["cpu"])
    device = next(model.parameters()).device
    if device.type == "cuda":
        torch.cuda.set_rng_state(states["cuda"], device)


def _generator_states(generator):
    """A generator's state, or a list of them for a list of generators."""
    if isinstance(generator, (list, tuple)):
        return [g.get_state() for g in generator]
    return generator.get_state()


def _set_generator_states(states, generator):
    if isinstance(generator, (list, tuple)):
        if len(states) != len(generator):
            raise ValueError(f"checkpoint holds {len(states)} generator "
                             f"states, the run has {len(generator)}")
        for g, st in zip(generator, states):
            g.set_state(st)
    else:
        generator.set_state(states)


def _rank_states(generator, model) -> dict:
    """This rank's own states: its generator's (or generators') and torch's
    default generators' (:func:`_default_rng`)."""
    return _map_tensors(lambda t: t.detach().cpu().clone(), {
        "rng": _generator_states(generator),
        "default_rng": _default_rng(model)})


def gather_rank_states(generator, model, group=None) -> list:
    """Every rank's :func:`_rank_states` in rank order (an
    ``all_gather_object`` over ``group``, the world by default); every
    rank of the group calls it together."""
    import torch.distributed as dist
    world = dist.get_world_size(group)
    out = [None] * world
    dist.all_gather_object(out, _rank_states(generator, model), group=group)
    return out


def run_state(model, optimizer, generator, epoch: int,
              best_loss: float, best_state: dict, elapsed_s: float = 0.0,
              train_config: Optional[Dict] = None,
              ranks: Optional[list] = None) -> dict:
    """A copy of everything a restartable runner epoch needs: the current
    weights, optimizer state and generator state (``generator`` may be a
    list of generators), torch's default generators (the host's and the
    model device's, which dropout draws from), the best-so-far weights and
    the progress. ``train_config`` records the training hyperparameters,
    so that a resume under other settings fails. ``ranks``: every rank's
    :func:`_rank_states` (:func:`gather_rank_states`), kept beside the world
    size. The copy is one no later in-place update reaches."""
    return _map_tensors(lambda t: t.detach().clone(), {
        "model": model.state_dict(), "optimizer": optimizer.state_dict(),
        "rng": _generator_states(generator),
        "default_rng": _default_rng(model),
        "epoch": int(epoch),
        "best_loss": float(best_loss), "best_state": best_state,
        "model_config": model_config(model),
        "train_config": dict(train_config or {}),
        "elapsed_s": float(elapsed_s),
        "world_size": 1 if ranks is None else len(ranks),
        "ranks": ranks})


def write_state(path: str, state: dict):
    """``torch.save`` to a temporary file, then an atomic rename: a crash
    mid-write keeps the previous checkpoint."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_map_tensors(torch.Tensor.cpu, state), tmp)
    os.replace(tmp, path)


def save_train_state(path: str, model: torch.nn.Module, optimizer=None,
                     generator: Optional[torch.Generator] = None,
                     extra: Optional[Dict] = None):
    """The model's weights, the optimizer's state, a generator's state and
    an ``extra`` dict in one ``torch.save`` file, written through
    ``path + ".tmp"`` and an atomic rename (a crash mid-write keeps the
    previous file)."""
    write_state(path, _map_tensors(lambda t: t.detach().clone(), {
        "model": model.state_dict(),
        "optimizer": None if optimizer is None else optimizer.state_dict(),
        "rng": None if generator is None else generator.get_state(),
        "extra": dict(extra or {})}))


def load_train_state(path: str, model: torch.nn.Module, optimizer=None,
                     generator: Optional[torch.Generator] = None) -> dict:
    """Counterpart of :func:`save_train_state`: loads the weights and,
    where given and stored, the optimizer's and the generator's states in
    place; returns the ``extra`` dict."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    model.load_state_dict(state["model"])
    if optimizer is not None and state["optimizer"] is not None:
        optimizer.load_state_dict(state["optimizer"])
    if generator is not None and state["rng"] is not None:
        generator.set_state(state["rng"])
    return state["extra"]


def save_run_state(path: str, model, optimizer, generator, epoch: int,
                   best_loss: float, best_state: dict,
                   elapsed_s: float = 0.0,
                   train_config: Optional[Dict] = None):
    """One atomic file for a restartable runner epoch (:func:`run_state`):
    current and best weights live in the same rename, so a kill never
    leaves them out of step."""
    write_state(path, run_state(model, optimizer, generator, epoch,
                                best_loss, best_state, elapsed_s,
                                train_config))


class AsyncCheckpointer:
    """Background checkpoint writer.

    :meth:`save` takes :func:`run_state`'s arguments after the path: the
    copy of the state is made on the caller's thread (a device copy), and
    the device-to-host transfer and the write run on a worker thread while
    training goes on. At most one save is in flight: a new :meth:`save`
    joins the previous one first. A writer's exception is raised at the
    next :meth:`save` or :meth:`wait`. Call :meth:`wait` before reading the
    file or exiting."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, path: str, *args, **kwargs):
        self.wait()
        state = run_state(*args, **kwargs)

        def run():
            try:
                write_state(path, state)
            except Exception as e:   # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def restore_run_state(path: str, model, optimizer, generator,
                      train_config: Optional[Dict] = None, rank: int = 0,
                      world_size: int = 1):
    """Counterpart of :func:`save_run_state`: loads the weights, optimizer
    state, generator state and the default generators' states in place
    and returns ``(start_epoch, best_loss, best_state, elapsed_s)``,
    ``best_state`` on the model's device; raises on a model- or
    train-config mismatch, or when the file was written by another number
    of ranks than ``world_size``. Rank ``rank`` takes its own generator
    states from a checkpoint of several ranks."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    stored_world = state.get("world_size", 1)
    if stored_world != world_size:
        raise ValueError(
            f"checkpoint {path} was written by {stored_world} rank(s); "
            f"this run has {world_size}: resume under the same world size")
    check_model_config(state["model_config"], model)
    stored_tc = state.get("train_config", {})
    if train_config:
        mismatched = {k: (stored_tc.get(k), v)
                      for k, v in train_config.items()
                      if stored_tc.get(k) != v}
        if mismatched:
            raise ValueError(
                "checkpoint train config mismatch (stored vs live): "
                f"{mismatched}")
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    own = state if stored_world == 1 else state["ranks"][rank]
    _set_generator_states(own["rng"], generator)
    _set_default_rng(own["default_rng"], model)
    device = next(model.parameters()).device
    best_state = {k: v.to(device) for k, v in state["best_state"].items()}
    return (state["epoch"] + 1, state["best_loss"], best_state,
            state.get("elapsed_s", 0.0))
