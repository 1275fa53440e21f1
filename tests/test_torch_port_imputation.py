"""The imputation slice against the JAX package, on the CPU.

- ``sample_mask``, ``add_missing_values`` and ``ImputationDataset.
  gather_batch`` are numpy on both sides: equal bit for bit at one seed.
- ``SpatialDecoder``, ``GRIL`` and ``GRINModel`` on weights carried by the
  bridge, on dense and BSR supports (the JAX ones through the Pallas
  kernel, interpreted; the port's through K1's plain version): within
  1e-5 of the largest value (f32 sums in other orders).
- The RNN imputers (GRU and LSTM, nodes flattened or independent,
  ``detach_input``, zero and noise initial states, the noise carried from
  the JAX draw): within 1e-5 of the largest value.
- The imputer loss (within 1e-5) and its gradients (TOL_GRAD) with JAX's
  whitening draw carried.
- The runner: the port's ``run_imputation`` from the JAX run's initial
  weights and whitening draws (the numpy batches are the same draws)
  gives the JAX runner's test metrics within TOL_RUN relative (f32 sums
  in other orders through 4 Adam steps).

Also as the JAX package's tests hold its imputers (``tests/test_zoo.py``,
``tests/test_analysis.py``, ``tests/test_runners.py``): causality of the
one-step predictions, the BiRNNI merge's sight of the future, a loss that
falls, and runs below the trivial relative-error bar.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sgp_tpu.graph as jg
from sgp_tpu.data import Windowing as JWindowing
from sgp_tpu.data.imputation import ImputationDataset as JImputationDataset
from sgp_tpu.data.imputation import add_missing_values as j_add_missing
from sgp_tpu.data.imputation import sample_mask as j_sample_mask
from sgp_tpu.exp import run_imputation as j_run
from sgp_tpu.exp.common import Experiment as JExperiment
from sgp_tpu.models.graph_layers import diff_conv_support as j_support
from sgp_tpu.models.grin import GRIL as JGRIL
from sgp_tpu.models.grin import GRINModel as JGRINModel
from sgp_tpu.models.grin import SpatialDecoder as JSpatialDecoder
from sgp_tpu.models.rnni import BiRNNImputerModel as JBiRNNI
from sgp_tpu.models.rnni import RNNImputerModel as JRNNI
from sgp_tpu.train.imputer import make_imputer_train_step as j_make_step
from sgp_tpu.utils.config import config as jax_config

import sgp_tpu_torch.graph as tg
from sgp_tpu_torch.data import (ImputationDataset, Windowing,
                                add_missing_values, sample_mask)
from sgp_tpu_torch.exp import run_imputation as t_run
from sgp_tpu_torch.exp.common import Experiment
from sgp_tpu_torch.models import (GRIL, BiRNNImputerModel, GRINModel,
                                  RNNImputerModel, SpatialDecoder,
                                  diff_conv_support, flax_to_torch,
                                  get_model_class)
from sgp_tpu_torch.train import imputer as t_imputer
from sgp_tpu_torch.utils.config import config as torch_config

torch.set_num_threads(1)

N, C, B, S = 10, 1, 2, 6
TOL = 1e-5
# a gradient against the largest entry of its parameter's: f32 sums in
# other orders through 6 recurrent steps (measured at most 1.1e-5, GRIN's
# r-gate weights)
TOL_GRAD = 1e-4
TOL_RUN = 1e-5
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setitem(torch_config, "logs_dir", str(tmp_path / "torch"))
    monkeypatch.setattr(jax_config, "logs_dir", str(tmp_path / "jax"))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max() / np.abs(want).max())


def _graphs(rng, n=N):
    src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    w = rng.random(4 * n).astype(np.float32)
    return (jg.coalesce(jg.Graph(src, dst, w, n)),
            tg.coalesce(tg.Graph(src, dst, w, n)))


def _supports(rng, mode):
    jgr, tgr = _graphs(rng)
    js = j_support(jgr, operator_mode=mode)
    if mode == "bsr":
        for op in js:
            op._variant = "pallas"
    return js, diff_conv_support(tgr, operator_mode=mode, device="cpu")


def _inputs(rng, shape=(B, S, N, C), p_obs=0.7):
    x = rng.standard_normal(shape).astype(np.float32)
    mask = rng.random(shape) < p_obs
    return x, mask


def _carry(jmodel, torch_model, *args, rngs=None, **kwargs):
    params = jmodel.init(rngs or {"params": KEY, "dropout": KEY}, *args,
                         **kwargs)
    flax_to_torch(jax.tree.map(np.asarray, params), torch_model)
    return params


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [out]


# -- the data utilities -----------------------------------------------------

@pytest.mark.parametrize("p,p_noise,min_seq,max_seq", [
    (0.01, 0.05, 5, 10), (0.0015, 0.05, 1, 10), (0.2, 0.0, 1, 1)])
def test_sample_mask_matches_jax(p, p_noise, min_seq, max_seq):
    kw = dict(p=p, p_noise=p_noise, min_seq=min_seq, max_seq=max_seq)
    want = j_sample_mask((300, 7, 2), rng=np.random.default_rng(3), **kw)
    got = sample_mask((300, 7, 2), rng=np.random.default_rng(3), **kw)
    np.testing.assert_array_equal(got, want)
    assert want.any()


def test_sample_mask_blackouts(rng):
    m = sample_mask((500, 10, 1), p=0.01, p_noise=0.05, min_seq=5,
                    max_seq=10, rng=rng)
    assert 0.05 < m.mean() < 0.5


@pytest.mark.parametrize("node_index", [None, np.array([6, 1, 3])])
def test_imputation_dataset_matches_jax(rng, node_index):
    data = rng.standard_normal((60, 8, 1)).astype(np.float32) + 5
    valid = rng.random((60, 8, 1)) > 0.1
    jds = JImputationDataset(data, mask=valid,
                             windowing=JWindowing(window=8, horizon=1))
    tds = ImputationDataset(data, mask=valid,
                            windowing=Windowing(window=8, horizon=1))
    j_add_missing(jds, p_fault=0.01, p_noise=0.2, seed=1)
    add_missing_values(tds, p_fault=0.01, p_noise=0.2, seed=1)
    np.testing.assert_array_equal(tds.covariates["eval_mask"].value,
                                  jds.covariates["eval_mask"].value)
    items = np.array([0, 3, 17, 40])
    want = jds.gather_batch(items, node_index=node_index)
    got = tds.gather_batch(items, node_index=node_index)
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    # the trainer's contract: hidden points zeroed, the raw window as
    # target, the training mask valid and not hidden
    ev = tds.covariates["eval_mask"].value.astype(bool)
    if node_index is None:
        assert (got["x"][0][ev[0:8]] == 0).all()
        np.testing.assert_allclose(got["y"][1], data[3:11])
    assert not (got["mask"] & got["eval_mask"]).any()


# -- GRIN -------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "bsr"])
def test_spatial_decoder_matches_jax(rng, mode):
    js, ts = _supports(rng, mode)
    h = rng.standard_normal((B, N, 6)).astype(np.float32)
    x, mask = _inputs(rng, (B, N, C))
    m = mask.astype(np.float32)
    jm, tm = JSpatialDecoder(C, 6), SpatialDecoder(C, 6)
    params = _carry(jm, tm, jnp.asarray(x), jnp.asarray(m), jnp.asarray(h),
                    js)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(m), jnp.asarray(h),
                    js)
    got = tm(torch.as_tensor(x), torch.as_tensor(m), torch.as_tensor(h), ts)
    for w, g in zip(want, got):
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("mode", ["dense", "bsr"])
@pytest.mark.parametrize("n_layers,n_nodes,layer_norm", [
    (1, N, False), (2, None, True)])
def test_gril_matches_jax(rng, mode, n_layers, n_nodes, layer_norm):
    js, ts = _supports(rng, mode)
    x, mask = _inputs(rng)
    kw = dict(n_layers=n_layers, n_nodes=n_nodes, layer_norm=layer_norm)
    jm, tm = JGRIL(C, 6, **kw), GRIL(C, 6, **kw)
    params = _carry(jm, tm, jnp.asarray(x), js, mask=jnp.asarray(mask))
    want = jm.apply(params, jnp.asarray(x), js, mask=jnp.asarray(mask))
    got = tm(torch.as_tensor(x), ts, mask=torch.as_tensor(mask))
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("mode", ["dense", "bsr"])
@pytest.mark.parametrize("merge_mode", ["mlp", "mean"])
def test_grin_matches_jax(rng, mode, merge_mode):
    js, ts = _supports(rng, mode)
    x, mask = _inputs(rng)
    kw = dict(n_nodes=N, n_layers=1, ff_size=8, merge_mode=merge_mode)
    jm, tm = JGRINModel(C, 6, **kw), GRINModel(C, 6, **kw)
    params = _carry(jm, tm, jnp.asarray(x), js, mask=jnp.asarray(mask))
    want = jm.apply(params, jnp.asarray(x), js, mask=jnp.asarray(mask))
    got = tm(torch.as_tensor(x), ts, mask=torch.as_tensor(mask))
    w_leaves, g_leaves = _leaves(want), _leaves(got)
    assert len(w_leaves) == len(g_leaves) == 5
    for w, g in zip(w_leaves, g_leaves):
        assert g.shape == w.shape and _rel(g, w) <= TOL
    assert np.isfinite(g_leaves[0].detach().numpy()).all()


def test_grin_registry_and_mask_needed():
    assert get_model_class("grin") is GRINModel
    assert get_model_class("rnni") is RNNImputerModel
    assert get_model_class("birnni") is BiRNNImputerModel
    tm = GRINModel(C, 4, n_nodes=N)
    with pytest.raises(ValueError, match="mask"):
        tm(torch.zeros(B, S, N, C), [])


# -- the RNN imputers -------------------------------------------------------

def _noise_draws(monkeypatch):
    """Record the JAX imputers' initial carries as they are drawn."""
    draws = []
    orig = JRNNI._init_carry

    def record(self, batch, dtype):
        out = orig(self, batch, dtype)
        draws.append(jax.tree.map(lambda a: torch.as_tensor(np.asarray(a)),
                                  out))
        return out
    monkeypatch.setattr(JRNNI, "_init_carry", record)
    return draws


RNNI_CASES = [(cell, indep, detach, init)
              for cell in ("gru", "lstm") for indep in (False, True)
              for detach, init in ((False, "zero"), (True, "noise"))]


@pytest.mark.parametrize("cell,indep,detach,init", RNNI_CASES)
def test_rnni_matches_jax(rng, monkeypatch, cell, indep, detach, init):
    x, mask = _inputs(rng, (B, S, 4, 3))
    kw = dict(cell=cell, n_nodes=4, process_nodes_independently=indep,
              detach_input=detach, state_init=init)
    jm, tm = JRNNI(3, 8, **kw), RNNImputerModel(3, 8, **kw)
    rngs = {"params": KEY, "state_init": jax.random.PRNGKey(5),
            "state_init_c": jax.random.PRNGKey(6)}
    params = _carry(jm, tm, jnp.asarray(x), jnp.asarray(mask), rngs=rngs)
    draws = _noise_draws(monkeypatch)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(mask),
                    return_hidden=True, rngs=rngs)
    got = tm(torch.as_tensor(x), torch.as_tensor(mask), return_hidden=True,
             state0=draws[0] if init == "noise" else None)
    for w, g in zip(want, got):
        assert g.shape == w.shape and _rel(g, w) <= TOL
    # causality: the prediction of step t reads the data up to t - 1
    x_b = torch.as_tensor(x).clone()
    x_b[:, 4:] = 99.0
    again = tm(x_b, torch.as_tensor(mask), state0=draws[0]
               if init == "noise" else None)
    torch.testing.assert_close(again[:, :5], got[0][:, :5], rtol=0, atol=0)


@pytest.mark.parametrize("cell,indep", [("gru", False), ("lstm", True)])
def test_birnni_matches_jax(rng, monkeypatch, cell, indep):
    x, mask = _inputs(rng, (B, S, 4, 3))
    kw = dict(cell=cell, n_nodes=4, process_nodes_independently=indep,
              state_init="noise", dropout=0.1)
    jm, tm = JBiRNNI(3, 8, **kw), BiRNNImputerModel(3, 8, **kw)
    rngs = {"params": KEY, "dropout": KEY,
            "state_init": jax.random.PRNGKey(5),
            "state_init_c": jax.random.PRNGKey(6)}
    params = _carry(jm, tm, jnp.asarray(x), jnp.asarray(mask), rngs=rngs)
    draws = _noise_draws(monkeypatch)
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(mask), rngs=rngs)
    tm.eval()                       # flax: deterministic without training
    got = tm(torch.as_tensor(x), torch.as_tensor(mask),
             state0=(draws[0], draws[1]))
    for w, g in zip(_leaves(want), _leaves(got)):
        assert g.shape == w.shape and _rel(g, w) <= TOL
    # the merge sees the future; the forward pass does not
    x_b = torch.as_tensor(x).clone()
    x_b[:, 4:] = 99.0
    merged_b, (fwd_b, _) = tm(x_b, torch.as_tensor(mask),
                              state0=(draws[0], draws[1]))
    torch.testing.assert_close(fwd_b[:, :5], got[1][0][:, :5], rtol=0,
                               atol=0)
    assert not torch.allclose(merged_b[:, :4], got[0][:, :4])


def test_rnni_noise_from_generator():
    tm = RNNImputerModel(1, 8, n_nodes=4, state_init="noise")
    x = torch.zeros(2, 5, 4, 1)
    m = torch.ones_like(x, dtype=torch.bool)
    a = tm(x, m, generator=torch.Generator().manual_seed(1))
    b = tm(x, m, generator=torch.Generator().manual_seed(1))
    c = tm(x, m, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)


# -- the trainer ------------------------------------------------------------

def _keep(rng_key, mask, whiten_prob):
    """JAX's whitening draw for a step's key (``jax.random.split(rng, 4)[0]``
    in ``make_imputer_train_step``)."""
    return np.asarray(jax.random.uniform(jax.random.split(rng_key, 4)[0],
                                         mask.shape) > whiten_prob)


@pytest.mark.parametrize("model_name,warm_up", [("grin", 0), ("grin", 2),
                                                ("rnni", 0), ("birnni", 1)])
def test_imputer_loss_and_gradients_match_jax(rng, model_name, warm_up):
    """One step of both trainers from the same weights with JAX's keep
    draw carried: the loss, then the updated weights (SGD at lr 1: the
    update is minus the gradient)."""
    x, mask = _inputs(rng, (B, S, N, C), p_obs=0.8)
    y = x + rng.standard_normal(x.shape).astype(np.float32)
    ev = (~mask) & (rng.random(x.shape) < 0.5)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y),
              "mask": jnp.asarray(mask), "eval_mask": jnp.asarray(ev)}
    tbatch = {k: torch.as_tensor(np.asarray(v)) for k, v in jbatch.items()}
    if model_name == "grin":
        js, ts = _supports(rng, "dense")
        jm, tm = JGRINModel(C, 6, n_nodes=N, ff_size=8), \
            GRINModel(C, 6, n_nodes=N, ff_size=8)
        params = _carry(jm, tm, jnp.asarray(x), js, mask=jnp.asarray(mask))

        def j_call(b, tr):
            return (b["x"], js), {"mask": b["mask"], "training": tr}

        def t_call(b, tr):
            return (b["x"], ts), {"mask": b["mask"], "training": tr}
    else:
        jcls, tcls = (JRNNI, RNNImputerModel) if model_name == "rnni" \
            else (JBiRNNI, BiRNNImputerModel)
        jm, tm = jcls(C, 6, n_nodes=N), tcls(C, 6, n_nodes=N)
        params = _carry(jm, tm, jnp.asarray(x), jnp.asarray(mask))

        def j_call(b, tr):
            return (b["x"], b["mask"]), {"training": tr}
        t_call = j_call
    key = jax.random.PRNGKey(7)
    step = j_make_step(jm, optax.sgd(1.0), j_call, whiten_prob=0.2,
                       prediction_loss_weight=0.5, warm_up=warm_up)
    new_params, _, j_loss = step(params, optax.sgd(1.0).init(params),
                                 jbatch, key)
    keep = torch.as_tensor(_keep(key, mask, 0.2))
    loss = t_imputer.imputer_loss(tm, tbatch, t_call, keep,
                                  prediction_loss_weight=0.5,
                                  warm_up=warm_up)
    assert abs(float(loss) - float(j_loss)) <= TOL * abs(float(j_loss))
    loss.backward()
    # the JAX update is -grad: grad = params - new_params, carried into a
    # copy of the model to line its leaves up with the port's parameters
    grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                         params, new_params)
    probe = flax_to_torch(grads, copy.deepcopy(tm))
    for (name, p), (_, g) in zip(tm.named_parameters(),
                                 probe.named_parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        assert float((got - g).abs().max()) <= \
            TOL_GRAD * max(float(g.abs().max()), 1e-6), name


def test_imputer_train_step_reduces_loss(rng):
    """``tests/test_zoo.py::test_imputer_step_rnni`` on the port: the RNN
    imputers (a bare tensor and a ``(merged, aux)`` output) take 30 Adam
    steps from JAX's initial weights with JAX's whitening draws carried;
    the losses follow JAX's (1e-4 relative: Adam steps in f32) and fall."""
    x = rng.standard_normal((4, 6, 4, 1)).astype(np.float32)
    mask = (rng.random((4, 6, 4, 1)) > 0.2).astype(np.float32)
    jbatch = {"x": jnp.asarray(x), "mask": jnp.asarray(mask)}
    tbatch = {"x": torch.as_tensor(x), "mask": torch.as_tensor(mask)}
    for jcls, tcls in ((JRNNI, RNNImputerModel),
                       (JBiRNNI, BiRNNImputerModel)):
        jm, tm = jcls(1, 8, n_nodes=4), tcls(1, 8, n_nodes=4)
        params = _carry(jm, tm, jnp.asarray(x), jnp.asarray(mask),
                        rngs={"params": jax.random.PRNGKey(0),
                              "dropout": jax.random.PRNGKey(1)})

        def call(b, training):
            return (b["x"], b["mask"]), {"training": training}
        opt = optax.adam(5e-3)
        j_step = j_make_step(jm, opt, call, whiten_prob=0.2)
        t_step = t_imputer.make_imputer_train_step(
            tm, torch.optim.Adam(tm.parameters(), lr=5e-3, eps=1e-8),
            call, whiten_prob=0.2, grad_clip=float("inf"))
        state, key = opt.init(params), jax.random.PRNGKey(7)
        j_losses, t_losses = [], []
        for _ in range(30):
            key, k = jax.random.split(key)
            params, state, loss = j_step(params, state, jbatch, k)
            j_losses.append(float(loss))
            keep = torch.as_tensor(_keep(k, mask, 0.2))
            t_losses.append(float(t_step(tbatch, keep)))
        np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
        assert np.mean(t_losses[-5:]) < np.mean(t_losses[:5])


def test_split_imputation_output():
    a, b, c = torch.zeros(1), torch.ones(1), torch.full((1,), 2.0)
    assert t_imputer.split_imputation_output(a) == (a, [])
    merged, aux = t_imputer.split_imputation_output((a, (b, c), (c, b)))
    assert merged is a and [t.item() for t in aux] == [1, 2, 2, 1]


# -- the runner -------------------------------------------------------------

RUN_BASE = ["--dataset-name", "synthetic", "--synthetic-nodes", "12",
            "--synthetic-steps", "200", "--epochs", "2", "--batches-epoch",
            "2", "--batch-size", "8", "--window", "12", "--p-noise", "0.15",
            "--seed", "0", "--patience", "5"]
METRICS = ("test_mae", "test_mse", "test_mre", "val_mae")


def _carried_runs(monkeypatch, argv):
    """The JAX runner, then the port's from the JAX run's initial weights
    and whitening draws."""
    params, keeps = [], []

    def j_wrapped(model, optimizer, to_call, whiten_prob=0.05, **kw):
        step = j_make_step(model, optimizer, to_call,
                           whiten_prob=whiten_prob, **kw)

        def record(p, opt_state, batch, key):
            if not params:
                params.append(jax.tree.map(np.asarray, p))
            keeps.append(_keep(key, batch["mask"], whiten_prob))
            return step(p, opt_state, batch, key)
        return record

    t_make = t_imputer.make_imputer_train_step

    def t_wrapped(model, optimizer, to_call, **kw):
        flax_to_torch(params[0], model)
        step = t_make(model, optimizer, to_call, **kw)
        draws = iter(keeps)
        return lambda batch: step(batch, torch.as_tensor(next(draws)))

    monkeypatch.setattr(j_run, "make_imputer_train_step", j_wrapped)
    monkeypatch.setattr(t_run, "make_imputer_train_step", t_wrapped)
    want = JExperiment(j_run.run_experiment,
                       j_run.configure_parser()).run(list(argv))
    got = Experiment(t_run.run_experiment, t_run.configure_parser()).run(
        list(argv) + ["--device", "cpu"])
    return want, got


RUN_CASES = [("grin", ["--hidden-size", "8", "--ff-size", "8"]),
             ("rnni", ["--hidden-size", "16", "--cell", "lstm"]),
             ("birnni", ["--hidden-size", "16",
                         "--process-nodes-independently"])]


@pytest.mark.parametrize("model,flags", RUN_CASES,
                         ids=[m for m, _ in RUN_CASES])
def test_runner_matches_jax_runner(monkeypatch, model, flags):
    argv = RUN_BASE + ["--model-name", model] + flags
    want, got = _carried_runs(monkeypatch, argv)
    assert set(got) == set(want)
    for k in METRICS:
        assert np.isfinite(got[k]) and np.isfinite(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=TOL_RUN, err_msg=k)
    print(f"{model}: test metrics max rel diff", max(
        abs(got[k] - want[k]) / abs(want[k]) for k in METRICS))


@pytest.mark.parametrize("model", ["grin", "rnni", "birnni"])
def test_runner_beats_the_trivial_bar(model):
    """``tests/test_runners.py``'s imputation runs on the port: 4 epochs
    of its own draws impute the hidden points below the trivial
    relative-error bar."""
    argv = list(RUN_BASE)
    argv[argv.index("--epochs") + 1] = "4"
    argv += ["--model-name", model, "--device", "cpu"] + (
        ["--hidden-size", "8", "--ff-size", "8"] if model == "grin"
        else ["--hidden-size", "16"])
    res = Experiment(t_run.run_experiment,
                     t_run.configure_parser()).run(argv)
    for k in METRICS:
        assert np.isfinite(res[k]), k
    assert res["test_mre"] < (0.9 if model == "grin" else 0.95)
