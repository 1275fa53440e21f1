"""The port's dataset loaders against the JAX package's, on raw fixtures.

Each fixture is built in ``tmp_path`` as ``tests/test_dataset_build.py``
builds its own (h5py-layout frames, the distance CSV, the CER zip
archives, a gzipped MTS table), with the cases where a numpy rewrite of
pandas drifts: rows missing from the 5-minute grid, rows out of order and
one off the grid, zeros and NaNs, a column with no valid entry, duplicated
CER rows (up to three, summed by pandas' compensated sum), slot codes 0,
49 and 50, a code missing from one archive, a meter in two archives (two
columns, ``_x`` and ``_y``), a day missing from every archive, east
duplicates in PV-US, zones on different indexes. Target, mask, index,
distances, columns and metadata order are held bit for bit, in both
directions: the port reads what the JAX package wrote, and the JAX package
reads what the port wrote. The similarities on these datasets are held at
1e-6 (``test_torch_port_similarities.py`` holds the functions).

Also: ``get_dataset`` returns the loaders; a missing file raises naming
it; a pytables-format file and a missing h5py raise naming what the port
reads; the default similarity method is the JAX package's in the same
process; and one runner per dataset name through ``get_dataset`` with
both packages' ``data_dir`` on the fixtures, held at TOL_RUN.
"""
import gzip
import os
import sys
from zipfile import ZipFile

import numpy as np
import pytest
import torch

from sgp_tpu.data.datasets import build as j_build
from sgp_tpu.data.datasets.cer_en import CEREn as JCEREn
from sgp_tpu.data.datasets.metr_la import MetrLA as JMetrLA
from sgp_tpu.data.datasets.mts_benchmarks import \
    ExchangeBenchmark as JExchange
from sgp_tpu.data.datasets.pems_bay import PemsBay as JPemsBay
from sgp_tpu.data.datasets.pv_us import PvUS as JPvUS
from sgp_tpu.exp.common import get_dataset as j_get_dataset
from sgp_tpu.utils.config import config as jax_config

from sgp_tpu_torch.data.datasets import (CEREn, ExchangeBenchmark, MetrLA,
                                         PemsBay, PvUS)
from sgp_tpu_torch.data.datasets import build as t_build
from sgp_tpu_torch.exp.common import get_dataset
from sgp_tpu_torch.graph.similarities import correntropy
from sgp_tpu_torch.utils.config import config as torch_config

from test_torch_port_runner import (BASE, RUN, TOL_RUN, _carry_jax_run,
                                    _jax, _port)
import test_torch_port_traffic_sgp as traffic

torch.set_num_threads(1)

TOL_SIM = 1e-6
FIVE = np.timedelta64(5, "m")
HALF_HOUR = np.timedelta64(30, "m")
WRITERS = {"jax": j_build.save_frame_h5, "port": t_build.save_frame_h5}


@pytest.fixture(autouse=True)
def _logs(tmp_path, monkeypatch):
    monkeypatch.setitem(torch_config, "logs_dir", str(tmp_path / "log_t"))
    monkeypatch.setattr(jax_config, "logs_dir", str(tmp_path / "log_j"))


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _close_correntropy(got, want, kw, gamma=0.05):
    """The weekly-window correntropy of both packages against the same
    formula in float64 on the same f32-standardized input, and against
    each other, within f32's own rounding at this period: ``sq_i``,
    ``sq_j`` and ``2 x_i . x_j`` each round by up to ``eps * S`` (S the
    largest sum of squares over a window, ~200-500 at 336 half-hours), so
    ``exp(-gamma d2)`` moves by up to ``4 gamma eps S``; the bound is twice
    that. Measured on the PV fixture: the port 6.2e-9 from float64 (it
    reads ``sq`` off the Gram's diagonal), the JAX package 1.3e-5 (on the
    diagonal, where its separate sum of squares rounds another way);
    ``test_torch_port_similarities.py`` holds the function to JAX's at
    1e-6 at short periods."""
    t_sim = got.compute_similarity("correntropy", device="cpu", **kw)
    j_sim = want.compute_similarity("correntropy", **kw)
    x, mask = got.target[..., 0], None
    if isinstance(got, CEREn):
        x, mask = x * got.mask[..., 0], got.mask[..., 0]
        if "train_slice" in kw:
            x, mask = got.target[kw["train_slice"], :, 0], \
                mask[kw["train_slice"]]
    x = (x - x.mean()) / x.std()      # in f32, as the JAX package
    period = int(np.timedelta64(7, "D") / (got.index[1] - got.index[0]))
    exact = correntropy(x.astype(np.float64), period, mask=mask,
                        device="cpu")
    n_win = (len(x) - 1) // period
    s_max = (x[:n_win * period] ** 2).reshape(n_win, period, -1).sum(
        1).max()
    tol = 8 * gamma * np.finfo(np.float32).eps * s_max
    for sim in (t_sim, j_sim):
        np.testing.assert_allclose(sim, exact, rtol=0, atol=tol)
    np.testing.assert_allclose(t_sim, j_sim, rtol=0, atol=tol)


def _same_dataset(got, want):
    for name in ("target", "mask", "index"):
        _equal(getattr(got, name), getattr(want, name))


# -- METR-LA / PEMS-BAY ------------------------------------------------------


def _traffic_frame(rng, ids, t, start="2012-03-01T00:00"):
    """``t`` 5-minute rows with the loaders' trap cases, shuffled."""
    index = np.datetime64(start, "ns") + np.arange(t) * FIVE
    values = (rng.random((t, len(ids))) * 60 + 1).astype(np.float32)
    values[3:6, 0] = 0.0                  # zeros, filled forward
    values[:2, 1] = 0.0                   # leading zeros, filled backward
    values[10, 2] = np.nan                # a NaN reading
    values[:, -1] = 0.0                   # a column with no valid entry
    keep = np.ones(t, bool)
    keep[20:23] = False                   # rows missing from the grid
    index = index.copy()
    index[30] += np.timedelta64(2, "m")   # a row off the grid
    perm = rng.permutation(np.nonzero(keep)[0])
    return values[perm], index[perm]


def _write_traffic(root, rng, writer, h5_name, csv_name, ids, t,
                   ids_txt=None):
    os.makedirs(root, exist_ok=True)
    values, index = _traffic_frame(rng, ids, t)
    WRITERS[writer](os.path.join(root, h5_name), values, index, list(ids))
    rows = ["from,to,cost"] + [f"{a},{b},{rng.random() * 9:.4f}"
                               for a in ids for b in ids
                               if rng.random() < 0.6]
    rows.append(f"{ids[0]},999,1.5")      # an endpoint not in the ids
    with open(os.path.join(root, csv_name), "w") as fp:
        fp.write("\n".join(rows) + "\n")
    if ids_txt:
        with open(os.path.join(root, ids_txt), "w") as fp:
            fp.write(",".join(str(i) for i in ids))


@pytest.mark.parametrize("writer", list(WRITERS))
def test_metr_la_matches_jax(tmp_path, writer):
    ids = [773869, 767541, 767542, 717447, 717446]
    for who in ("jax", "port"):
        _write_traffic(str(tmp_path / who), np.random.default_rng(0),
                       writer, "metr_la.h5", "distances_la.csv", ids, 80,
                       "sensor_ids_la.txt")
    want = JMetrLA(root=str(tmp_path / "jax"))
    got = MetrLA(root=str(tmp_path / "port"))
    _same_dataset(got, want)
    _equal(got.dist, want.dist)
    _equal(np.load(tmp_path / "port" / "metr_la_dist.npy"),
           np.load(tmp_path / "jax" / "metr_la_dist.npy"))
    _equal(got.compute_similarity("distance"),
           want.compute_similarity("distance"))
    assert not got.mask[:, -1].any() and (got.target[:, -1] == 0).all()
    assert np.isinf(got.dist).any()


@pytest.mark.parametrize("mask_zeros", [True, False])
def test_pems_bay_matches_jax(tmp_path, mask_zeros):
    ids = [400001, 400017, 400030, 400040]
    for who, writer in (("jax", "port"), ("port", "jax")):
        _write_traffic(str(tmp_path / who), np.random.default_rng(1),
                       writer, "pems_bay.h5", "distances_bay.csv", ids, 60)
    want = JPemsBay(root=str(tmp_path / "jax"), mask_zeros=mask_zeros)
    got = PemsBay(root=str(tmp_path / "port"), mask_zeros=mask_zeros)
    _same_dataset(got, want)
    _equal(got.dist, want.dist)
    assert got.numpy() is got.target


def test_duplicated_timestamp_raises_in_both(tmp_path):
    ids = [1, 2]
    index = np.datetime64("2012-03-01T00:00", "ns") + np.arange(6) * FIVE
    index[3] = index[2]
    t_build.save_frame_h5(str(tmp_path / "metr_la.h5"),
                          np.ones((6, 2), np.float32), index, ids)
    np.save(tmp_path / "metr_la_dist.npy", np.zeros((2, 2), np.float32))
    for cls in (JMetrLA, MetrLA):
        with pytest.raises(ValueError, match="duplicate"):
            cls(root=str(tmp_path))


def test_missing_files_raise_naming_them(tmp_path):
    for cls, name in ((MetrLA, "metr_la.h5"), (PemsBay, "pems_bay.h5"),
                      (PvUS, "east.h5"), (CEREn, "cer_en.h5"),
                      (ExchangeBenchmark, "exchange_rate")):
        with pytest.raises(FileNotFoundError, match=name):
            cls(root=str(tmp_path))


def test_pytables_file_and_missing_h5py_raise(tmp_path, monkeypatch):
    import h5py
    path = str(tmp_path / "metr_la.h5")
    with h5py.File(path, "w") as f:   # pandas' fixed format's datasets
        grp = f.create_group("data")
        grp.create_dataset("axis0", data=np.arange(2))
        grp.create_dataset("block0_values", data=np.ones((3, 2)))
    with pytest.raises(ValueError, match="h5py layout"):
        t_build.read_hdf_any(path)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py.*") as err:
        t_build.load_frame_h5(path)
    assert path in str(err.value)


def test_build_distance_matrix_matches_jax(tmp_path):
    (tmp_path / "ids.txt").write_text("101,202,303")
    (tmp_path / "d.csv").write_text(
        "from,to,cost\n101,202,5.0\n202,101,7.25\n303,303,0.0\n"
        "101,999,1.0\n202,303,0.1\n")
    ids = t_build.read_sensor_ids(str(tmp_path / "ids.txt"))
    assert ids == j_build.read_sensor_ids(str(tmp_path / "ids.txt"))
    _equal(t_build.build_distance_matrix(str(tmp_path / "d.csv"), ids),
           j_build.build_distance_matrix(str(tmp_path / "d.csv"), ids))


# -- CER-En ------------------------------------------------------------------


def _cer_rows(rng, meters, days, drop_code=None):
    """Space-separated rows of ``meters`` over ``days`` (slots 1..48 plus
    the DST codes 49/50 and the invalid slot 0), some pairs duplicated,
    some absent, in shuffled order."""
    rows = []
    for day in days:
        for slot in [0] + list(range(1, 51)):
            code = day * 100 + slot
            if code == drop_code:
                continue
            for m in meters:
                if rng.random() < 0.02:
                    continue                      # an absent pair
                for _ in range(1 + (rng.random() < 0.05)
                               + (rng.random() < 0.02)):
                    rows.append(f"{m} {code} {rng.random() * 3:.3f}")
    return [rows[i] for i in rng.permutation(len(rows))]


def _write_cer(root, seed=0, days=None):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    days = list(range(200, 215)) if days is None else days
    days = [d for d in days if d != 207]          # a day in no archive
    archives = {"File1.txt.zip": ([1000, 1001, 1002], None),
                "File2.txt.zip": ([1003, 1001], days[len(days) // 2] * 100 + 17),
                "File3.txt.zip": ([1004, 1005], None)}
    for name, (meters, drop) in archives.items():
        with ZipFile(os.path.join(root, name), "w") as zf:
            zf.writestr(name[:-4], "\n".join(_cer_rows(rng, meters, days,
                                                       drop)))


def test_build_cer_en_matches_jax(tmp_path):
    _write_cer(str(tmp_path))
    want = j_build.build_cer_en(str(tmp_path), out_name="jax.h5")
    values, index, columns = t_build.build_cer_en(str(tmp_path),
                                                  out_name="port.h5")
    _equal(values, want.values)
    # pandas keeps the decoded timestamps at microseconds; both files hold
    # nanoseconds
    _equal(index, want.index.values.astype("datetime64[ns]"))
    assert list(columns) == list(want.columns)
    assert "1001_x" in list(columns) and "1001_y" in list(columns)
    # the code dropped from File2, the day in no archive and the slots
    # outside (0, 48] are gone
    assert len(index) <= 14 * 48 - 1
    got = t_build.load_frame_h5(str(tmp_path / "port.h5"))
    ref = t_build.load_frame_h5(str(tmp_path / "jax.h5"))
    for a, b in zip(got, ref):
        _equal(a, b)


def test_pivot_means_duplicates_as_pandas(tmp_path):
    import pandas as pd
    rng = np.random.default_rng(3)
    rows = np.stack([rng.integers(0, 3, 400), rng.integers(0, 5, 400),
                     rng.random(400) * 1e3 + rng.random(400) * 1e-9],
                    axis=1)
    table, codes, ids = t_build._pivot_mean(rows)
    frame = pd.DataFrame(rows, columns=["id", "datetime", "load"])
    frame[["id", "datetime"]] = frame[["id", "datetime"]].astype(np.int64)
    want = pd.pivot_table(frame, values="load", index=["datetime"],
                          columns=["id"])
    _equal(table, want.values)
    _equal(codes, want.index.values)
    _equal(ids, want.columns.values)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cer_en_loads_as_jax(tmp_path, writer):
    for who in ("jax", "port"):
        _write_cer(str(tmp_path / who))
    build = {"jax": j_build.build_cer_en, "port": t_build.build_cer_en}
    for who in ("jax", "port"):
        build[writer](str(tmp_path / who))   # one writer, both readers
    want = JCEREn(root=str(tmp_path / "jax"))
    got = CEREn(root=str(tmp_path / "port"))
    _same_dataset(got, want)
    assert (~got.mask).any()                  # the day in no archive
    train = np.arange(got.n_steps // 2 + 30)
    np.testing.assert_allclose(
        got.compute_similarity("pearson", device="cpu"),
        want.compute_similarity("pearson"), rtol=0, atol=TOL_SIM)
    for kw in ({}, {"train_slice": train}):
        _close_correntropy(got, want, kw)


def test_cer_en_builds_from_zips_on_demand(tmp_path):
    _write_cer(str(tmp_path), days=list(range(100, 103)))
    got = CEREn(root=str(tmp_path))
    assert os.path.exists(tmp_path / "cer_en.h5")
    assert got.target.shape[1:] == (7, 1)
    frame = CEREn.from_arrays(*t_build.load_frame_h5(
        str(tmp_path / "cer_en.h5"))[:2])
    _same_dataset(frame, got)


# -- PV-US -------------------------------------------------------------------


def _write_pv(root, writer, seed=0, west_short=False, t=700):
    import h5py
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    index = np.datetime64("2006-01-01T00:00", "ns") + np.arange(t) \
        * HALF_HOUR
    day = np.clip(np.sin(2 * np.pi * np.arange(t) / 48), 0, None)
    zones = {"east": ["p10", "p2-east", "p3", "p21"],
             "west": ["p2", "p4", "p1", "p33"]}
    for zone, plants in zones.items():
        zi = index[:-3] if (west_short and zone == "west") else index
        vals = (day[:len(zi), None] * (1 + rng.random(len(plants)))
                + 0.3 * rng.standard_normal((len(zi), len(plants)))
                ).clip(0).astype(np.float32)
        path = os.path.join(root, f"{zone}.h5")
        WRITERS[writer](path, vals, zi, plants, key="actual")
        with h5py.File(path, "a") as f:
            grp = f.create_group("metadata")
            grp.create_dataset("plant_id", data=np.asarray(plants, "S"))
            grp.create_dataset("lat", data=30 + rng.random(len(plants)) * 10)
            grp.create_dataset("lon", data=-120 + rng.random(len(plants))
                               * 30)
            grp.create_dataset("state_id", data=np.asarray(
                [p.replace("p", "CA-") for p in plants], "S"))


@pytest.mark.parametrize("writer,mask_zeros,zones", [
    ("jax", True, None), ("port", False, None), ("port", True, "west")])
def test_pv_us_matches_jax(tmp_path, writer, mask_zeros, zones):
    for who in ("jax", "port"):
        _write_pv(str(tmp_path / who), writer)
    want = JPvUS(root=str(tmp_path / "jax"), mask_zeros=mask_zeros,
                 zones=zones)
    got = PvUS(root=str(tmp_path / "port"), mask_zeros=mask_zeros,
               zones=zones)
    _same_dataset(got, want)
    # pandas holds the strings in its own dtype: compared as lists
    assert got.metadata["plant_id"].tolist() == list(want.metadata.index)
    for col in want.metadata.columns:
        ref = np.asarray(want.metadata[col].values)
        if ref.dtype == object:
            assert got.metadata[col].tolist() == list(ref)
        else:
            _equal(got.metadata[col], ref)
    _equal(got.compute_similarity("distance"),
           want.compute_similarity("distance"))
    _close_correntropy(got, want, {})
    if zones is None:
        assert "p2-east" not in list(got.plants)


def test_pv_us_zones_on_different_indexes(tmp_path):
    _write_pv(str(tmp_path), "port", west_short=True)
    want, got = JPvUS(root=str(tmp_path)), PvUS(root=str(tmp_path))
    _same_dataset(got, want)
    assert np.isnan(got.target).any() == np.isnan(want.target).any()


# -- the MTS benchmarks ------------------------------------------------------


def test_exchange_benchmark_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.standard_normal((300, 8)), 0) * 0.01 + 1
    with gzip.open(tmp_path / "exchange_rate.txt.gz", "wt") as fp:
        np.savetxt(fp, x, delimiter=",", fmt="%.6f")
    want = JExchange(root=str(tmp_path))
    got = ExchangeBenchmark(root=str(tmp_path))
    _same_dataset(got, want)
    sim = got.compute_similarity("pearson", device="cpu")
    np.testing.assert_allclose(sim, want.compute_similarity("pearson"),
                               rtol=0, atol=TOL_SIM)
    assert (np.diag(sim) == 0).all() and (sim >= 0).all()


# -- get_dataset, the default method and the runners -------------------------


def test_default_similarity_method_is_jax_in_process():
    """The options are a set: the method ``get_similarity(None)`` takes
    depends on the process's string hashes, and is the same in both
    packages within one process."""
    for t_cls, j_cls in ((PvUS, JPvUS), (CEREn, JCEREn)):
        assert t_cls.similarity_options == j_cls.similarity_options
        assert next(iter(t_cls.similarity_options)) == \
            next(iter(j_cls.similarity_options))


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setitem(torch_config, "data_dir", str(tmp_path / "data"))
    monkeypatch.setitem(jax_config, "data_dir", str(tmp_path / "data"))
    return tmp_path / "data"


def test_get_dataset_returns_the_loaders(data_dir):
    _write_traffic(str(data_dir / "MetrLA"), np.random.default_rng(0),
                   "jax", "metr_la.h5", "distances_la.csv", [1, 2, 3], 40,
                   "sensor_ids_la.txt")
    _write_traffic(str(data_dir / "PemsBay"), np.random.default_rng(1),
                   "jax", "pems_bay.h5", "distances_bay.csv", [4, 5, 6], 40)
    _write_pv(str(data_dir / "PvUS"), "jax")
    _write_cer(str(data_dir / "CEREn"), days=list(range(100, 103)))
    for name, cls in (("la", MetrLA), ("bay", PemsBay), ("pv", PvUS),
                      ("cer", CEREn)):
        got, want = get_dataset(name), j_get_dataset(name)
        assert type(got) is cls
        _same_dataset(got, want)
    assert get_dataset("bay").mask_zeros and get_dataset("pv").mask_zeros
    bay = (get_dataset("bay"), j_get_dataset("bay"))
    g = bay[0].get_connectivity(knn=2, include_self=False, device="cpu")
    jg = bay[1].get_connectivity(knn=2, include_self=False)
    _equal(g.to_dense(), np.asarray(jg.to_dense()))


def _metr_la_span(root):
    """METR-LA's span, 2012-03-01 to 2012-06-27, on 4 sensors, so that the
    paper's ``AtTimeStepSplitter`` timestamps exist."""
    rng = np.random.default_rng(7)
    t = int((np.datetime64("2012-06-28") - np.datetime64("2012-03-01"))
            / FIVE)
    day = np.sin(2 * np.pi * np.arange(t) / 288)[:, None]
    values = (50 + 10 * day + rng.standard_normal((t, 4))).astype(
        np.float32)
    values[rng.random(values.shape) < 0.01] = 0.0
    index = np.datetime64("2012-03-01", "ns") + np.arange(t) * FIVE
    os.makedirs(root, exist_ok=True)
    t_build.save_frame_h5(os.path.join(root, "metr_la.h5"), values, index,
                          [11, 22, 33, 44])
    np.save(os.path.join(root, "metr_la_dist.npy"), np.array(
        [[0, 1, 4, np.inf], [1, 0, 2, 5], [3, 2, 0, 1], [np.inf, 6, 1, 0]],
        np.float32))


def test_la_through_the_traffic_sgp_runner(data_dir, monkeypatch):
    _metr_la_span(str(data_dir / "MetrLA"))
    argv = traffic.BASE + ["--dataset-name", "la", "--epochs", "2"]
    traffic._carry(monkeypatch)
    want, got = traffic._jax(argv), traffic._port(argv)
    np.testing.assert_allclose(got["test_mae"], want["test_mae"],
                               rtol=TOL_RUN)


@pytest.mark.parametrize("name", ["pv", "cer"])
def test_pv_cer_through_the_largescale_runner(data_dir, monkeypatch, name):
    if name == "pv":
        _write_pv(str(data_dir / "PvUS"), "jax")
    else:
        _write_cer(str(data_dir / "CEREn"))
    argv = BASE + RUN + ["--dataset-name", name]
    want = _jax(argv)
    _carry_jax_run(monkeypatch, seed=0)
    got = _port(argv)
    assert np.isfinite(got["test_mae"])
    np.testing.assert_allclose(got["test_mae"], want["test_mae"],
                               rtol=TOL_RUN)
