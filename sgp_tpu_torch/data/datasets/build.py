"""Build-from-raw dataset pipelines on the host, without pandas.

Counterpart of ``sgp_tpu/data/datasets/build.py``, reading local raw files
(nothing is downloaded):

- METR-LA / PEMS-BAY: the sensor-distance CSV -> ``[n, n]`` distance
  matrix, with the ``csv`` module.
- CER-En: the ``File<i>.txt.zip`` archives of (id, datetime-code, load)
  rows -> the pivoted, merged, validated 30-minute frame, with ``zipfile``
  and numpy, reproducing the JAX build's pandas steps exactly.

Frames are ``(values [T, N], index datetime64[ns] [T], columns)`` triples.
HDF5 files are read and written in the h5py layout (a group holding
``values``, ``index`` as int64 nanoseconds and ``columns``), the layout
the JAX package writes where pytables is absent. A pandas/pytables-format
file raises: only the JAX package reads it. h5py is imported only inside
the functions that touch ``.h5`` files.
"""
from __future__ import annotations

import csv
import io
import os
from datetime import datetime, timedelta
from typing import List, Optional, Sequence
from zipfile import ZipFile

import numpy as np

H5_LAYOUT = ("the h5py layout: a group holding 'values' [T, N], 'index' "
             "(int64 nanoseconds) and optionally 'columns'")


def _h5py(path: str):
    try:
        import h5py
    except ImportError as err:
        raise ImportError(
            f"{path}: reading or writing .h5 files needs h5py, which is not "
            "installed") from err
    return h5py


# -- portable HDF5 frame IO (h5py layout) -----------------------------------


def save_frame_h5(path: str, values: np.ndarray, index: np.ndarray,
                  columns: Optional[Sequence] = None, key: str = "data"):
    """``values [T, N]`` + datetime64 index (+ column ids) -> HDF5."""
    h5py = _h5py(path)
    with h5py.File(path, "a") as f:
        if key in f:
            del f[key]
        grp = f.create_group(key)
        grp.create_dataset("values", data=np.asarray(values, np.float32))
        grp.create_dataset(
            "index", data=np.asarray(index, "datetime64[ns]").astype(np.int64))
        if columns is not None:
            cols = np.asarray(columns)
            if cols.dtype.kind in "UO":
                cols = cols.astype("S")
            grp.create_dataset("columns", data=cols)


def load_frame_h5(path: str, key: str = "data"):
    """Read the :func:`save_frame_h5` layout: ``(values, index, columns)``
    with bytes column ids decoded to str (``columns`` is None when the
    file has none). Raises ``ValueError`` on any other layout."""
    h5py = _h5py(path)
    with h5py.File(path, "r") as f:
        grp = f.get(key)
        if not isinstance(grp, h5py.Group) or "values" not in grp \
                or "index" not in grp:
            raise ValueError(
                f"{path}: key {key!r} is not in {H5_LAYOUT}, the only HDF5 "
                "layout the port reads (a pandas/pytables-format file is "
                "read only by the JAX package)")
        values = grp["values"][()]
        index = grp["index"][()].astype("datetime64[ns]")
        columns = grp["columns"][()] if "columns" in grp else None
    if columns is not None and columns.dtype.kind == "S":
        columns = columns.astype(str)
    return values, index, columns


def read_hdf_any(path: str, key: str = "data"):
    """The frame under ``key``, read from the h5py layout."""
    return load_frame_h5(path, key=key)


def reindex_rows(values: np.ndarray, index: np.ndarray,
                 grid: np.ndarray) -> np.ndarray:
    """``values`` rows moved onto ``grid`` (pandas' ``reindex``): a grid
    time found in ``index`` takes its row, any other NaN; rows off the
    grid are dropped. A duplicated timestamp raises, as pandas does."""
    order = np.argsort(index, kind="stable")
    idx = index[order]
    if len(idx) > 1 and (idx[1:] == idx[:-1]).any():
        raise ValueError("cannot reindex on an axis with duplicate labels")
    pos = np.minimum(np.searchsorted(idx, grid), max(len(idx) - 1, 0))
    found = idx[pos] == grid if len(idx) else np.zeros(len(grid), bool)
    out = np.full((len(grid),) + values.shape[1:], np.nan,
                  np.result_type(values.dtype, np.float32))
    out[found] = values[order[pos[found]]]
    return out


def time_grid(start, end, step: np.timedelta64) -> np.ndarray:
    """``pd.date_range(start, end, freq=step)`` as datetime64[ns]."""
    start = np.datetime64(start, "ns")
    step = np.timedelta64(step, "ns")
    n = (np.datetime64(end, "ns") - start) // step + 1
    return start + np.arange(n) * step


# -- METR-LA / PEMS-BAY distance matrix --------------------------------------


def build_distance_matrix(dist_csv: str, ids: Sequence[int],
                          out_npy: Optional[str] = None) -> np.ndarray:
    """Directed sensor-distance matrix from a (from, to, cost) CSV with a
    header row: ``inf`` where no entry; rows whose endpoints are not in
    ``ids`` are dropped (ids compare as numbers, as pandas' float rows do
    against the integer ids)."""
    num_sensors = len(ids)
    dist = np.full((num_sensors, num_sensors), np.inf, np.float32)
    sensor_to_ind = {int(s): i for i, s in enumerate(ids)}
    with open(dist_csv, newline="") as fp:
        rows = csv.reader(fp)
        next(rows, None)
        for row in rows:
            if not row:
                continue
            src, dst, cost = (float(v) for v in row[:3])
            if src not in sensor_to_ind or dst not in sensor_to_ind:
                continue
            dist[sensor_to_ind[src], sensor_to_ind[dst]] = cost
    if out_npy is not None:
        np.save(out_npy, dist)
    return dist


def read_sensor_ids(ids_txt: str) -> List[int]:
    """``sensor_ids_la.txt``: one comma-separated line of sensor ids."""
    with open(ids_txt) as f:
        return [int(s) for s in f.read().strip().split(",")]


# -- CER-En zip-archive build -------------------------------------------------

CER_START = datetime(2008, 12, 31, 0, 0)
CER_SAMPLES_PER_DAY = 48


def _cer_parse_date(code: int) -> datetime:
    """Day/slot code -> timestamp: ``code = day*100 + halfhour_slot``
    counted from 2008-12-31."""
    return CER_START + timedelta(days=int(code) // 100) \
        + timedelta(hours=0.5 * (int(code) % 100))


def _read_cer_rows(path: str) -> np.ndarray:
    """The first member of a CER zip: space-separated (id, datetime-code,
    load) rows -> ``[R, 3]`` float64."""
    with ZipFile(path) as zf, zf.open(zf.infolist()[0]) as fp:
        return np.loadtxt(io.TextIOWrapper(fp), delimiter=" ",
                          dtype=np.float64, ndmin=2).reshape(-1, 3)


def _pivot_mean(rows: np.ndarray):
    """``pd.pivot_table(values="load", index="datetime", columns="id")``:
    the mean of each (code, id) pair's loads in row order with pandas'
    compensated (Kahan) sum, codes and ids sorted, absent pairs NaN.
    Returns ``(table [codes, ids], codes, ids)``."""
    rows = rows[~np.isnan(rows[:, 2])]
    ids, id_of = np.unique(rows[:, 0].astype(np.int64), return_inverse=True)
    codes, code_of = np.unique(rows[:, 1].astype(np.int64),
                               return_inverse=True)
    cell = code_of * len(ids) + id_of
    order = np.argsort(cell, kind="stable")
    cell_s, load_s = cell[order], rows[order, 2]
    uniq, first, count = np.unique(cell_s, return_index=True,
                                   return_counts=True)
    total = np.zeros(len(uniq))
    comp = np.zeros(len(uniq))
    for k in range(int(count.max(initial=0))):
        live = count > k
        y = load_s[first[live] + k] - comp[live]
        t = total[live] + y
        c = t - total[live] - y
        comp[live] = np.where(np.isnan(c), 0.0, c)   # an infinite load
        total[live] = t
    table = np.full(len(codes) * len(ids), np.nan)
    table[uniq] = total / count
    return table.reshape(len(codes), len(ids)), codes, ids


def _merge_on_codes(left, right):
    """``pd.merge(left, right, on="datetime")`` of two pivots: the codes
    both hold, in the left's order; the left's columns, then the right's;
    a column label in both becomes ``<label>_x`` and ``<label>_y``."""
    (lv, lc, lcols), (rv, rc, rcols) = left, right
    pos = {c: i for i, c in enumerate(rc)}
    keep = np.array([c in pos for c in lc], bool)
    rows_r = np.array([pos[c] for c in lc[keep]], np.int64)
    both = set(lcols) & set(rcols)
    cols = ([f"{c}_x" if c in both else c for c in lcols]
            + [f"{c}_y" if c in both else c for c in rcols])
    if len(set(cols)) < len(cols):
        raise ValueError("merging the CER archives' columns gives duplicate "
                         f"labels {sorted({str(c) for c in cols if cols.count(c) > 1})}")
    values = np.concatenate([lv[keep], rv[rows_r]], axis=1)
    return values, lc[keep], cols


def read_cer_archives(root: str):
    """The CER-En frame from the ``File<i>.txt.zip`` archives in ``root``:
    pivot each zip's (id, datetime-code, load) rows, inner-merge the
    pivots in sorted file order, drop slot codes outside (0, 48], decode
    the timestamps and keep the first row of a duplicated one, cast to
    float32. Returns ``(values, index, columns)``."""
    zips = sorted(f for f in os.listdir(root) if f.endswith(".zip"))
    if not zips:
        raise FileNotFoundError(f"no CER zip archives in {root}")
    frames = []
    for name in zips:
        table, codes, ids = _pivot_mean(_read_cer_rows(
            os.path.join(root, name)))
        frames.append((table, codes, [int(i) for i in ids]))
    merged = frames[0]
    for right in frames[1:]:
        merged = _merge_on_codes(merged, right)
    values, codes, columns = merged
    ts = codes % 100
    keep = (ts > 0) & (ts <= CER_SAMPLES_PER_DAY)
    values, codes = values[keep], codes[keep]
    index = (np.datetime64(CER_START, "ns")
             + (codes // 100) * np.timedelta64(1, "D")
             + (codes % 100) * np.timedelta64(30, "m")).astype(
                 "datetime64[ns]")
    _, first = np.unique(index, return_index=True)
    first = np.sort(first)
    # the frame's column index holds the "datetime" label beside the ids
    # until that column is dropped, so it stays an object index: the ids
    # are saved as bytes
    return (values[first].astype(np.float32), index[first],
            np.array(columns, dtype=object))


def build_cer_en(root: str, out_name: str = "cer_en.h5"):
    """Build the CER-En frame from the archives in ``root``
    (:func:`read_cer_archives`) and write ``root/out_name`` in the h5py
    layout. Returns ``(values, index, columns)``."""
    values, index, columns = read_cer_archives(root)
    save_frame_h5(os.path.join(root, out_name), values, index, columns)
    return values, index, columns
