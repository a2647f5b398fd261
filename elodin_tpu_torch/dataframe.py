"""Minimal polars-compatible DataFrame used by ``Exec.history``.

The reference returns polars DataFrames (libs/nox-py/src/exec.rs:189-215).
polars is an optional dependency, so this module provides a small
columnar frame backed by numpy that covers the API surface the reference's
tests exercise (indexing, ``drop``, ``join on time``, ``to_numpy``,
equality); when polars *is* importable, ``history`` upgrades to real polars
frames via arrow.

A copy of ``elodin_tpu/dataframe.py``, kept in the port because importing
anything under ``elodin_tpu`` imports JAX.
"""

from __future__ import annotations

import numpy as np

try:  # pragma: no cover - exercised only where polars is installed
    import polars as _polars
except ImportError:  # pragma: no cover
    _polars = None


class ArrayValue(np.ndarray):
    """An element of an array column; adds polars' ``.to_numpy()``."""

    def to_numpy(self):
        return np.asarray(self)

    def to_list(self):
        return np.asarray(self).tolist()


def _as_elem(v):
    v = np.asarray(v)
    if v.ndim == 0:
        return v[()]
    return v.view(ArrayValue)


class Series:
    def __init__(self, name: str, values: np.ndarray):
        self.name = name
        self.values = np.asarray(values)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Series(self.name, self.values[i])
        return _as_elem(self.values[i])

    def __len__(self):
        return len(self.values)

    def __iter__(self):
        for i in range(len(self.values)):
            yield _as_elem(self.values[i])

    def to_numpy(self):
        return self.values

    def to_list(self):
        return self.values.tolist()

    def __eq__(self, other):
        return self.values == np.asarray(other)

    def __repr__(self):
        return f"Series({self.name!r}, {self.values!r})"


class DataFrame:
    """Column-major frame; vector components are (n_rows, k) arrays."""

    def __init__(self, data: dict | None = None, schema=None):
        self._cols: dict[str, np.ndarray] = {}
        for name, values in (data or {}).items():
            self._cols[name] = _normalize_column(values)

    # -- polars-compatible surface ----------------------------------------

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def __getitem__(self, name: str) -> Series:
        return Series(name, self._cols[name])

    def __len__(self) -> int:
        if not self._cols:
            return 0
        return len(next(iter(self._cols.values())))

    def drop(self, *names) -> "DataFrame":
        flat: list[str] = []
        for n in names:
            if isinstance(n, (list, tuple)):
                flat.extend(n)
            else:
                flat.append(n)
        out = DataFrame()
        out._cols = {k: v for k, v in self._cols.items() if k not in flat}
        return out

    def select(self, names) -> "DataFrame":
        if isinstance(names, str):  # polars accepts a bare column name
            names = [names]
        out = DataFrame()
        out._cols = {n: self._cols[n] for n in names}
        return out

    def join(self, other: "DataFrame", on: str = "time") -> "DataFrame":
        if not np.array_equal(self._cols[on], other._cols[on]):
            raise ValueError(f"join keys on {on!r} differ")
        out = DataFrame()
        out._cols = dict(self._cols)
        for k, v in other._cols.items():
            if k != on:
                out._cols[k] = v
        return out

    def to_dict(self, as_series: bool = True):
        if as_series:
            return {k: Series(k, v) for k, v in self._cols.items()}
        return {k: v.tolist() for k, v in self._cols.items()}

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(
            {
                k: (list(v) if v.ndim > 1 else v)
                for k, v in self._cols.items()
            }
        )

    def to_numpy(self):
        return np.column_stack(
            [v.reshape(len(self), -1) for v in self._cols.values()]
        )

    def write_parquet(self, path):
        import pyarrow.parquet as pq

        pq.write_table(self._to_arrow_table(), str(path))

    def write_csv(self, path):
        import csv

        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(self.columns)
            for i in range(len(self)):
                w.writerow(
                    [
                        v[i].tolist() if v.ndim > 1 else v[i]
                        for v in self._cols.values()
                    ]
                )

    def _to_arrow_table(self):
        import pyarrow as pa

        arrays = []
        names = []
        for k, v in self._cols.items():
            names.append(k)
            arr = pa.array(v.reshape(-1)) if v.ndim > 1 else pa.array(v)
            # a matrix cell (n, a, b) nests: b-lists inside a-lists
            for size in reversed(v.shape[1:]):
                arr = pa.FixedSizeListArray.from_arrays(arr, size)
            arrays.append(arr)
        return pa.table(dict(zip(names, arrays)))

    def to_polars(self):  # pragma: no cover
        if _polars is None:
            raise RuntimeError("polars is not installed")
        return _polars.from_arrow(self._to_arrow_table())

    def __repr__(self):
        head = ", ".join(f"{k}: {v.shape}" for k, v in self._cols.items())
        return f"DataFrame[{len(self)} rows; {head}]"

    def __eq__(self, other):
        if not isinstance(other, DataFrame):
            return NotImplemented
        return self._cols.keys() == other._cols.keys() and all(
            np.array_equal(self._cols[k], other._cols[k]) for k in self._cols
        )


def _normalize_column(values) -> np.ndarray:
    if isinstance(values, Series):
        return values.values
    arr = np.asarray(values)
    if arr.dtype == object:
        arr = np.stack([np.asarray(v) for v in values])
    return arr


def assert_frame_equal(a: DataFrame, b: DataFrame, rtol=1e-5, atol=1e-8):
    assert set(a.columns) == set(b.columns), (
        f"column mismatch: {a.columns} vs {b.columns}"
    )
    assert len(a) == len(b), f"row count mismatch: {len(a)} vs {len(b)}"
    for k in a.columns:
        va, vb = a._cols[k], b._cols[k]
        assert va.shape == vb.shape, f"{k}: shape {va.shape} vs {vb.shape}"
        if np.issubdtype(va.dtype, np.floating):
            np.testing.assert_allclose(va, vb, rtol=rtol, atol=atol, err_msg=k)
        else:
            assert np.array_equal(va, vb), f"{k}: values differ"
