"""Archive export: per-component files in arrow/parquet/csv
(parity: libs/db save_archive + export CLI, src/export.rs).

A host-only copy of ``elodin_tpu/db/export.py``:
the port imports nothing of the JAX package.  pyarrow is imported only for
the Arrow and Parquet formats: the CSV export needs none.
"""

from __future__ import annotations

from pathlib import Path


def _arrow_table(store) -> pa.Table:
    import pyarrow as pa

    n = store.len
    time = pa.array(store.timestamps[:n], type=pa.timestamp("us"))
    values = store.values[:n]
    name = store.name or f"{store.component_id:016x}"
    if store.elem_count == 1:
        data = pa.array(values[:, 0])
    else:
        data = pa.FixedSizeListArray.from_arrays(
            pa.array(values.reshape(-1)), store.elem_count
        )
    return pa.table({"time": time, name: data})


def _is_private(store) -> bool:
    """Components flagged `metadata={"private": "true"}` are skipped on
    export unless explicitly included (src/export.rs:752-855)."""
    return str(store.metadata.get("private", "")).lower() == "true"


def _csv_float(v, positional_only: bool = False) -> str:
    """Rust-parity float formatting (src/export.rs writes through ryu for
    flattened cells and Display for bracketed arrays — the byte format the
    reference csv-export goldens pin down)."""
    import math

    import numpy as np

    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "inf" if f > 0 else "-inf"
    if positional_only:
        # Display style: integral floats print bare ("0"), never exponent.
        return np.format_float_positional(v, trim="-")
    a = abs(f)
    if f == 0.0 or 1e-5 <= a < 1e16:
        return np.format_float_positional(v, trim="0")
    # ryu exponent form: no zero-padded exponent ("1e-7", not "1e-07")
    s = np.format_float_scientific(v, trim="0")
    mant, exp = s.split("e")
    if mant.endswith(".0"):
        mant = mant[:-2]
    return f"{mant}e{int(exp)}"


def _csv_cell(v, fast_floats: bool, positional_only: bool = False) -> str:
    import numpy as np

    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (float, np.floating)):
        if fast_floats:
            return f"{float(v):.9g}"
        return _csv_float(v, positional_only)
    return str(v)


def _iso_time(us: int) -> str:
    from datetime import datetime, timezone

    dt = datetime.fromtimestamp(us / 1e6, tz=timezone.utc)
    base = dt.strftime("%Y-%m-%dT%H:%M:%S")
    if us % 1_000_000:
        return base + f".{us % 1_000_000:06d}".rstrip("0")
    return base


def _write_csv(store, path, name: str, flatten: bool, time_format: str,
               fast_floats: bool) -> None:
    import csv as _csv

    n = store.len
    ts = store.timestamps[:n]
    if time_format == "ns":
        tcol, tvals = "time_ns", [str(int(t) * 1000) for t in ts]
    elif time_format == "iso":
        tcol, tvals = "time", [_iso_time(int(t)) for t in ts]
    else:
        tcol, tvals = "time_us", [str(int(t)) for t in ts]

    cols: dict[str, list[str]] = {tcol: tvals}
    vals = store.values[:n]
    is_bool = str(store.metadata.get("prim_type", "")) == "bool" or (
        getattr(vals, "dtype", None) is not None and vals.dtype.kind == "b"
    )

    def cell(v):
        if is_bool:
            return "true" if v else "false"
        return _csv_cell(v, fast_floats)

    if store.elem_count == 1:
        cols[name] = [cell(v) for v in vals[:, 0]]
    elif flatten:
        labels = (store.metadata.get("element_names") or "").split(",")
        for i in range(store.elem_count):
            label = labels[i] if i < len(labels) and labels[i] else str(i)
            cols[f"{name}_{label}"] = [cell(v) for v in vals[:, i]]
    else:
        def list_cell(v):
            if is_bool:
                return "true" if v else "false"
            return _csv_cell(v, fast_floats, positional_only=True)

        cols[name] = [
            "[" + ", ".join(list_cell(v) for v in row) + "]" for row in vals
        ]

    with open(path, "w", newline="") as f:
        w = _csv.writer(f)
        w.writerow(cols.keys())
        for row in zip(*cols.values()):
            w.writerow(row)


def save_archive(db, path: str, fmt: str = "arrow_ipc",
                 include_private: bool = False, pattern: str | None = None,
                 flatten: bool = True, mono_ns: bool = False,
                 fast_floats: bool = False,
                 time_format: str | None = None) -> None:
    """Export every component series (src/export.rs options: name glob
    pattern, per-element flatten, ns vs us timestamps, fast float
    formatting — the knobs behind the reference csv-export goldens)."""
    import fnmatch

    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    _seen: set[str] = set()
    for store in db.components.values():
        if store.len == 0:
            continue
        if _is_private(store) and not include_private:
            continue
        if pattern and not fnmatch.fnmatch(
            store.name or f"{store.component_id:016x}", pattern
        ):
            continue
        name = store.name or f"{store.component_id:016x}"
        # duplicate display names (distinct ids) must not silently
        # overwrite each other's output files
        if name in _seen:
            name = f"{name}.{store.component_id:016x}"
        _seen.add(name)
        if fmt in ("arrow", "arrow_ipc"):
            import pyarrow.ipc as ipc

            table = _arrow_table(store)
            with ipc.new_file(str(out / f"{name}.arrow"), table.schema) as w:
                w.write_table(table)
        elif fmt in ("parquet", "pq"):
            import pyarrow.parquet as pq

            pq.write_table(_arrow_table(store), str(out / f"{name}.parquet"))
        elif fmt == "csv":
            _write_csv(
                store, out / f"{name}.csv", name, flatten,
                time_format or ("ns" if mono_ns else "us"), fast_floats,
            )
        else:
            raise ValueError(f"unknown archive format {fmt!r}")


def export_mcap(db, path: str) -> int:
    """Whole-DB single-file MCAP export (libs/db/src/export_mcap.rs);
    see elodin_tpu_torch.db.export_mcap for the writer."""
    from .export_mcap import export_mcap as _impl

    return _impl(db, path)


def export_csv_joined(db, out_path: str,
                      include_private: bool = False) -> None:
    """Single wide CSV joined on time (export.rs --join mode)."""
    import pandas as pd

    frames = []
    seen_names: dict[str, int] = {}
    for store in db.components.values():
        if store.len == 0:
            continue
        if _is_private(store) and not include_private:
            continue
        n = store.len
        name = store.name or f"{store.component_id:016x}"
        # two stores sharing a display name (distinct ids) would make the
        # pandas join raise on overlapping columns — disambiguate by id
        if name in seen_names:
            name = f"{name}.{store.component_id:016x}"
        seen_names[name] = store.component_id
        data = {"time": store.timestamps[:n]}
        if store.elem_count == 1:
            data[name] = store.values[:n, 0]
        else:
            for i in range(store.elem_count):
                data[f"{name}[{i}]"] = store.values[:n, i]
        frames.append(pd.DataFrame(data).set_index("time"))
    if not frames:
        return
    df = frames[0].join(frames[1:], how="outer")
    df.to_csv(out_path)
