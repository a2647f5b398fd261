"""SQL queries over component time-series — sqlite3-backed engine.

The reference embeds DataFusion with Arrow IPC results and FFT UDFs
(libs/db/src/arrow/mod.rs).  DataFusion isn't available here; instead every
component store is registered as a real table in an in-memory sqlite
database (incrementally appended under ``db.lock``), giving full SQL:
multi-table JOINs, GROUP BY, subqueries, aggregates, ORDER BY/LIMIT.  On
top of sqlite we add the reference's domain extensions:

* ``table ASOF JOIN other ON a.time >= b.time``-style joins are expressed
  with the rewrite ``a ASOF JOIN b`` -> nearest-preceding-row join on the
  ``time`` column (DataFusion's as-of pattern for telemetry alignment).
* ``fft(col)`` / ``fftfreq(col, rate_hz)`` projections (whole-column
  transforms, computed with numpy after the relational part runs).

``time`` columns are INTEGER epoch microseconds, matching the wire format.
Results return as a pyarrow Table for Arrow-IPC framing.  The user query
runs with ``PRAGMA query_only=ON`` — there is no writable surface and no
``eval`` anywhere.

A host-only copy of ``elodin_tpu/db/sql.py``:
the port imports nothing of the JAX package.  pyarrow is imported where a
table is made, so importing this module (the client does) needs none.  The
sqlite mirror makes a store's table when a query first names it (the JAX
package's makes every table at the first query).
"""

from __future__ import annotations

import re
import sqlite3
import threading

import numpy as np


def sanitize_sql_table_name(name: str) -> str:
    """(libs/db/src/arrow/mod.rs:35-46)."""
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _element_columns(store) -> list[str]:
    """Column names for one store, matching the reference's arrow schema:
    the bare sanitized name for scalars, name_<element> for shaped."""
    base = sanitize_sql_table_name(store.name or f"c_{store.component_id:x}")
    if store.elem_count == 1:
        return [base]
    labels = (store.metadata.get("element_names") or "").split(",")
    cols = []
    for i in range(store.elem_count):
        label = labels[i] if i < len(labels) and labels[i] else str(i)
        cols.append(f"{base}_{sanitize_sql_table_name(label)}")
    return cols


def component_table(store) -> pa.Table:
    """time + value columns as a pyarrow table (export/test helper)."""
    import pyarrow as pa

    n = store.len
    cols: dict[str, pa.Array] = {
        "time": pa.array(store.timestamps[:n], type=pa.timestamp("us"))
    }
    values = store.values[:n]
    for i, name in enumerate(_element_columns(store)):
        cols[name] = pa.array(values[:, i])
    return pa.table(cols)


class _SqlEngine:
    """In-memory sqlite mirror of the component stores, appended
    incrementally (rows already mirrored are never re-copied)."""

    def __init__(self):
        self.conn = sqlite3.connect(":memory:", check_same_thread=False)
        self.loaded: dict[int, int] = {}  # component_id -> rows mirrored
        self.tables: dict[str, int] = {}  # table name -> component_id
        self.lock = threading.Lock()
        # math UDFs for EQL-compiled queries (older sqlite builds lack the
        # -DSQLITE_ENABLE_MATH_FUNCTIONS set; registering is idempotent)
        import math

        for name, fn, n in (
            ("sqrt", math.sqrt, 1),
            ("pow", math.pow, 2),
            ("atan2", math.atan2, 2),
            ("acos", math.acos, 1),
            ("degrees", math.degrees, 1),
            ("radians", math.radians, 1),
            ("sign", lambda x: (x > 0) - (x < 0), 1),
        ):
            try:
                self.conn.create_function(name, n, fn, deterministic=True)
            except sqlite3.OperationalError:
                pass

    def sync(self, db, words: set[str] | None = None) -> None:
        """Mirror the stores' new rows; with ``words`` (a query's
        identifiers, lower case), only the stores whose tables it names: a
        table is made, and costs sqlite a schema change, when a query
        first names it."""
        with self.lock:
            # snapshot under db.lock (cheap numpy copies only), then build
            # the sqlite mirror with the lock RELEASED — holding db.lock
            # through per-row conversion + executemany over a large backlog
            # would stall the sim thread's commit_batch for the duration
            pending = []
            with db.lock:
                for store in list(db.components.values()):
                    name = sanitize_sql_table_name(
                        store.name or f"c_{store.component_id:x}"
                    )
                    if words is not None and name.lower() not in words:
                        continue
                    n = store.len
                    done = self.loaded.get(store.component_id)
                    cols = (
                        _element_columns(store) if done is None else None
                    )
                    start = done or 0
                    if done is None or n > start:
                        pending.append((
                            name, store.component_id, cols, start, n,
                            store.timestamps[start:n].copy(),
                            store.values[start:n].copy(),
                        ))
            for name, cid, cols, done, n, ts, vals in pending:
                if cols is not None:
                    decls = ", ".join(f'"{c}" REAL' for c in cols)
                    self.conn.execute(
                        f'CREATE TABLE IF NOT EXISTS "{name}" '
                        f"(time INTEGER, {decls})"
                    )
                    self.conn.execute(
                        f'CREATE INDEX IF NOT EXISTS "idx_{name}_time" '
                        f'ON "{name}" (time)'
                    )
                    self.tables[name] = cid
                if n > done:
                    width = vals.shape[1]
                    rows = np.empty((n - done, width + 1), dtype=np.float64)
                    rows[:, 0] = ts
                    rows[:, 1:] = vals
                    ph = ", ".join(["?"] * (width + 1))
                    self.conn.executemany(
                        f'INSERT INTO "{name}" VALUES ({ph})',
                        [
                            (int(r[0]), *map(float, r[1:]))
                            for r in rows
                        ],
                    )
                self.loaded[cid] = n
            self.conn.commit()


_ASOF_RE = re.compile(
    # an explicit DataFusion-style `ON a.time >= b.time` clause is accepted
    # and consumed: the engine always applies nearest-predecessor-on-time
    # semantics, and leaving the user clause in place would emit TWO ON
    # clauses (a sqlite syntax error)
    r"\bASOF\s+JOIN\s+(?P<table>[A-Za-z0-9_]+)(?:\s+(?:AS\s+)?"
    r"(?P<alias>(?!ON\b|WHERE\b|GROUP\b|ORDER\b|LIMIT\b|USING\b)"
    r"[A-Za-z0-9_]+))?"
    r"(?:\s+ON\s+(?P<on>.*?))?"
    r"(?=\s+(?:WHERE|GROUP|ORDER|LIMIT|LEFT|JOIN|ASOF)\b|\s*;|\s*$)",
    re.IGNORECASE | re.DOTALL,
)

_FFT_RE = re.compile(
    r"(?:\bfft\s*\(\s*(?P<col>[A-Za-z0-9_\.]+)\s*\)|"
    r"\bfftfreq\s*\(\s*(?P<fcol>[A-Za-z0-9_\.]+)\s*"
    r"(?:,\s*(?P<rate>[0-9eE\.\+\-]+))?\s*\))"
    r"(?:\s+AS\s+(?P<alias>[A-Za-z0-9_]+))?",
    re.IGNORECASE,
)


def _rewrite_asof(query: str, base_table: str | None) -> str:
    """``a ASOF JOIN b`` -> LEFT JOIN on the nearest b.time <= a.time.

    Implemented as a correlated-subquery equality join, which sqlite
    executes with the time index (DataFusion as-of semantics for aligning
    telemetry streams sampled at different rates)."""

    def sub(m: re.Match) -> str:
        table = m.group("table")
        alias = m.group("alias") or table
        left = base_table or ""
        cond = (
            f'"{alias}".time = (SELECT MAX("__b".time) FROM "{table}" "__b" '
            f'WHERE "__b".time <= {left}.time)'
        )
        as_clause = f' "{alias}"' if alias != table else ""
        return f'LEFT JOIN "{table}"{as_clause} ON {cond}'

    return _ASOF_RE.sub(sub, query)


def _base_table(query: str) -> str | None:
    m = re.search(r"\bFROM\s+([A-Za-z0-9_]+)(?:\s+(?:AS\s+)?"
                  r"(?!ASOF\b|JOIN\b|WHERE\b|GROUP\b|ORDER\b|LIMIT\b|ON\b)"
                  r"([A-Za-z0-9_]+))?", query, re.IGNORECASE)
    if not m:
        return None
    return f'"{m.group(2) or m.group(1)}"'


_SCHEMA_TABLES = {"sqlite_master", "sqlite_schema", "sqlite_temp_master",
                  "sqlite_temp_schema"}


def run_sql(db, query: str) -> pa.Table:
    import pyarrow as pa

    # explicit allow-list: PRAGMA query_only stops writes to the mirror,
    # but e.g. ATTACH DATABASE can still create files on disk — only
    # read-only query forms may run at all
    head = re.match(r"\s*([A-Za-z]+)", query or "")
    if not head or head.group(1).upper() not in (
        "SELECT", "WITH", "EXPLAIN", "VALUES",
    ):
        raise ValueError(
            "SQL error: only read-only queries (SELECT/WITH/EXPLAIN) are "
            "allowed"
        )
    engine: _SqlEngine | None = getattr(db, "_sql_engine", None)
    if engine is None:
        engine = _SqlEngine()
        db._sql_engine = engine
    # a query reads only the tables it names, but the schema tables list
    # every one
    words = {w.lower() for w in re.findall(r"[A-Za-z0-9_]+", query)}
    engine.sync(db, None if words & _SCHEMA_TABLES else words)

    # fft/fftfreq projections: strip them from the SELECT list, run the
    # relational query, then post-process the named columns with numpy
    fft_specs: list[tuple[str, str, str, float | None]] = []

    def note_fft(m: re.Match) -> str:
        # the raw signal is selected AS the spec's label (honoring a
        # user-provided `AS alias`), so the post-pass can find its column
        # by result name even through aliased projections
        if m.group("col"):
            col = m.group("col")
            label = m.group("alias") or f"fft_{col.split('.')[-1]}"
            fft_specs.append(("fft", col, label, None))
        else:
            col = m.group("fcol")
            rate = float(m.group("rate")) if m.group("rate") else None
            label = m.group("alias") or f"fftfreq_{col.split('.')[-1]}"
            fft_specs.append(("fftfreq", col, label, rate))
        return f"{col} AS {label}"

    rewritten = _FFT_RE.sub(note_fft, query)
    rewritten = _rewrite_asof(rewritten, _base_table(rewritten))

    with engine.lock:
        engine.conn.execute("PRAGMA query_only=ON")
        try:
            cur = engine.conn.execute(rewritten)
            if cur.description is None:  # BEGIN/PRAGMA: no result set
                return pa.table({"empty": pa.array([])})
            names = [d[0] for d in cur.description]
            rows = cur.fetchall()
        except sqlite3.Error as e:
            raise ValueError(f"SQL error: {e}") from e
        finally:
            engine.conn.execute("PRAGMA query_only=OFF")

    # joins can project same-named columns from two tables; keying a dict
    # by raw name would silently drop all but the last — suffix duplicates
    seen: dict[str, int] = {}
    uniq_names = []
    for name in names:
        k = seen.get(name, 0)
        seen[name] = k + 1
        uniq_names.append(name if k == 0 else f"{name}_{k + 1}")

    columns: dict[str, pa.Array] = {}
    data = list(zip(*rows)) if rows else [[] for _ in names]
    for orig, name, values in zip(names, uniq_names, data):
        if orig == "time" or orig.endswith(".time"):
            # ASOF LEFT JOIN yields NULL times for rows preceding every
            # right-side row — keep them as nulls, don't TypeError
            columns[name] = pa.array(
                [None if v is None else int(v) for v in values],
                type=pa.timestamp("us"),
            )
        else:
            columns[name] = pa.array(list(values))

    if fft_specs:
        out: dict[str, pa.Array] = {}
        consumed = set()
        for kind, col, label, rate in fft_specs:
            # the raw signal was projected AS the label (see note_fft) —
            # look it up by result name; `is None` because an empty
            # pyarrow array is falsy and a zero-row result is still valid
            src = columns.get(label)
            if src is None:
                src = columns.get(col.split(".")[-1])
            if src is None:
                raise ValueError(f"fft source column {col!r} not in result")
            consumed.add(label)
            sig = np.asarray(src.to_pylist(), dtype=np.float64)
            if kind == "fft":
                out[label] = pa.array(np.abs(np.fft.rfft(sig)))
            else:
                if rate is None:
                    ts = columns.get("time")
                    if ts is not None and len(ts) > 1:
                        t = ts.cast(pa.int64()).to_numpy()
                        rate = 1e6 / float(np.median(np.diff(t)))
                    else:
                        rate = 1.0
                out[label] = pa.array(np.fft.rfftfreq(len(sig), d=1.0 / rate))
        # keep any non-fft projections alongside
        for name, arr in columns.items():
            if name not in consumed and name not in out:
                out[name] = arr
        n_max = max(len(a) for a in out.values())
        out = {
            k: (v if len(v) == n_max
                else pa.concat_arrays([
                    v.cast(v.type),
                    pa.nulls(n_max - len(v), v.type),
                ]))
            for k, v in out.items()
        }
        return pa.table(out)

    return pa.table(columns) if columns else pa.table({"empty": pa.array([])})
