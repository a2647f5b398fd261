"""The port's telemetry store and its readers (``elodin_tpu_torch.db``:
storage, native, sql, eql, downsample, export; ``plotline``) against the
JAX package's, on the CPU, from inputs a numpy seed makes.

* A database directory written by either package reopens in the other
  with equal rows, timestamps, names, metadata, message logs and assets,
  through the native store (where a C compiler exists) and the Python
  one; a torn tail is cut back to the same rows in both.
* SQL, EQL (expressions and their SQL form), LTTB and the plotline
  samplers give the JAX package's results.
* The CSV export is byte for byte the JAX package's on
  ``tests/test_db_goldens.py``'s four cases (and the goldens).
"""

import os
import re
from pathlib import Path

import numpy as np
import pytest

import elodin_tpu.native as jnative
import elodin_tpu_torch.native as tnative
from elodin_tpu import plotline as jplotline
from elodin_tpu.db import downsample as jdown
from elodin_tpu.db import eql as jeql
from elodin_tpu.db import export as jexport
from elodin_tpu.db import sql as jsql
from elodin_tpu.db import storage as jstorage
from elodin_tpu.db.vtable import component_id_of
from elodin_tpu_torch import plotline as tplotline
from elodin_tpu_torch.db import downsample as tdown
from elodin_tpu_torch.db import eql as teql
from elodin_tpu_torch.db import export as texport
from elodin_tpu_torch.db import sql as tsql
from elodin_tpu_torch.db import storage as tstorage

STORAGE = {"jax": jstorage, "torch": tstorage}
NATIVE = {"jax": jnative, "torch": tnative}
GOLDENS = Path(__file__).parent / "goldens"

# (name, prim, shape) of the seeded database
SPECS = [("craft.pos", "f64", (3,)), ("craft.q", "f32", (4,)), ("craft.tick", "u64", ()),
         ("craft.mode", "i32", ()), ("craft.flags", "bool", (2,)), ("craft.m", "f64", (2, 3)),
         ("globals.dt", "f64", ())]


def _rows(prim, shape, n, rng):
    size = int(np.prod(shape)) if shape else 1
    if prim in ("f64", "f32"):
        return rng.normal(size=(n, size)).astype({"f64": "<f8", "f32": "<f4"}[prim])
    if prim == "bool":
        return rng.integers(0, 2, (n, size)).astype(bool)
    return rng.integers(0, 1000, (n, size)).astype({"u64": "<u8", "i32": "<i4"}[prim])


def _write(storage, path, seed):
    rng = np.random.default_rng(seed)
    db = storage.Database(str(path))
    for name, prim, shape in SPECS:
        store = db.get_or_create(component_id_of(name), prim, shape, name)
        store.set_metadata(metadata={"element_names": "", "seed": str(seed), "unit": name[-1]})
        n = int(rng.integers(5, 40))
        ts = np.cumsum(rng.integers(1, 1000, n)).astype(np.int64)
        vals = _rows(prim, shape, n, rng)
        half = n // 2
        store.append_batch(ts[:half], vals[:half])
        for t, v in zip(ts[half:], vals[half:]):
            store.append(int(t), v)
    log = db.msg_log(b"\x10\x20")
    for i in range(5):
        log.append(100 * i, rng.bytes(int(rng.integers(1, 30))))
    db.assets.put("schematic.kdl", b"viewport name=V\n")
    db.flush()
    return db


def _assert_same(a, b):
    assert sorted(a.components) == sorted(b.components)
    for cid, sa in a.components.items():
        sb = b.components[cid]
        assert (sa.name, sa.prim, sa.shape, sa.metadata, sa.len) == (
            sb.name, sb.prim, sb.shape, sb.metadata, sb.len)
        np.testing.assert_array_equal(sa.timestamps[:sa.len], sb.timestamps[:sb.len])
        np.testing.assert_array_equal(sa.values[:sa.len], sb.values[:sb.len])
    assert sorted(a.msg_logs) == sorted(b.msg_logs)
    for mid, la in a.msg_logs.items():
        assert la.entries == b.msg_logs[mid].entries
    assert sorted(a.assets.keys()) == sorted(b.assets.keys())
    assert a.assets.get("schematic.kdl") == b.assets.get("schematic.kdl")


@pytest.fixture(params=["native", "python"])
def engine(request, monkeypatch):
    if request.param == "native":
        if not (jnative.available() and tnative.available()):
            pytest.skip("no C compiler for the native store")
    else:
        for mod in NATIVE.values():
            monkeypatch.setattr(mod, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_database_reopens_in_the_other_package(tmp_path, engine, writer, reader):
    path = tmp_path / "db"
    wrote = _write(STORAGE[writer], path, seed=len(writer))
    reopened = STORAGE[reader].Database(str(path))
    _assert_same(wrote, reopened)
    # the reader appends; the writer's package reads the appended rows back
    store = reopened.components[component_id_of("craft.pos")]
    store.append(10**9, np.array([1.0, 2.0, 3.0]))
    reopened.flush()
    del reopened, store
    again = STORAGE[writer].Database(str(path)).components[component_id_of("craft.pos")]
    np.testing.assert_array_equal(again.values[again.len - 1], [1.0, 2.0, 3.0])
    assert again.timestamps[again.len - 1] == 10**9


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_torn_tail_is_cut_alike(tmp_path, engine, writer, reader):
    """A crash between the timestamp and data appends: both packages load
    the same intact prefix of the torn store."""
    path = tmp_path / "comp"
    store = STORAGE[writer].ComponentStore(123, "f64", (3,), "tt.v", path)
    for i in range(20):
        store.append(i * 100, np.array([i, i, i], dtype=np.float64))
    store.flush()
    del store
    if engine == "native":
        import struct

        with open(path / "timestamps.bin", "r+b") as f:  # ts one row ahead
            f.seek(8)
            committed = struct.unpack("<Q", f.read(8))[0]
            f.seek(8)
            f.write(struct.pack("<Q", committed + 8))
    else:
        data = path / "data.bin"
        with open(data, "r+b") as f:
            f.truncate(os.path.getsize(data) - 10)
    want = 20 if engine == "native" else 19
    copy = tmp_path / "copy"
    import shutil

    shutil.copytree(path, copy)
    ours = STORAGE[reader].ComponentStore.load(path)
    ref = STORAGE[writer].ComponentStore.load(copy)
    assert ours.len == ref.len == want
    np.testing.assert_array_equal(ours.values[:want], ref.values[:want])
    np.testing.assert_array_equal(ours.timestamps[:want], ref.timestamps[:want])


def _query_db(storage, seed=3):
    rng = np.random.default_rng(seed)
    db = storage.Database()
    pos = db.get_or_create(component_id_of("a.world_pos"), "f64", (7,), "a.world_pos")
    vel = db.get_or_create(component_id_of("a.world_vel"), "f64", (6,), "a.world_vel")
    x = db.get_or_create(component_id_of("a.x"), "f64", (), "a.x")
    y = db.get_or_create(component_id_of("b.y"), "f64", (), "b.y")
    x.metadata["element_names"] = ""
    q = rng.normal(size=(100, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    for i in range(100):
        t = i * 1000
        pos.append(t, np.concatenate([q[i], rng.normal(size=3) * 100]))
        vel.append(t, rng.normal(size=6))
        x.append(t, np.float64(rng.normal()))
        y.append(t + 500 * (i % 2), np.float64(i))
    return db


EQL = ["a.world_pos[4]", "a.world_pos.linear().norm()", "a.x * 2.0 + 1.0",
       "(a.world_pos[4] - a.world_pos[5]).abs()", "a.x.time_slice(0.0, 0.05)",
       "a.world_vel.linear()[0]", "-a.x", "a.world_pos.angular()",
       "a.world_pos.rotate_x(30.0)", "a.world_pos.translate(1.0, 2.0, 3.0)",
       "a.x.abs().sqrt().clip(0.1, 0.9)", "a.world_vel.linear().direction()",
       "a.x.fft()", "a.x.fftfreq()", "a.x.degrees().sign()"]


@pytest.mark.parametrize("expr", EQL)
def test_eql_matches(expr):
    try:
        want = jeql.eql(_query_db(jstorage), expr)
    except Exception as e:  # noqa: BLE001  (the port must refuse it alike)
        with pytest.raises(type(e)):
            teql.eql(_query_db(tstorage), expr)
        return
    got = teql.eql(_query_db(tstorage), expr)
    np.testing.assert_array_equal(got.time, want.time)
    assert got.label == want.label
    np.testing.assert_array_equal(got.values, want.values)
    try:
        want_sql = jeql.to_sql(_query_db(jstorage), expr)
    except ValueError as e:  # not SQL-expressible: the port says so alike
        with pytest.raises(ValueError, match=re.escape(str(e))):
            teql.to_sql(_query_db(tstorage), expr)
        return
    assert teql.to_sql(_query_db(tstorage), expr) == want_sql


SQL = ["SELECT * FROM a_x WHERE a_x > 0.5",
       "SELECT max(a_x) AS peak, count(*) AS n FROM a_x",
       "SELECT a_x.time, a_x, b_y FROM a_x JOIN b_y ON a_x.time = b_y.time",
       "SELECT * FROM a_x ASOF JOIN b_y ON a_x.time >= b_y.time",
       "SELECT count(*) AS n FROM a_world_pos GROUP BY time % 3000",
       "SELECT fft(a_x) FROM a_x",
       "select count(*) from A_X",
       "SELECT name FROM sqlite_master WHERE type = 'table' ORDER BY name",
       "SELECT * FROM no_such_table"]


@pytest.mark.parametrize("query", SQL)
def test_sql_matches(query):
    try:
        want = jsql.run_sql(_query_db(jstorage), query)
    except Exception as e:  # noqa: BLE001
        with pytest.raises(type(e)):
            tsql.run_sql(_query_db(tstorage), query)
        return
    got = tsql.run_sql(_query_db(tstorage), query)
    assert got.equals(want)


def test_sql_on_one_engine_matches():
    """Queries in turn on one database, whose sqlite mirror the port makes
    a table at a time as queries name them: every answer the JAX
    package's, the schema listing every store's table mid-way too."""
    ours, ref = _query_db(tstorage), _query_db(jstorage)
    for query in ("SELECT count(*) FROM a_x", "SELECT * FROM b_y LIMIT 3",
                  "SELECT name FROM sqlite_master WHERE type = 'table' ORDER BY name",
                  "SELECT count(*) FROM a_world_vel", "SELECT * FROM a_x JOIN b_y USING (time)"):
        assert tsql.run_sql(ours, query).equals(jsql.run_sql(ref, query)), query


@pytest.mark.parametrize("n,points", [(1000, 50), (10, 20), (500, 1), (3, 2)])
def test_lttb_matches(n, points):
    rng = np.random.default_rng(n)
    t = np.cumsum(rng.integers(1, 10, n)).astype(np.int64)
    v = rng.normal(size=n).cumsum()
    np.testing.assert_array_equal(tdown.lttb(t, v, points), jdown.lttb(t, v, points))


PLOTLINE = ["select_polyline2_indices", "select_time_value_indices",
            "select_polyline3_indices", "select_trajectory_time_norm_indices"]


@pytest.mark.parametrize("fn", PLOTLINE)
@pytest.mark.parametrize("seed", range(2))
def test_plotline_matches(fn, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 4 * np.pi, 400)
    noise = rng.normal(size=(400, 3)) * 0.01
    args = {
        "select_polyline2_indices": (np.stack([np.cos(t), np.sin(2 * t)], 1) + noise[:, :2], 40),
        "select_time_value_indices": (t, np.sin(t) + noise[:, 0], 40),
        "select_polyline3_indices": (np.stack([np.cos(t), np.sin(t), 0.1 * t], 1) + noise, 50),
        "select_trajectory_time_norm_indices": (t, np.stack([np.cos(t), np.sin(t), t], 1), 30),
    }[fn]
    np.testing.assert_array_equal(getattr(tplotline, fn)(*args), getattr(jplotline, fn)(*args))


# tests/test_db_goldens.py's fixtures, built through each package's store
GOLDEN_CASES = {
    "mono_us_flatten": ("full", dict(flatten=True, time_format="us")),
    "mono_ns_no_flatten": ("full", dict(flatten=False, time_format="ns")),
    "private_default_skips": ("private", dict(time_format="iso")),
    "private_include_overrides": ("private", dict(include_private=True, time_format="iso")),
}


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_csv_export_byte_for_byte(tmp_path, case):
    import test_db_goldens as goldens

    fixture, kwargs = GOLDEN_CASES[case]
    outs = {}
    for label, storage, export in (("jax", jstorage, jexport), ("torch", tstorage, texport)):
        root = tmp_path / label
        db = storage.Database(str(root / "db"))
        if fixture == "full":
            for name, prim, shape, elem in goldens.SPECS:
                store = db.get_or_create(component_id_of(name), prim, shape, name)
                if elem:
                    store.set_metadata(metadata={"element_names": elem})
                for step in range(goldens.NUM_ROWS):
                    store.append(goldens.TS_BASE + goldens.TS_STEP * step,
                                 goldens._sample(name, prim, shape, step))
        else:
            pub = db.get_or_create(component_id_of("public_scalar"), "f64", (), "public_scalar")
            sec = db.get_or_create(component_id_of("secret_scalar"), "f64", (), "secret_scalar")
            sec.set_metadata(metadata={"private": "true"})
            for step in range(goldens.NUM_ROWS):
                ts = goldens.TS_BASE + goldens.TS_STEP * step
                pub.append(ts, np.float64(step).tobytes())
                sec.append(ts, np.float64(step + 100.0).tobytes())
        db.flush()
        export.save_archive(db, str(root / "out"), "csv", **kwargs)
        outs[label] = {p.name: p.read_bytes() for p in sorted((root / "out").glob("*.csv"))}
    assert outs["torch"] == outs["jax"] and outs["torch"]
    snap = goldens._snapshot(tmp_path / "torch" / "out", case)
    assert snap == (GOLDENS / f"csv_export_{case}.golden").read_text()
