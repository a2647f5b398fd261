"""The port's ``Exec`` served into its telemetry database
(``Exec(db_path=)``, ``db.server.serve_exec``, ``restore_from_db``,
``World.run`` with ``ELODIN_DB_PATH`` / ``ELODIN_RESUME``), against the
JAX package's on the CPU.

* A free body (``tests/test_db.py::test_exec_db_integration``'s world) and
  ``build_nbody(8, seed=2)`` on the plain path are served by each
  package, both ``Exec``s' history start pinned to one datetime: every
  stored series within 1e-12 relative (max |Δ| / max |ref|), its
  timestamps, names and metadata equal exactly.
* ``restore_from_db`` of the JAX sim's database resumes the port's sim at
  the same tick with the same state.
* External control over the wire, the writes coming from the server's
  thread while another thread steps the loop: no write is lost and every
  tick integrates the thrust it read.
* ``World.run`` with ``ELODIN_DB_PATH``, then ``ELODIN_RESUME=1``, against
  one uninterrupted run of each package.
* A SIGKILL of ``python -m elodin_tpu_torch run`` while it serves: the
  database reopens intact, in both packages.
"""

import datetime
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import typing as ty
from dataclasses import dataclass, field

import numpy as np
import pytest
import torch
from jax import numpy as jnp

import elodin_tpu as jel
import elodin_tpu_torch as tel
from elodin_tpu.db.server import serve_exec as jserve
from elodin_tpu.db.storage import Database as JDatabase
from elodin_tpu.models import nbody as jnb
from elodin_tpu_torch.db.server import serve_exec as tserve
from elodin_tpu_torch.db.storage import Database as TDatabase
from elodin_tpu_torch.examples.three_body import main as ttb
from elodin_tpu_torch.models import nbody as tnb
from torch_port_util import float_policy, jax_example

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = datetime.datetime(2026, 1, 2, 3, 4, 5, 678901, tzinfo=datetime.timezone.utc)
TOL = 1e-12


@pytest.fixture(autouse=True)
def _f64():
    with float_policy("f64"):
        yield


def _free_body(el, arr):
    w = el.World()
    w.spawn(el.Body(world_vel=el.SpatialMotion(linear=arr([1.0, 0.5, -0.25]))), "craft")
    return w, el.six_dof(1.0 / 60.0), 120.0


def _nbody(nb):
    return nb.build_nbody(8, seed=2), nb.build_system(60.0, use_kernel=True), 1.0 / 60.0


WORLDS = {
    "free_body": (lambda: _free_body(jel, jnp.array),
                  lambda: _free_body(tel, lambda v: torch.tensor(v, dtype=torch.float64)), 30),
    "nbody": (lambda: _nbody(jnb), lambda: _nbody(tnb), 20),
}


def _serve(make, serve, path, ticks, **kw):
    world, system, rate = make()
    exec_ = world.build(system, simulation_rate=rate, db_path=str(path), **kw)
    exec_._history.start_timestamp = START
    srv = serve(exec_, "127.0.0.1:0")
    try:
        exec_.run(ticks)
        exec_.flush_telemetry()
    finally:
        srv.stop()
    return exec_


def _assert_same_db(ours, ref, tol=TOL):
    assert sorted(ours.components) == sorted(ref.components)
    for cid, r in ref.components.items():
        o = ours.components[cid]
        assert (o.name, o.prim, o.shape, o.metadata, o.len) == (
            r.name, r.prim, r.shape, r.metadata, r.len), r.name
        np.testing.assert_array_equal(o.timestamps[:o.len], r.timestamps[:r.len], err_msg=r.name)
        ov, rv = o.values[:o.len], r.values[:r.len]
        if rv.dtype.kind == "f":
            scale = float(np.max(np.abs(rv))) or 1.0
            assert float(np.max(np.abs(ov - rv))) / scale <= tol, r.name
        else:
            np.testing.assert_array_equal(ov, rv, err_msg=r.name)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_served_series_match_the_jax_package(tmp_path, world):
    jmake, tmake, ticks = WORLDS[world]
    jexec = _serve(jmake, jserve, tmp_path / "jax", ticks)
    texec = _serve(tmake, tserve, tmp_path / "torch", ticks, device="cpu")
    ours, ref = TDatabase(str(tmp_path / "torch")), JDatabase(str(tmp_path / "jax"))
    _assert_same_db(ours, ref)
    start_us = int(START.timestamp() * 1e6)
    assert all(s.len == ticks + 1 and s.timestamps[0] == start_us for s in ours.components.values())
    # the stored rows are the history the port's Exec kept, bitwise
    for q in texec._history.column_names():
        comp, row = texec._history.resolve(q)
        store = ours.by_name(q)
        np.testing.assert_array_equal(
            store.values[:store.len].reshape(texec._history.series(comp)[:, row].shape),
            texec._history.series(comp)[:, row], err_msg=q)
    assert texec.tick() == jexec.tick() == ticks


def test_restore_from_the_jax_database(tmp_path):
    jmake, tmake, _ = WORLDS["free_body"]
    jexec = _serve(jmake, jserve, tmp_path / "jax", 10)
    world, system, rate = tmake()
    texec = world.build(system, simulation_rate=rate, device="cpu")
    assert texec.restore_from_db(TDatabase(str(tmp_path / "jax"))) == len(texec.meta.components)
    assert texec.tick() == jexec.tick() == 10
    for k in texec.meta.components:
        np.testing.assert_array_equal(texec.column_array(k), np.asarray(jexec.column_array(k)),
                                      err_msg=k)
        assert texec.cols[k].device.type == "cpu"
    assert texec.cols["tick"].dtype == torch.int64
    jexec.run(5)
    texec.run(5)
    for k in texec.meta.components:
        ref = np.asarray(jexec.column_array(k))
        got = texec.column_array(k)
        if ref.dtype.kind == "f":
            assert np.max(np.abs(got - ref)) <= TOL * (np.max(np.abs(ref)) or 1.0), k
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)


def _wire_world():
    Thrust = ty.Annotated[torch.Tensor, tel.Component(
        "wire_thrust", tel.ComponentType(tel.PrimitiveType.F64, ()),
        metadata={"external_control": "true"})]
    Vel = ty.Annotated[torch.Tensor, tel.Component(
        "wire_vel", tel.ComponentType(tel.PrimitiveType.F64, ()))]

    @dataclass
    class Craft(tel.Archetype):
        wire_thrust: Thrust = field(default_factory=lambda: np.float64(0.0))
        wire_vel: Vel = field(default_factory=lambda: np.float64(0.0))

    @tel.system
    def integrate(q: tel.Query[Thrust, Vel]) -> tel.Query[Vel]:
        return q.map(Vel, lambda t, v: v + t)

    w = tel.World()
    w.spawn(Craft(), "craft")
    return w, integrate


def test_external_control_from_the_server_thread_while_stepping(tmp_path):
    """A client writes ``wire_thrust`` 40 times while another thread steps
    the loop; the server's thread queues each write (as host numpy) and the
    loop applies it before its next tick.  No write is lost (the last is
    the final thrust) and every tick integrated the thrust its row holds."""
    w, system = _wire_world()
    exec_ = w.build(system, db_path=str(tmp_path / "db"), device="cpu")
    srv = tserve(exec_, "127.0.0.1:0")
    stop = threading.Event()
    errors = []

    def step():
        try:
            while not stop.is_set():
                exec_.run(1)
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    stepper = threading.Thread(target=step, daemon=True)
    try:
        stepper.start()
        client = tel.db.Client.connect(f"127.0.0.1:{srv.port}")
        writer = client.table_writer({"craft.wire_thrust": tel.db.f64})
        values = [float(v) for v in np.random.default_rng(5).integers(1, 100, 40)]
        for i, v in enumerate(values):
            writer.write(timestamp_us=10 + i, values={"craft.wire_thrust": v})
            time.sleep(0.002)
        deadline = time.time() + 10
        while float(exec_.read_component("craft.wire_thrust")[0]) != values[-1]:
            assert time.time() < deadline, "the last write never reached the Exec"
            time.sleep(0.005)
        time.sleep(0.05)
        writer.close()
        client.close()
    finally:
        stop.set()
        stepper.join(timeout=10)
        sys.setswitchinterval(interval)
        srv.stop()
    assert not stepper.is_alive() and not errors
    exec_.run(2)  # the thread that steps changes: the pending write, if any, applies
    frame = exec_.history_frame(["craft.wire_thrust", "craft.wire_vel"])
    thrust = np.asarray(frame["craft.wire_thrust"]).reshape(-1)
    vel = np.asarray(frame["craft.wire_vel"]).reshape(-1)
    assert thrust[-1] == values[-1]
    assert set(thrust.tolist()) <= set(values) | {0.0}
    np.testing.assert_array_equal(vel[1:], vel[:-1] + thrust[1:])


def _latest_rows(db, meta):
    id_to_name = {eid: m.name for eid, m in meta.entity_metadata.items()}
    out = {}
    for comp, ids in meta.comp_entities.items():
        rows = []
        for eid in ids:
            q = f"{id_to_name[eid]}.{comp}" if id_to_name.get(eid) else f"{eid}.{comp}"
            rows.append(db.by_name(q).latest()[1])
        out[comp] = np.stack(rows)
    return out


def test_world_run_with_a_database_then_resumed(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [ttb.__file__, "run", "127.0.0.1:0", "--device", "cpu"])
    monkeypatch.setenv("ELODIN_DB_PATH", str(tmp_path / "db"))
    monkeypatch.setenv("ELODIN_MAX_TICKS", "20")
    first = ttb.build_world().run(ttb.build_system(), simulation_rate=1.0 / ttb.SIM_TIME_STEP)
    assert first.tick() == 20
    manifest = tmp_path / "db" / "simulation_source" / "manifest.json"
    assert manifest.is_file()
    monkeypatch.setenv("ELODIN_RESUME", "1")
    monkeypatch.setenv("ELODIN_MAX_TICKS", "40")
    resumed = ttb.build_world().run(ttb.build_system(), simulation_rate=1.0 / ttb.SIM_TIME_STEP)
    assert resumed.tick() == 40
    ref = ttb.build_world().build(ttb.build_system(), simulation_rate=1.0 / ttb.SIM_TIME_STEP,
                                  device="cpu")
    ref.run(40)
    jr = jax_example("three-body", "main")
    jref = jr.w.build(jr.sys, simulation_rate=1.0 / ttb.SIM_TIME_STEP)
    jref.run(40)
    stored = _latest_rows(TDatabase(str(tmp_path / "db")), ref.meta)
    for comp, rows in stored.items():
        want = ref.column_array(comp)
        np.testing.assert_array_equal(rows.reshape(want.shape).astype(want.dtype), want,
                                      err_msg=comp)
        jwant = np.asarray(jref.column_array(comp))
        if jwant.dtype.kind == "f":
            assert np.max(np.abs(want - jwant)) <= TOL * (np.max(np.abs(jwant)) or 1.0), comp
        else:
            np.testing.assert_array_equal(want, jwant, err_msg=comp)
    assert TDatabase(str(tmp_path / "db")).by_name("a.world_pos").len == 2 * 21


def test_a_resumed_run_keeps_its_rows_whatever_the_first_runs_leftovers(tmp_path, monkeypatch):
    """Two ``World.run`` calls on one database in one process, the second
    resumed, with the garbage collector held off until both are done (its
    timing is not the program's to choose): the first run's database must
    not outlive it, or its stores' close, when the collector gets to them,
    cuts the files they share back to the first run's length.  The
    resumed run's rows are all there on reopening."""
    import gc

    from elodin_tpu_torch import native

    monkeypatch.setattr(sys, "argv", [ttb.__file__, "run", "127.0.0.1:0", "--device", "cpu"])
    monkeypatch.setenv("ELODIN_DB_PATH", str(tmp_path / "db"))
    monkeypatch.setenv("ELODIN_MAX_TICKS", "20")
    gc.disable()
    try:
        ttb.build_world().run(ttb.build_system(), simulation_rate=1.0 / ttb.SIM_TIME_STEP)
        monkeypatch.setenv("ELODIN_RESUME", "1")
        monkeypatch.setenv("ELODIN_MAX_TICKS", "40")
        resumed = ttb.build_world().run(ttb.build_system(),
                                        simulation_rate=1.0 / ttb.SIM_TIME_STEP)
        assert resumed.tick() == 40
    finally:
        gc.enable()
    del resumed
    gc.collect()
    db = TDatabase(str(tmp_path / "db"))
    assert native.available() == (db.by_name("a.world_pos")._native is not None)
    for name in ("a.world_pos", "Globals.tick"):
        assert db.by_name(name).len == 2 * 21, name
    assert int(db.by_name("Globals.tick").latest()[1].reshape(-1)[0]) == 40


SIGKILL_SIM = """
import typing as ty
from dataclasses import dataclass, field

import numpy as np
import torch

import elodin_tpu_torch as el

V = ty.Annotated[torch.Tensor, el.Component("kv", el.ComponentType(el.PrimitiveType.F64, ()))]


@dataclass
class T(el.Archetype):
    kv: V = field(default_factory=lambda: np.float64(0.0))


@el.system
def bump(q: el.Query[V]) -> el.Query[V]:
    return q.map(V, lambda v: v + 1.0)


w = el.World()
w.spawn(T(), "t")
w.run(bump, simulation_rate=120.0, generate_real_time=True)
"""


def test_db_survives_sigkill_of_a_served_run(tmp_path):
    sim = tmp_path / "sim.py"
    sim.write_text(textwrap.dedent(SIGKILL_SIM))
    env = dict(os.environ, PYTHONPATH=REPO, ELODIN_DB_PATH=str(tmp_path / "db"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "elodin_tpu_torch", "run", str(sim), "127.0.0.1:0",
         "--device", "cpu"], env=env, cwd=str(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    db_dir = tmp_path / "db"
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if db_dir.exists() and any(db_dir.rglob("data.bin")):
                time.sleep(1.0)
                break
            time.sleep(0.2)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
    ours, ref = TDatabase(str(db_dir)), JDatabase(str(db_dir))
    store = ours.by_name("t.kv")
    assert store is not None and store.len >= 2
    ts, vals = store.timestamps[:store.len], store.values[:store.len, 0]
    assert (np.diff(ts) > 0).all() and np.isfinite(vals).all()
    np.testing.assert_array_equal(vals, np.arange(store.len, dtype=np.float64))
    _assert_same_db(ours, ref, tol=0.0)


def test_compacting_in_a_campaign_matches_the_jax_package(tmp_path):
    """``compact_run_db`` in each package's campaign retention rewrites a
    run's database to the same bytes."""
    import shutil

    from elodin_tpu.monte_carlo import campaign as jcampaign
    from elodin_tpu_torch.monte_carlo import campaign as tcampaign

    jmake, _tmake, _ = WORLDS["free_body"]
    src = tmp_path / "src" / "db"
    _serve(jmake, jserve, src, 12)
    trees = {}
    for label, campaign in (("jax", jcampaign), ("torch", tcampaign)):
        run_dir = tmp_path / label
        shutil.copytree(src, run_dir / "db")
        campaign._apply_retention(run_dir, {"valid": True, "degraded": False},
                                  {"keep_run_db": "always", "compact_run_db": True})
        trees[label] = {p.relative_to(run_dir).as_posix(): p.read_bytes()
                        for p in sorted((run_dir / "db").rglob("*")) if p.is_file()}
    assert trees["torch"] == trees["jax"] and trees["torch"]
    _assert_same_db(TDatabase(str(tmp_path / "torch" / "db")), JDatabase(str(src)), tol=0.0)


def _cli_fixture(path):
    """A database of a few components (one empty, one of monotonic and one
    of wall-clock timestamps), a message log and an asset, written by the
    JAX package."""
    from elodin_tpu.db.vtable import component_id_of

    rng = np.random.default_rng(9)
    db = JDatabase(str(path))
    x = db.get_or_create(component_id_of("a.x"), "f64", (), "a.x")
    v = db.get_or_create(component_id_of("a.v"), "f64", (3,), "a.v")
    v.set_metadata(metadata={"element_names": "x,y,z"})
    flag = db.get_or_create(component_id_of("b.flag"), "bool", (), "b.flag")
    wall = db.get_or_create(component_id_of("c.wall"), "i64", (), "c.wall")
    db.get_or_create(component_id_of("c.empty"), "f64", (), "c.empty")
    for i in range(25):
        t = 1_000 * i
        x.append(t, np.float64(rng.normal()))
        v.append(t, rng.normal(size=3))
        flag.append(t, np.bool_(i % 2))
        wall.append(1_700_000_000_000_000 + t, np.int64(i))
    log = db.msg_log(b"\x11\x22")
    for i in range(3):
        log.append(1_000 * i, bytes([i, i + 1]))
    db.assets.put("schematic.kdl", b"viewport name=V\n")
    db.flush()


REPL_SCRIPT = "print(ComponentId('a.x'), msg_id('race.collision'), sql_table_name('a.x'))\n"

# subcommand -> its arguments after the database path ("{out}" is an output path)
CLI = {
    "query-sql": ["query", "{db}", "--sql", "SELECT * FROM a_x WHERE a_x > 0"],
    "query-eql": ["query", "{db}", "--eql", "a.v.norm()", "--precision", "full"],
    "export": ["export", "{db}", "--output", "{out}", "--format", "csv"],
    "export-join": ["export", "{db}", "--output", "{out}", "--join"],
    "merge": ["merge", "{db}", "{src}"],
    "trim": ["trim", "{db}", "--start-us", "5000", "--stop-us", "15000"],
    "compact": ["compact", "{db}"],
    "list": ["list", "{db}"],
    "gen-cpp": ["gen-cpp", "{db}", "--output", "{out}/header.hpp"],
    "prune": ["prune", "{db}", "--yes"],
    "fix-timestamps": ["fix-timestamps", "{db}"],
    "time-align": ["time-align", "{db}", "--target", "2.5"],
    "truncate": ["truncate", "{db}", "--yes"],
    "drop": ["drop", "{db}", "a.x", "--yes"],
    "info": ["info", "{db}"],
    "repl": ["repl", "--script", "{script}"],
}


def _tree(path):
    if not path.exists():
        return {}
    return {p.relative_to(path).as_posix(): p.read_bytes()
            for p in sorted(path.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("case", sorted(CLI))
def test_db_cli_matches_the_jax_package(tmp_path, capsys, case):
    """``python -m elodin_tpu_torch db`` and the JAX package's ``db`` CLI,
    each on its own copy of one database: the same output, paths aside,
    and the same files after."""
    import shutil

    from elodin_tpu.db.__main__ import main as jmain
    from elodin_tpu_torch.__main__ import main as tmain

    _cli_fixture(tmp_path / "fixture")
    _cli_fixture(tmp_path / "src")
    (tmp_path / "script.py").write_text(REPL_SCRIPT)
    outs = {}
    for label, run in (("jax", jmain), ("torch", lambda argv: tmain(["db", *argv]))):
        root = tmp_path / label
        shutil.copytree(tmp_path / "fixture", root / "db")
        shutil.copytree(tmp_path / "src", root / "src")
        (root / "out").mkdir()
        argv = [a.format(db=root / "db", out=root / "out", src=root / "src",
                         script=tmp_path / "script.py") for a in CLI[case]]
        capsys.readouterr()
        run(argv)
        text = capsys.readouterr().out.replace(str(root), "ROOT")
        outs[label] = (text, _tree(root / "db"), _tree(root / "out"))
    assert outs["torch"][0] == outs["jax"][0]
    assert outs["torch"][1] == outs["jax"][1]
    assert outs["torch"][2] == outs["jax"][2]


def test_db_cli_bench_run_and_what_is_not_ported(tmp_path, capsys):
    """``db bench`` prints the JAX package's figures (their values are
    timings; its JAX form is not run here: its first read races the store's
    creation, which the port's waits out); ``db run`` serves a database in a
    child process that a JAX client reads back.  ``export --format mcap``
    and ``export-videos``, which raised ``NotImplementedError`` until the
    database's second half was ported, now write what the JAX package's
    CLI writes: the same MCAP and layout bytes, and no MP4 for a database
    without a video log."""
    import json

    import elodin_tpu.db as jdb
    from elodin_tpu.db.__main__ import main as jmain
    from elodin_tpu_torch.__main__ import main as tmain

    capsys.readouterr()
    tmain(["db", "bench", "--rows", "300"])
    figures = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(figures) == ["bulk_ingest_rows_per_sec", "fanout_rows_per_sec",
                               "ingest_rows_per_sec", "rows"]
    assert figures["rows"] == 300 and figures["ingest_rows_per_sec"] > 0

    _cli_fixture(tmp_path / "db")
    for name, run in (("torch", lambda argv: tmain(["db", *argv])), ("jax", jmain)):
        out = tmp_path / name
        run(["export", str(tmp_path / "db"), "--output", str(out), "--format", "mcap"])
        run(["export-videos", str(tmp_path / "db"), "--output", str(out / "videos")])
        assert os.listdir(out / "videos") == []
    printed = capsys.readouterr().out
    assert printed.count("no video message logs found") == 2
    for f in ("db.mcap", "db.foxglove-layout.json"):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "elodin_tpu_torch", "db", "run", str(tmp_path / "db"),
         "--addr", f"127.0.0.1:{port}"],
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        assert "listening" in proc.stdout.readline()
        client = jdb.Client.connect(f"127.0.0.1:{port}")
        ts, vals = client.time_series("a.v")
        ref = JDatabase(str(tmp_path / "db")).by_name("a.v")
        np.testing.assert_array_equal(ts, ref.timestamps[:ref.len])
        np.testing.assert_array_equal(vals.reshape(ref.len, 3), ref.values[:ref.len])
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
