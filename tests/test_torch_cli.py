"""The port's sim CLI (``cli.run_cli``, ``World.run``, ``python -m
elodin_tpu_torch``) against the JAX package's, on the CPU.

* ``components`` of the rocket, the drone and the cube-sat, and
  ``params`` and ``plan`` of the landing sim: byte for byte (``plan.csv``
  too), ``sys.argv`` patched; the JAX ``run_cli`` returns before its
  server for these.
* ``bench --ticks 20 --device cpu``: the JAX package's three lines (the
  numbers aside); ``--profile`` writes ``profile-metrics.json`` and
  ``step.torch_profile.txt`` into ``profile_output/`` beside
  ``sys.argv[0]``.
* ``World.run(max_ticks=120, pre_step=, post_step=, device="cpu")`` on the
  rocket: every column within 1e-10 of the JAX package's
  ``World.build(...).run(120)`` (the rocket's tolerance,
  ``tests/test_torch_examples.py``), the callbacks in the JAX ``run_cli``
  order, ``ELODIN_SIM_SUMMARY_JSON`` written, the telemetry served on the
  run's address; a database path (``db_path``, ``ELODIN_DB_PATH``) is
  written and ``ELODIN_RESUME=1`` resumes from it.
* One subprocess, ``python -m elodin_tpu_torch bench
  elodin_tpu_torch.examples.ball.sim --ticks 20 --device cpu``.
* ``editor`` and ``render-server`` with the JAX package's behaviour: a
  database address, an ``s10.toml``, a sim module run on the CPU, and a
  served database directory that a client reaches.
"""

import csv
import inspect
import json
import os
import re
import runpy
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import elodin_tpu as jel
import elodin_tpu_torch as tel
from elodin_tpu import __main__ as jmain
from elodin_tpu_torch import __main__ as tmain
from elodin_tpu_torch.examples.cube_sat import main as tcube
from elodin_tpu_torch.examples.drone import main as tdrone
from elodin_tpu_torch.examples.monte_carlo import main as tlanding
from elodin_tpu_torch.examples.rocket import main as trocket
from elodin_tpu_torch.examples.three_body import main as ttb
from torch_port_util import float_policy, jax_example, rel_errs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LANDING_DIR = os.path.join(REPO, "examples", "monte-carlo")
ROCKET_TICKS, ROCKET_TOL = 120, 1e-10
BENCH_LINES = re.compile(r"= tick time: +N ms \(batch of 1 ticks\)\n"
                         r"build time: +N ms\nreal_time_factor: +N\n")


@pytest.fixture(autouse=True)
def _f64():
    with float_policy("f64"):
        yield


def _argv(monkeypatch, *args, prog="main.py"):
    monkeypatch.setattr(sys, "argv", [str(prog), *args])


# the (JAX module, port module, how main() calls World.run) of each example
EXAMPLES = {
    "rocket": (lambda: jax_example("rocket", "main"), trocket,
               lambda m: (m.build_system(), 1.0 / m.SIM_TIME_STEP)),
    "drone": (lambda: jax_example("drone", "main"), tdrone,
              lambda m: (m.build_system(flight_plan=True), m.SIMULATION_RATE)),
    "cube-sat": (lambda: jax_example("cube-sat", "main"), tcube,
                 lambda m: (m.build_system(), 1.0 / m.SIM_TIME_STEP)),
}


@pytest.mark.parametrize("example", sorted(EXAMPLES))
def test_components_byte_for_byte(example, monkeypatch, capsys):
    jmod, tmod, call = EXAMPLES[example]
    jmod = jmod()
    _argv(monkeypatch, "components")
    outs = []
    for mod in (jmod, tmod):
        system, rate = call(mod)
        assert mod.build_world().run(system, simulation_rate=rate) is None
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    names = {c["name"] for c in json.loads(outs[1])}
    assert {"world_pos", "tick"} <= names


def _jax_landing_main(monkeypatch):
    """Run ``examples/monte-carlo/main.py`` as the JAX package's sim, its
    own ``sim`` module on the path."""
    monkeypatch.syspath_prepend(JAX_LANDING_DIR)
    monkeypatch.delitem(sys.modules, "sim", raising=False)
    try:
        runpy.run_path(os.path.join(JAX_LANDING_DIR, "main.py"), run_name="__main__")
    finally:
        sys.modules.pop("sim", None)


def test_params_and_plan_byte_for_byte(tmp_path, monkeypatch, capsys):
    _argv(monkeypatch, "params")
    _jax_landing_main(monkeypatch)
    ref = capsys.readouterr().out
    tlanding.main()
    ours = capsys.readouterr().out
    assert ours == ref
    assert sorted(json.loads(ours)["params"]) == sorted(tlanding.PARAMS)

    _argv(monkeypatch, "plan", str(tmp_path / "jax"))
    _jax_landing_main(monkeypatch)
    _argv(monkeypatch, "plan", str(tmp_path / "port"))
    tlanding.main()
    ref, ours = ((tmp_path / d / "plan.csv").read_bytes() for d in ("jax", "port"))
    assert ours == ref
    row, = csv.DictReader(ours.decode().splitlines())
    assert float(row["param.dry_mass"]) == 25_000.0


def test_components_of_a_file_target_through_python_m(monkeypatch, capsys):
    _argv(monkeypatch, "components")
    _jax_landing_main(monkeypatch)
    ref = capsys.readouterr().out
    tmain.main(["components", tlanding.__file__])
    assert capsys.readouterr().out == ref


def _numbers_out(text):
    return re.sub(r"-?\d+\.\d+", "N", text)


def test_bench_prints_the_jax_lines(tmp_path, monkeypatch, capsys):
    _argv(monkeypatch, "bench", "--ticks", "20")
    jt = jax_example("three-body", "main")
    jt.w.run(jt.sys, simulation_rate=120.0)
    ref = capsys.readouterr().out
    _argv(monkeypatch, "bench", "--ticks", "20", "--device", "cpu",
          prog=tmp_path / "main.py")
    exec_ = ttb.build_world().run(ttb.build_system(), simulation_rate=120.0)
    ours = capsys.readouterr().out
    assert BENCH_LINES.fullmatch(_numbers_out(ref)), ref
    assert BENCH_LINES.fullmatch(_numbers_out(ours)), ours
    assert exec_.tick() == 20 and exec_.cols["world_pos"].device.type == "cpu"
    assert not (tmp_path / "profile_output").exists()


def test_bench_profile_writes_its_files(tmp_path, monkeypatch, capsys):
    _argv(monkeypatch, "bench", "--ticks", "5", "--profile", "--device", "cpu",
          prog=tmp_path / "main.py")
    exec_ = ttb.build_world().run(ttb.build_system(), simulation_rate=120.0)
    capsys.readouterr()
    out = tmp_path / "profile_output"
    metrics = json.loads((out / "profile-metrics.json").read_text())
    assert sorted(metrics) == ["build_time_ms", "real_time_factor", "ticks"]
    assert metrics["ticks"] == 5
    table = (out / "step.torch_profile.txt").read_text()
    assert "aten::" in table
    # the port's spans show as rows of their own: the tick and each system
    assert "system.increment_sim_tick" in table and " tick " in table
    assert exec_.tick() == 5  # the profiled tick is not committed


def test_world_run_takes_the_jax_parameters_in_their_order():
    ours = list(inspect.signature(tel.World.run).parameters)
    ref = list(inspect.signature(jel.World.run).parameters)
    assert ours == ref + ["device"]


def test_world_run_on_the_rocket_matches_the_jax_package(tmp_path, monkeypatch, capsys):
    jr = jax_example("rocket", "main")
    ref = jr.build_world().build(jr.build_system(), simulation_rate=1.0 / jr.SIM_TIME_STEP)
    ref.run(ROCKET_TICKS)

    summary = tmp_path / "summary.json"
    monkeypatch.setenv("ELODIN_SIM_SUMMARY_JSON", str(summary))
    _argv(monkeypatch, "run", "127.0.0.1:0")
    calls = []
    ours = trocket.build_world().run(
        trocket.build_system(), simulation_rate=1.0 / trocket.SIM_TIME_STEP,
        max_ticks=ROCKET_TICKS, pre_step=lambda tick, ctx: calls.append(("pre", tick, ctx.tick())),
        post_step=lambda tick, ctx: calls.append(("post", tick, ctx.tick())), device="cpu")
    captured = capsys.readouterr()
    assert "warning" not in captured.err and f"{ROCKET_TICKS} ticks" in captured.out
    assert ours.tick() == ROCKET_TICKS and ours.cols["world_pos"].device.type == "cpu"
    want = []
    for t in range(ROCKET_TICKS):
        want += [("pre", t, t), ("post", t, t + 1)]
    assert calls == want
    for k in ref.meta.components:
        r, o = np.asarray(ref.column_array(k)), ours.column_array(k)
        if r.dtype.kind != "f":
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            assert max(rel_errs(o, r).values()) <= ROCKET_TOL, k
    assert len(ours.history_frame("rocket.world_pos")) == ROCKET_TICKS + 1
    data = json.loads(summary.read_text())
    assert data["ticks"] == ROCKET_TICKS and data["max_ticks"] == ROCKET_TICKS
    assert data["paced_ticks"] == 0 and data["behind_deadline_frac"] == 0.0
    assert data["real_time_factor_run"] > 0.0 and "commit" in data["phases"]


def test_run_limits_and_refusals(monkeypatch, capsys, tmp_path):
    from elodin_tpu_torch.db.storage import Database

    world, system = ttb.build_world, ttb.build_system
    _argv(monkeypatch, "run", "127.0.0.1:0", "--device", "cpu")
    monkeypatch.setenv("ELODIN_MAX_TICKS", "7")
    assert world().run(system()).tick() == 7
    assert world().run(system(), max_ticks=3).tick() == 3
    # a database path: the served telemetry lands there, 1 + 7 rows
    assert world().run(system(), db_path=str(tmp_path / "a")).tick() == 7
    stores = Database(str(tmp_path / "a")).components.values()
    assert stores and {s.len for s in stores} == {8}
    monkeypatch.setenv("ELODIN_DB_PATH", str(tmp_path / "b"))
    assert world().run(system()).tick() == 7
    # resumed at the stored tick, which is already the limit
    monkeypatch.setenv("ELODIN_RESUME", "1")
    assert world().run(system()).tick() == 7
    monkeypatch.delenv("ELODIN_DB_PATH")
    monkeypatch.setenv("ELODIN_SKIP_RUN", "1")
    assert world().run(system()) is None
    monkeypatch.delenv("ELODIN_SKIP_RUN")
    monkeypatch.delenv("ELODIN_RESUME")
    calls = []
    ex = world().run(system(), device="cpu",
                     is_canceled=lambda: calls.append(1) or len(calls) > 4)
    assert ex.tick() == 4
    capsys.readouterr()


@pytest.mark.parametrize("cmd", ["db"])
def test_python_m_refuses_what_needs_the_database(cmd, capsys):
    """``db`` runs the database's CLI, which without a subcommand exits
    with its usage."""
    with pytest.raises(SystemExit) as e:
        tmain.main([cmd])
    assert e.value.code != 0
    assert "usage: elodin-db" in capsys.readouterr().err


def _served_child(args):
    """``python -m elodin_tpu_torch ARGS`` serving a database on a free
    port: a client reaches it and reads back a row it wrote, then SIGINT
    stops the child, which must exit 0."""
    from elodin_tpu_torch.db import Client

    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen([sys.executable, "-m", "elodin_tpu_torch", *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.match(r"elodin-db listening on (127\.0\.0\.1:\d+) \(path=(.*)\)", line)
        assert m, line
        client = Client.connect(m.group(1))
        client.send("probe.x", np.array([1.5, -2.0]), timestamp_us=7)
        for _ in range(500):
            sample = client.latest("probe.x")
            if sample is not None:
                break
            time.sleep(0.02)
        np.testing.assert_array_equal(sample.values, [1.5, -2.0])
        client.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
        return m.group(2)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("case", ["editor_address", "editor_s10_toml", "editor_sim_module",
                                  "render_server"])
def test_editor_and_render_server(case, tmp_path, capsys, monkeypatch):
    """``editor`` resolves its target as the JAX package's does: a live
    database's address prints its viewer's (the same text as the JAX
    package's), an ``s10.toml`` runs (as the JAX package's does) and is
    supervised until its processes end, a sim (here a dotted module, with
    ``--device cpu`` after it) runs through ``run``; ``render-server DIR``
    serves DIR's database."""
    if case == "editor_address":
        outs = []
        for addr in ("127.0.0.1:2240", "[::1]:4000"):
            jmain.main(["editor", addr])
            want = capsys.readouterr().out
            tmain.main(["editor", addr])
            assert capsys.readouterr().out == want
            outs.append(want)
        assert "web viewer is at http://127.0.0.1:2241/" in outs[0]
        assert "web viewer is at http://[::1]:4001/" in outs[1]
    elif case == "editor_s10_toml":
        outs = {}
        for label, main in (("jax", jmain.main), ("torch", tmain.main)):
            out = tmp_path / f"{label}.txt"
            toml = tmp_path / label / "s10.toml"
            toml.parent.mkdir()
            toml.write_text(f"""[recipes.hello]\ntype = "process"\ncmd = "/bin/sh"\n"""
                            f"""args = ["-c", "echo hi > {out}"]\n""")
            main(["editor", str(toml)])
            outs[label] = out.read_text()
        assert outs["torch"] == outs["jax"] == "hi\n"
    elif case == "editor_sim_module":
        env = dict(os.environ, PYTHONPATH=REPO, ELODIN_MAX_TICKS="30",
                   ELODIN_SIM_SUMMARY_JSON=str(tmp_path / "summary.json"))
        proc = subprocess.run(
            [sys.executable, "-m", "elodin_tpu_torch", "editor",
             "elodin_tpu_torch.examples.ball.sim", "127.0.0.1:0", "--device", "cpu"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads((tmp_path / "summary.json").read_text())["ticks"] == 30
    else:
        db_dir = str(tmp_path / "db")
        assert _served_child(["render-server", db_dir, "--addr", "127.0.0.1:0"]) == db_dir
        assert (tmp_path / "db").is_dir()


def test_python_m_bench_of_a_module_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "elodin_tpu_torch", "bench", "elodin_tpu_torch.examples.ball.sim",
         "--ticks", "20", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert BENCH_LINES.fullmatch(_numbers_out(proc.stdout)), proc.stdout
