"""The port's process orchestrator (``elodin_tpu_torch.s10``, ``el.s10``),
on the CPU, held to the JAX package's.

* Every s10 case of the JAX tests: TOML recipes and supervision
  (``tests/test_core.py::test_s10_toml_recipes``), restart policies,
  the liveness kill, the readiness probe and watch mode, and the admission
  budget (``tests/test_fsw.py``).
* The same TOML through both packages' ``load_toml``: the same recipes
  field for field, and the same ``PyRecipe.to_json`` but for the port's
  ``device``.
* ``SimRecipe``: the port runs ``python -m elodin_tpu_torch run <target>
  <addr>`` (the JAX package: ``python <path> run <addr>``), ``--device``
  only where the recipe states one; a port sim started so serves its
  telemetry, and ``stop`` ends its whole process group.

Waits poll what they wait for, with deadlines.
"""

import dataclasses
import json
import os
import signal
import sys
import time

import pytest

import elodin_tpu_torch as el
from elodin_tpu import s10 as js10
from elodin_tpu_torch import s10
from elodin_tpu_torch.s10 import ProcessRecipe, ReadyProbe, SimRecipe, Supervisor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOML = """
[recipes.hello]
type = "process"
cmd = "/bin/sh"
args = ["-c", "echo hi > {out}"]

[recipes.grp]
type = "group"
[recipes.grp.recipes.world]
type = "process"
cmd = "/bin/sh"
args = ["-c", "true"]
restart_policy = "on-failure"
ready = {{ type = "tcp", addr = "127.0.0.1:1" }}
watch = ["*.py"]

[recipes.sim]
type = "sim"
path = "elodin_tpu_torch.examples.ball.sim"
addr = "127.0.0.1:2299"
env = {{ ELODIN_MAX_TICKS = 30 }}
liveness_timeout = 5.0
"""


def _count(path, ch):
    try:
        return path.read_text().count(ch)
    except FileNotFoundError:
        return 0


def _group_gone(pgid):
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return True
    return False


def test_el_s10_is_the_module():
    assert el.s10 is s10


def test_s10_toml_recipes(tmp_path):
    """s10 recipe loading + supervision from TOML (libs/s10 parity)."""
    cfg = tmp_path / "s10.toml"
    out = tmp_path / "out.txt"
    cfg.write_text(f"""
[recipes.hello]
type = "process"
cmd = "/bin/sh"
args = ["-c", "echo hi > {out}"]

[recipes.grp]
type = "group"
[recipes.grp.recipes.world]
type = "process"
cmd = "/bin/sh"
args = ["-c", "true"]
""")
    recipes = s10.load_toml(str(cfg))
    assert set(recipes) == {"hello", "grp"}
    sup = s10.run_recipes(recipes)
    # wait for CONTENT, not existence: the shell creates the file before
    # echo writes it, so an existence poll can read '' under load
    deadline = time.time() + 30
    text = ""
    while time.time() < deadline:
        if out.exists():
            text = out.read_text().strip()
            if text:
                break
        time.sleep(0.05)
    sup.stop_all()
    assert text == "hi"


def test_toml_recipes_are_the_jax_packages(tmp_path):
    cfg = tmp_path / "s10.toml"
    cfg.write_text(TOML.format(out=tmp_path / "out.txt"))
    ours, ref = s10.load_toml(str(cfg)), js10.load_toml(str(cfg))
    assert list(ours) == list(ref) == ["hello", "grp", "sim"]

    def fields(r):
        d = dataclasses.asdict(r)
        d.pop("device", None)
        return type(r).__name__, d

    assert fields(ours["hello"]) == fields(ref["hello"])
    assert [fields(r) for r in ours["grp"].recipes] == [fields(r) for r in ref["grp"].recipes]
    assert fields(ours["sim"]) == fields(ref["sim"]) and ours["sim"].device is None
    ours_json = json.loads(s10.PyRecipe.sim("s", "m", "127.0.0.1:1").to_json())
    assert ours_json.pop("device") is None
    assert ours_json == json.loads(js10.PyRecipe.sim("s", "m", "127.0.0.1:1").to_json())
    assert (s10.PyRecipe.process("p", "python -c pass").to_json()
            == js10.PyRecipe.process("p", "python -c pass").to_json())
    assert s10._expand_env("${NOPE_X:-d}/${HOME}") == js10._expand_env("${NOPE_X:-d}/${HOME}")


def test_s10_supervisor_restart_policies(tmp_path):
    """Restart policies (libs/s10 run loop): on-failure restarts a crashing
    process, never leaves it dead, always restarts clean exits too."""
    marker = tmp_path / "runs.txt"
    crash = ProcessRecipe(
        name="crasher",
        cmd=sys.executable,
        args=["-c", f"open(r'{marker}', 'a').write('x'); raise SystemExit(3)"],
        restart_policy="on-failure",
    )
    clean_never = ProcessRecipe(
        name="oneshot",
        cmd=sys.executable,
        args=["-c", "pass"],
        restart_policy="never",
    )
    sup = Supervisor()
    sup.start([crash, clean_never])
    deadline = time.time() + 30.0
    while time.time() < deadline:
        sup.tick()
        if _count(marker, "x") >= 2:
            break
        time.sleep(0.1)
    sup.stop_all()
    assert _count(marker, "x") >= 2  # restarted after crash

    # 'always' restarts even a clean exit
    marker2 = tmp_path / "always.txt"
    always = ProcessRecipe(
        name="always",
        cmd=sys.executable,
        args=["-c", f"open(r'{marker2}', 'a').write('y')"],
        restart_policy="always",
    )
    sup2 = Supervisor()
    sup2.start([always])
    deadline = time.time() + 30.0
    while time.time() < deadline:
        sup2.tick()
        if _count(marker2, "y") >= 2:
            break
        time.sleep(0.1)
    sup2.stop_all()
    assert _count(marker2, "y") >= 2


def test_s10_liveness_kill(tmp_path):
    """A hung sim (stale liveness beacon) is killed by the supervisor
    within the timeout (libs/s10/src/liveness.rs, probe-driven kill)."""
    child = tmp_path / "hang.py"
    child.write_text(
        "import json, socket, sys, time\n"
        "port = int(sys.argv[sys.argv.index('--liveness-port')+1])\n"
        "s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)\n"
        "for _ in range(3):\n"
        "    s.sendto(json.dumps({'age_s': 0}).encode(), ('127.0.0.1', port))\n"
        "    time.sleep(0.1)\n"
        "time.sleep(60)  # hang: no more beacons\n"
    )
    recipe = ProcessRecipe(
        name="hang", cmd=sys.executable, args=[str(child)],
        liveness_timeout=1.0,
    )
    sup = Supervisor()
    sup.start([recipe])
    rp = sup.running[0]
    deadline = time.monotonic() + 6.0
    while time.monotonic() < deadline and rp.poll() is None:
        sup.tick()
        time.sleep(0.2)
    assert rp.poll() is not None, "hung child was not killed"
    sup.stop_all()


def test_s10_ready_probe_and_watch(tmp_path):
    marker = tmp_path / "ready.marker"
    src = tmp_path / "watched.txt"
    src.write_text("v1")
    child = tmp_path / "serve.py"
    child.write_text(
        f"import pathlib, time\n"
        f"pathlib.Path({str(marker)!r}).write_text('up')\n"
        f"time.sleep(60)\n"
    )
    recipe = ProcessRecipe(
        name="probe", cmd=sys.executable, args=[str(child)],
        ready=ReadyProbe(type="file", path=str(marker)),
        watch=[str(src)],
    )
    sup = Supervisor()
    sup.start([recipe])
    assert sup.wait_ready(timeout=10.0)
    pid0 = sup.running[0].proc.pid
    src.write_text("v2")  # source change -> watch restart
    os.utime(src, (os.stat(src).st_atime, os.stat(src).st_mtime + 5))
    sup.tick()
    assert sup.running[0].proc.pid != pid0, "watch did not restart child"
    sup.stop_all()


def test_s10_admission_budget(tmp_path):
    """S10_MAX_INFLIGHT (libs/s10/src/admission.rs): at most N recipes run
    concurrently; the rest queue until a slot frees."""
    marker = tmp_path / "order.txt"
    recipes = [
        ProcessRecipe(
            name=f"r{i}", cmd=sys.executable,
            args=["-c",
                  f"import time; open(r'{marker}', 'a').write('{i}');"
                  " time.sleep(0.4)"],
        )
        for i in range(4)
    ]
    sup = Supervisor(max_inflight=2)
    sup.start(recipes)
    assert sum(1 for rp in sup.running if rp.poll() is None) <= 2
    assert len(sup.queued) == 2
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        sup.tick()
        if (
            not sup.queued
            and all(rp.poll() is not None for rp in sup.running)
        ):
            break
        time.sleep(0.1)
    sup.stop_all()
    assert sorted(marker.read_text()) == ["0", "1", "2", "3"]


@pytest.mark.parametrize("device", [None, "cpu"])
def test_sim_recipe_runs_the_package_cli(device, monkeypatch):
    """The sim recipe's command: the port's CLI on a target, ``--device``
    only where stated (the card by default); the checkout on the child's
    ``PYTHONPATH``."""
    seen = {}

    class _Proc:
        pid = 0

    def popen(args, **kw):
        seen.update(args=args, env=kw["env"], new_session=kw["start_new_session"])
        return _Proc()

    monkeypatch.setattr(s10.subprocess, "Popen", popen)
    SimRecipe("ball", "elodin_tpu_torch.examples.ball.sim", "127.0.0.1:2300",
              device=device).spawn()
    want = [sys.executable, "-m", "elodin_tpu_torch", "run",
            "elodin_tpu_torch.examples.ball.sim", "127.0.0.1:2300"]
    assert seen["args"] == want + (["--device", device] if device else [])
    assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert seen["new_session"]


def test_sim_recipe_serves_and_stops_its_process_group():
    """A port sim (the ball) started as a recipe on the CPU serves its
    telemetry on the recipe's address; ``stop`` ends the whole group."""
    import socket

    import elodin_tpu_torch.db as tdb

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    recipe = s10.PyRecipe.sim("ball", "elodin_tpu_torch.examples.ball.sim", addr,
                              device="cpu")
    recipe.inner.env.update(ELODIN_MAX_TICKS="40", ELODIN_KEEP_ALIVE="1")
    rp = recipe.spawn()
    pgid = os.getpgid(rp.proc.pid)
    try:
        deadline = time.monotonic() + 90
        client = None
        while True:
            assert rp.poll() is None, "the sim exited"
            try:
                client = client or tdb.Client.connect(addr)
                if "ball.world_pos" in client.components() and len(
                        client.time_series("ball.world_pos")[0]) >= 41:
                    break
            except (OSError, RuntimeError):
                pass
            assert time.monotonic() < deadline, "the sim never served 41 rows"
            time.sleep(0.1)
        ts, vals = client.time_series("ball.world_pos")
        assert len(ts) == 41 and vals.shape == (41, 7)
        client.close()
    finally:
        rp.stop()
    assert rp.poll() is not None and rp.poll() in (-signal.SIGTERM, -signal.SIGKILL, 0)
    deadline = time.monotonic() + 10
    while not _group_gone(pgid):
        assert time.monotonic() < deadline, "the sim's process group outlived stop"
        time.sleep(0.05)
