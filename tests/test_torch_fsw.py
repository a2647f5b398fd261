"""The port's flight-software host framework (``elodin_tpu_torch.fsw``,
``fsw_services``) and ``python -m elodin_tpu_torch.status``, on the CPU,
held to the JAX package's.

* Every non-s10 case of ``tests/test_fsw.py`` on the port, the systems
  with ``device="cpu"``: world components, ``HzDriver`` pacing and
  ``pipe``, the MEKF and LQR services against a live port database, the
  pty serial bridge, the blackbox decode, the host-telemetry bridge and
  the status banner.  (The s10 cases are in ``test_torch_s10.py``.)
* The JAX package's ``mekf_system`` -> ``lqr_system`` and the port's take
  the same 150 worlds (a body turning about +z, gyro and vector noise
  from one numpy seed): ``att_est`` and ``control_torque`` agree each
  tick to 1e-12 (the adcs tolerance: the same algebra in IEEE f64).
* ``decode_blackbox`` of one log gives the same stores, rows and message
  logs in both packages, bitwise.
* A tensor that a system writes into the world is pushed to the database
  and the CSV as the same numbers as host numpy.
* Without ``device`` the systems ask for the card, and raise here.

Waits poll what they wait for, with deadlines.
"""

import os
import struct
import subprocess
import sys
import time
import typing as ty
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import elodin_tpu as jel
import elodin_tpu_torch as el
import elodin_tpu_torch.db as edb
from elodin_tpu import fsw as jfsw
from elodin_tpu import fsw_services as jservices
from elodin_tpu_torch import fsw
from elodin_tpu_torch.db import msgs as M
from elodin_tpu_torch.db.postcard import msg_id
from elodin_tpu_torch.db.vtable import build_table_vtable, component_id_of
from elodin_tpu_torch.fsw_services import (
    HostTelemetryBridge,
    SerialBridge,
    decode_blackbox,
    frame_packet_cobs,
)
from elodin_tpu_torch.spatial import quat_from_axis_angle, quat_inverse, quat_rotate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12
DEADLINE_S = 10.0


def _f64(name, n):
    return ty.Annotated[torch.Tensor,
                        el.Component(name, el.ComponentType(el.PrimitiveType.F64, (n,)))]


GyroOmega = _f64("gyro_omega", 3)
MagBody = _f64("mag_body", 3)
MagRef = _f64("mag_ref", 3)
SunBody = _f64("sun_body", 3)
SunRef = _f64("sun_ref", 3)
AttEst = _f64("att_est", 4)
AttGoal = _f64("att_goal", 4)
Torque = _f64("control_torque", 3)


@dataclass
class AdcsWorld:
    gyro_omega: GyroOmega = field(default_factory=lambda: np.zeros(3))
    mag_body: MagBody = field(default_factory=lambda: np.zeros(3))
    mag_ref: MagRef = field(default_factory=lambda: np.array([1.0, 0, 0]))
    sun_body: SunBody = field(default_factory=lambda: np.zeros(3))
    sun_ref: SunRef = field(default_factory=lambda: np.array([0.0, 0, 1.0]))
    att_est: AttEst = field(default_factory=lambda: np.array([0.0, 0, 0, 1.0]))


@dataclass
class LqrWorld:
    gyro_omega: GyroOmega = field(default_factory=lambda: np.zeros(3))
    att_est: AttEst = field(default_factory=lambda: np.array([0.0, 0, 0, 1.0]))
    att_goal: AttGoal = field(default_factory=lambda: np.array([0.0, 0, 0, 1.0]))
    control_torque: Torque = field(default_factory=lambda: np.zeros(3))


@dataclass
class TorqueWorld:
    control_torque: Torque = field(default_factory=lambda: np.zeros(3))


def _until(cond, what):
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def _latest(client, name, want_ts):
    """The latest sample of ``name`` once its timestamp is ``want_ts`` or
    later (the server applies a table write asynchronously)."""
    got = {}

    def ready():
        got["s"] = client.latest(name)
        return got["s"] is not None and got["s"].timestamp_us >= want_ts

    _until(ready, f"{name} at {want_ts}")
    return got["s"]


def test_world_components():
    comps = fsw.world_components(AdcsWorld)
    assert comps["gyro_omega"].name == "gyro_omega"
    assert comps["att_est"].ty.shape == (4,)
    assert list(comps) == ["gyro_omega", "mag_body", "mag_ref", "sun_body", "sun_ref",
                           "att_est"]


def test_hz_driver_rate_and_pipe():
    calls = []
    driver = fsw.HzDriver(
        500.0,
        fsw.as_fsw_system(lambda w: calls.append("a")).pipe(
            fsw.as_fsw_system(lambda w: calls.append("b"))),
        AdcsWorld(),
    )
    t0 = time.perf_counter()
    driver.run(max_ticks=50)
    wall = time.perf_counter() - t0
    assert calls[:4] == ["a", "b", "a", "b"]
    assert driver.ticks == 50
    assert wall >= 0.08  # paced, not free-running
    with pytest.raises(TypeError, match="not a system"):
        fsw.as_fsw_system(3)


def test_mekf_service_against_live_db(tmp_path):
    """A sensor writes observations into the database, the MEKF service
    subscribes, estimates and publishes the attitude back."""
    srv = edb.Server.start(str(tmp_path / "db"))
    try:
        q_true = quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64),
                                      0.6)
        qi = quat_inverse(q_true)
        mag_body = quat_rotate(qi, torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64))
        sun_body = quat_rotate(qi, torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64))
        sensor = edb.Client.connect(srv.addr)
        writer = sensor.table_writer(
            {"gyro_omega": edb.f64[3], "mag_body": edb.f64[3], "sun_body": edb.f64[3]})
        writer.write(timestamp_us=1, values={"gyro_omega": np.zeros(3),
                                             "mag_body": mag_body.numpy(),
                                             "sun_body": sun_body.numpy()})
        _latest(sensor, "sun_body", 1)
        system = fsw.mekf_system(
            sigma_g=[0.01] * 3, sigma_b=[0.01] * 3, dt=1.0 / 50.0,
            refs_fields=["mag_ref", "sun_ref"], body_fields=["mag_body", "sun_body"],
            sigmas=[0.03, 0.03], device="cpu")
        driver = fsw.HzDriver(
            200.0, system, AdcsWorld(), db_addr=srv.addr,
            subscribe=["gyro_omega", "mag_body", "sun_body"], publish=["att_est"])
        driver.run(max_ticks=150)
        driver.close()
        assert isinstance(driver.world.att_est, np.ndarray)

        est = _latest(sensor, "att_est", 2)
        dot = abs(float(np.dot(est.values, q_true.numpy())))
        assert dot > 0.999, f"FSW MEKF did not converge: {dot}"
        writer.close()
        sensor.close()
    finally:
        srv.stop()


def test_lqr_service_against_live_db(tmp_path):
    """The LQR service subscribes to the attitude estimate, rates and goal
    and publishes the Yang-LQR torque: it opposes the attitude error and
    vanishes at the goal."""
    srv = edb.Server.start(str(tmp_path / "db"))
    try:
        sensor = edb.Client.connect(srv.addr)
        writer = sensor.table_writer(
            {"att_est": edb.f64[4], "gyro_omega": edb.f64[3], "att_goal": edb.f64[4]})
        q = quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64), 0.4)
        identity = np.array([0.0, 0, 0, 1.0])
        writer.write(timestamp_us=1, values={"att_est": q.numpy(), "gyro_omega": np.zeros(3),
                                             "att_goal": identity})
        _latest(sensor, "att_goal", 1)
        system = fsw.lqr_system(j=[1.0, 1.0, 1.0], q_ang_vel=[1.0] * 3, q_pos=[1.0] * 3,
                                r=[1.0] * 3, device="cpu")

        def drive(ticks):
            driver = fsw.HzDriver(200.0, system, LqrWorld(), db_addr=srv.addr,
                                  subscribe=["att_est", "gyro_omega", "att_goal"],
                                  publish=["control_torque"])
            driver.run(max_ticks=ticks)
            driver.close()
            return driver.world.control_torque

        last = drive(60)
        t = _latest(sensor, "control_torque", 2)
        np.testing.assert_array_equal(t.values, last)
        # the error is +0.4 rad about z: a restoring torque about -z
        assert t.values[2] < -0.05, t.values
        assert abs(t.values[0]) < 1e-9 and abs(t.values[1]) < 1e-9

        writer.write(timestamp_us=2_000_000, values={"att_est": identity,
                                                     "gyro_omega": np.zeros(3),
                                                     "att_goal": identity})
        _latest(sensor, "att_est", 2_000_000)
        drive(30)
        deadline = time.monotonic() + DEADLINE_S
        while np.abs(sensor.latest("control_torque").values).max() > 1e-12:
            assert time.monotonic() < deadline, "the torque at the goal never arrived"
            time.sleep(0.02)
        writer.close()
        sensor.close()
    finally:
        srv.stop()


def _truth(k, rng, dt):
    """Tick ``k`` of a body turning at 0.05 rad/s about +z from 0.6 rad:
    gyro and vector readings with noise, and the true attitude."""
    theta = 0.6 + 0.05 * k * dt
    q = np.array([0.0, 0.0, np.sin(theta / 2), np.cos(theta / 2)])
    c, s = np.cos(theta), np.sin(theta)
    # R(q)^T v: the reference vectors in the body frame
    mag = np.array([c, -s, 0.0]) + rng.normal(0.0, 0.003, 3)
    sun = np.array([0.0, 0.0, 1.0]) + rng.normal(0.0, 0.003, 3)
    gyro = np.array([0.0, 0.0, 0.05]) + rng.normal(0.0, 0.001, 3)
    return q, {"gyro_omega": gyro, "mag_body": mag, "sun_body": sun,
               "mag_ref": np.array([1.0, 0.0, 0.0]), "sun_ref": np.array([0.0, 0.0, 1.0]),
               "att_goal": np.array([0.0, 0.0, 0.0, 1.0])}


def _loop(pkg, **kw):
    dt = 1.0 / 200.0
    return pkg.mekf_system(
        sigma_g=[0.01] * 3, sigma_b=[0.001] * 3, dt=dt, refs_fields=["mag_ref", "sun_ref"],
        body_fields=["mag_body", "sun_body"], sigmas=[0.03, 0.03], **kw,
    ).pipe(pkg.lqr_system(j=[0.1, 0.2, 0.3], q_ang_vel=[1.0] * 3, q_pos=[2.0] * 3,
                          r=[0.5] * 3, **kw))


def test_mekf_lqr_loop_matches_jax_each_tick():
    rng = np.random.default_rng(7)
    ours, ref = _loop(fsw, device="cpu"), _loop(jfsw)
    w_ours = SimpleNamespace(att_est=np.array([0.0, 0, 0, 1.0]))
    w_ref = SimpleNamespace(att_est=np.array([0.0, 0, 0, 1.0]))
    worst = {"att_est": 0.0, "control_torque": 0.0}
    for k in range(150):
        q_true, inputs = _truth(k, rng, 1.0 / 200.0)
        for w in (w_ours, w_ref):
            for name, v in inputs.items():
                setattr(w, name, v.copy())
        ours.update(w_ours)
        ref.update(w_ref)
        for name in worst:
            a, b = getattr(w_ours, name), np.asarray(getattr(w_ref, name))
            assert isinstance(a, np.ndarray) and a.dtype == np.float64 and a.shape == b.shape
            worst[name] = max(worst[name], float(np.abs(a - b).max()))
    assert max(worst.values()) <= TOL, worst
    assert abs(float(np.dot(w_ours.att_est, q_true))) > 0.999
    assert np.abs(w_ours.control_torque).max() > 0.0


@pytest.mark.parametrize("which", ["mekf", "lqr"])
def test_systems_default_to_the_card(which):
    """No ``device``: the card, which this machine lacks, so the system
    raises where it is built and nothing runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if which == "mekf":
            fsw.mekf_system([0.01] * 3, [0.01] * 3, 0.02, ["mag_ref"], ["mag_body"], [0.03])
        else:
            fsw.lqr_system([1.0] * 3, [1.0] * 3, [1.0] * 3, [1.0] * 3)


def test_a_tensor_in_the_world_is_pushed_as_host_numbers(tmp_path):
    """A system that writes a tensor into the world: the database's row and
    the CSV's are those of the same values as host numpy (the JAX
    package's driver given numpy)."""
    values = np.array([0.1, -2.5, 1e-17])
    srv = edb.Server.start(str(tmp_path / "db"))
    try:
        driver = fsw.HzDriver(
            1000.0, lambda w: setattr(w, "control_torque", torch.from_numpy(values)),
            TorqueWorld(), db_addr=srv.addr, publish=["control_torque"],
            csv_path=str(tmp_path / "ours.csv"))
        driver.run(max_ticks=3)
        driver.close()
        jtorque = ty.Annotated[np.ndarray, jel.Component(
            "control_torque", jel.ComponentType(jel.PrimitiveType.F64, (3,)))]

        @dataclass
        class JaxWorld:
            control_torque: jtorque = field(default_factory=lambda: np.zeros(3))

        ref = jfsw.HzDriver(1000.0, lambda w: setattr(w, "control_torque", values),
                            JaxWorld(), publish=["control_torque"],
                            csv_path=str(tmp_path / "ref.csv"))
        ref.run(max_ticks=3)
        ref.close()
        client = edb.Client.connect(srv.addr)
        _until(lambda: client.latest("control_torque") is not None, "the pushed torque")
        np.testing.assert_array_equal(client.latest("control_torque").values, values)
        client.close()
    finally:
        srv.stop()
    ours, theirs = ((tmp_path / f).read_text().splitlines() for f in ("ours.csv", "ref.csv"))
    assert ours[0] == theirs[0] == "time,control_torque"
    assert len(ours) == len(theirs) == 4
    assert [r.split(",", 1)[1] for r in ours[1:]] == [r.split(",", 1)[1] for r in theirs[1:]]


def test_serial_bridge_pty_to_db(tmp_path):
    """COBS-framed impeller2 packets written to a pty end up in the
    database (fsw/serial-bridge)."""
    srv = edb.Server.start(str(tmp_path / "db"))
    try:
        master, slave = os.openpty()
        bridge = SerialBridge(slave, srv.addr)
        vt = build_table_vtable([("uart.imu", "f64", (3,), 8, 24)], timestamp_offset=0)
        vt_id = bytes([6, 1])
        os.write(master, frame_packet_cobs(M.VTableMsg(vt_id, vt).packet()))
        os.write(master, frame_packet_cobs(M.SetComponentMetadata(
            component_id_of("uart.imu"), "uart.imu", {}).packet()))
        _until(lambda: bridge.frames_forwarded == 2, "the vtable and metadata")
        time.sleep(0.2)
        for i in range(5):
            body = struct.pack("<q", i * 10) + struct.pack("<3d", float(i), 0.5, -float(i))
            os.write(master, frame_packet_cobs(M.frame(M.TY_TABLE, vt_id, body)))
        _until(lambda: bridge.frames_forwarded == 7, "seven frames")
        client = edb.Client.connect(srv.addr)
        _latest(client, "uart.imu", 40)
        ts, vals = client.time_series("uart.imu")
        assert list(ts) == [0, 10, 20, 30, 40]
        np.testing.assert_allclose(vals[-1], [4.0, 0.5, -4.0])
        client.close()
        bridge.stop()
        os.close(master)
    finally:
        srv.stop()


def _blackbox_log(path, vt_mod, svc):
    """A blackbox log: a vtable, the component's name sent before its first
    row, ten rows, a timestamped message and a second table's rows."""
    vt = vt_mod.build_table_vtable([("bb.alt", "f64", (), 8, 8)], timestamp_offset=0)
    vt2 = vt_mod.build_table_vtable([("bb.att", "f32", (4,), 8, 16)], timestamp_offset=0)
    with open(path, "wb") as f:
        f.write(svc.frame_packet_cobs(M.VTableMsg(bytes([6, 2]), vt).packet()))
        f.write(svc.frame_packet_cobs(M.VTableMsg(bytes([6, 3]), vt2).packet()))
        f.write(svc.frame_packet_cobs(M.SetComponentMetadata(
            vt_mod.component_id_of("bb.att"), "bb.att", {"unit": "quat"}).packet()))
        for i in range(10):
            body = struct.pack("<q", i * 1000) + struct.pack("<d", i * 1.5)
            f.write(svc.frame_packet_cobs(M.frame(M.TY_TABLE, bytes([6, 2]), body)))
            body = struct.pack("<q", i * 1000 + 7) + struct.pack("<4f", 0.1 * i, 0, 0, 1)
            f.write(svc.frame_packet_cobs(M.frame(M.TY_TABLE, bytes([6, 3]), body)))
        f.write(svc.frame_packet_cobs(M.frame(
            M.TY_MSG_WITH_TIMESTAMP, msg_id("bb_event"),
            struct.pack("<q", 5000) + b"apogee")))
        f.write(b"\x05\x01\x02")  # a torn tail, as a log that lost power mid-write


def test_blackbox_decode(tmp_path):
    """A file of COBS frames replays into a Database (fsw/blackbox)."""
    from elodin_tpu_torch import fsw_services
    from elodin_tpu_torch.db import vtable

    log = tmp_path / "blackbox.bin"
    _blackbox_log(log, vtable, fsw_services)
    db = decode_blackbox(str(log))
    store = db.components[component_id_of("bb.alt")]
    assert store.len == 10
    assert store.values[9, 0] == 13.5
    assert db.components[component_id_of("bb.att")].name == "bb.att"
    assert db.msg_log(msg_id("bb_event")).entries == [(5000, b"apogee")]


def test_blackbox_decode_matches_jax_bitwise(tmp_path):
    """One log, written by the port's ``frame_packet_cobs``, decoded by both
    packages: the same stores, rows, metadata and message logs, bitwise;
    the JAX package's framing writes the same bytes."""
    from elodin_tpu.db import vtable as jvtable
    from elodin_tpu_torch import fsw_services
    from elodin_tpu_torch.db import vtable

    log, jlog = tmp_path / "ours.bin", tmp_path / "jax.bin"
    _blackbox_log(log, vtable, fsw_services)
    _blackbox_log(jlog, jvtable, jservices)
    assert log.read_bytes() == jlog.read_bytes()
    ours = decode_blackbox(str(log), str(tmp_path / "ours_db"))
    ref = jservices.decode_blackbox(str(log), str(tmp_path / "jax_db"))
    assert sorted(ours.components) == sorted(ref.components)
    assert len(ours.components) == 2
    for cid, store in ours.components.items():
        other = ref.components[cid]
        assert (store.prim, store.shape, store.name, store.metadata, store.len) == (
            other.prim, other.shape, other.name, other.metadata, other.len)
        n = store.len
        assert store.timestamps[:n].tobytes() == other.timestamps[:n].tobytes()
        assert store.values[:n].tobytes() == other.values[:n].tobytes()
    assert sorted(ours.msg_logs) == sorted(ref.msg_logs)
    for mid, mlog in ours.msg_logs.items():
        assert mlog.entries == ref.msg_logs[mid].entries
    ours.close()


def test_host_telemetry_bridge(tmp_path):
    """Host cpu / mem / load published into the database at a fixed rate
    (fsw/tegrastats-bridge)."""
    srv = edb.Server.start(str(tmp_path / "db"))
    try:
        bridge = HostTelemetryBridge(srv.addr, prefix="soc", rate_hz=20.0)
        _until(lambda: bridge.samples >= 5, "five samples")
        bridge.stop()
        client = edb.Client.connect(srv.addr)
        _until(lambda: len(client.time_series("soc.mem")[0]) >= 5, "five rows")
        ts, cpu = client.time_series("soc.cpu")
        _, mem = client.time_series("soc.mem")
        assert len(ts) >= 5
        assert (cpu >= 0.0).all() and (cpu <= 1.0).all()
        assert (mem[:, 1] > 0).all() and (mem[:, 0] <= mem[:, 1]).all()
        client.close()
    finally:
        srv.stop()


def test_status_banner(tmp_path):
    """``python -m elodin_tpu_torch.status``: the banner's sections and a
    live database's rows (fsw/aleph-status)."""
    srv = edb.Server.start(str(tmp_path / "db"))
    try:
        c = edb.Client.connect(srv.addr)
        c.send("imu.accel", np.array([0.1, 0.2, 9.81]), timestamp_us=1_000_000)
        _until(lambda: c.latest("imu.accel") is not None, "imu.accel")
        out = subprocess.run(
            [sys.executable, "-m", "elodin_tpu_torch.status", "--db-addr", srv.addr],
            capture_output=True, text=True, timeout=120, cwd=REPO,
            env={**os.environ, "PYTHONPATH": REPO, "NO_COLOR": "1"})
        assert out.returncode == 0, out.stderr
        for section in ("OS Info", "HW Info", "Accelerators", "Telemetry DB"):
            assert section in out.stdout, out.stdout
        assert "imu.accel" in out.stdout
        assert "9.81" in out.stdout
        backend = "cuda" if torch.cuda.is_available() else "none"
        assert f"Backend {backend}" in out.stdout
        c.close()
    finally:
        srv.stop()
