"""The port's telemetry server and client on the wire
(``elodin_tpu_torch.db``: server, client, follow), on the CPU.

Every case runs three ways: the port's ``Server`` with the port's
``Client``, the port's client against the JAX package's server, and the
JAX package's client against the port's server.  Cases: table writes and
``time_series``, component metadata, component and message streams,
``SubscribeLastUpdated``, fixed-rate replay, UDP ingest, follow
replication, a runt frame that must not kill the connection, and
``TableWriter.write_batch``.  The C++ client (``native/examples/
client.cpp``) runs against the port's server where ``g++`` exists, as
``tests/test_native_client.py`` runs it against the JAX package's.
"""

import os
import queue
import shutil
import socket
import struct
import subprocess
import threading
import time

import numpy as np
import pytest

import elodin_tpu.db as jdb
import elodin_tpu_torch.db as tdb
from elodin_tpu.db import follow as jfollow
from elodin_tpu_torch.db import follow as tfollow
from elodin_tpu_torch.db import msgs as M
from elodin_tpu_torch.db.postcard import msg_id
from elodin_tpu_torch.db.vtable import build_table_vtable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"jax": jdb, "torch": tdb}
FOLLOW = {"jax": jfollow, "torch": tfollow}
PAIRS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]  # (server, client)


@pytest.fixture(params=PAIRS, ids=lambda p: f"{p[0]}-server-{p[1]}-client")
def wire(request, tmp_path):
    server_pkg, client_pkg = request.param
    srv = PKG[server_pkg].Server.start(str(tmp_path / "db"))
    clients = []

    def connect():
        c = PKG[client_pkg].Client.connect(srv.addr)
        clients.append(c)
        return c

    yield srv, PKG[client_pkg], connect
    for c in clients:
        c.close()
    srv.stop()


def _holds(cond):
    try:
        return cond()
    except RuntimeError:  # "component ... not found": not written yet
        return False


def _wait(cond, timeout=10.0):
    """Poll ``cond`` until it holds: the server stores a client's writes
    asynchronously."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if _holds(cond):
            return True
        time.sleep(0.02)
    return _holds(cond)


def test_write_time_series_and_metadata(wire):
    srv, edb, connect = wire
    client = connect()
    writer = client.table_writer({"drone.imu.accel": edb.f64[3].labeled("x", "y", "z"),
                                  "drone.cmd.throttle": edb.f64})
    t0 = 1_000_000
    for i in range(10):
        writer.write(timestamp_us=t0 + i * 1000,
                     values={"drone.imu.accel": [0.0, 0.0, -9.81 + i],
                             "drone.cmd.throttle": 0.1 * i})
    assert _wait(lambda: len(client.time_series("drone.imu.accel", t0, t0 + 10_000)[0]) == 10)
    ts, accel = client.time_series("drone.imu.accel", t0, t0 + 10_000)
    np.testing.assert_array_equal(ts, t0 + np.arange(10) * 1000)
    np.testing.assert_allclose(accel[-1], [0.0, 0.0, -0.81])
    np.testing.assert_allclose(client.latest("drone.cmd.throttle").values, 0.9)
    assert client.earliest_timestamp() == t0
    comps = client.components()
    assert comps["drone.imu.accel"].shape == (3,)
    assert comps["drone.imu.accel"].metadata.get("element_names") == "x,y,z"
    writer.close()


def test_write_batch(wire):
    srv, edb, connect = wire
    client = connect()
    writer = client.table_writer({"blk.v": edb.f64[2]})
    n = 500
    writer.write_batch(np.arange(n) * 10, {"blk.v": np.stack([np.arange(n), -np.arange(n)], 1)})
    assert _wait(lambda: len(client.time_series("blk.v")[0]) == n)
    ts, vals = client.time_series("blk.v")
    assert ts[-1] == (n - 1) * 10
    np.testing.assert_allclose(vals[-1], [n - 1, -(n - 1)])
    writer.close()


def test_component_stream(wire):
    srv, edb, connect = wire
    client = connect()
    writer = client.table_writer({"sat.temp": edb.f64})
    writer.write(timestamp_us=1, values={"sat.temp": 20.0})
    assert _wait(lambda: client.latest("sat.temp") is not None)
    stream = client.stream(["sat.temp"])
    rows = []
    t = threading.Thread(target=lambda: rows.append(next(stream)), daemon=True)
    t.start()
    time.sleep(0.3)
    writer.write(timestamp_us=2, values={"sat.temp": 21.5})
    t.join(timeout=5)
    assert rows and "sat.temp" in rows[0]
    np.testing.assert_allclose(rows[0]["sat.temp"], 21.5)
    stream.close()
    writer.close()


def test_message_log_and_stream(wire):
    srv, edb, connect = wire
    client = connect()
    client.send_msg("race.collision", {"id": 1}, timestamp_us=500)
    client.send_msg("race.collision", {"id": 2}, timestamp_us=600)
    assert _wait(lambda: len(client.get_msgs("race.collision")) == 2)
    msgs = client.get_msgs("race.collision")
    assert [m[1]["id"] for m in msgs] == [1, 2] and [m[0] for m in msgs] == [500, 600]
    stream = client.msg_stream("events.ping")
    got = []
    t = threading.Thread(target=lambda: got.append(next(stream)), daemon=True)
    t.start()
    time.sleep(0.2)
    connect().send_msg("events.ping", "hello", timestamp_us=42)
    t.join(timeout=5)
    assert got and got[0][0] == 42 and got[0][1] == "hello"
    stream.close()


def test_subscribe_last_updated(wire):
    srv, edb, connect = wire
    client = connect()
    req_id = client._conn.next_req_id()
    q = client._conn.request_stream(M.SubscribeLastUpdated().packet(req_id), req_id)
    first = q.get(timeout=5)
    assert first.id == M.LastUpdated.ID
    writer = client.table_writer({"lu.x": edb.f64})
    writer.write(timestamp_us=12345, values={"lu.x": 1.0})
    latest = None
    deadline = time.time() + 5
    while time.time() < deadline and latest != 12345:
        try:
            latest = M.LastUpdated.decode(q.get(timeout=1).body).timestamp
        except queue.Empty:
            pass
    assert latest == 12345
    writer.close()


def test_fixed_rate_replay(wire):
    srv, edb, connect = wire
    client = connect()
    writer = client.table_writer({"r.x": edb.f64})
    for i in range(50):
        writer.write(timestamp_us=i * 1000, values={"r.x": float(i)})
    assert _wait(lambda: len(client.time_series("r.x")[0]) == 50)
    stream = client.stream(["r.x"], frequency=200)
    rows = []

    def consume():
        for _ in range(5):
            rows.append(next(stream))

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=10)
    assert len(rows) == 5
    vals = [float(r["r.x"]) for r in rows]
    assert vals == sorted(vals) and vals[0] <= 10.0
    stream.close()
    writer.close()


def test_udp_ingest(wire):
    srv, edb, connect = wire
    vt = build_table_vtable([("udp.x", "f64", (), 8, 8)], timestamp_offset=0)
    vt_id = bytes([7, 7])
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    addr = ("127.0.0.1", srv.port)
    try:
        sock.sendto(M.VTableMsg(vt_id, vt).packet(), addr)
        time.sleep(0.2)
        for i in range(4):
            sock.sendto(M.frame(M.TY_TABLE, vt_id, struct.pack("<qd", i * 100, 2.0 * i)), addr)
        sock.sendto(M.frame(M.TY_MSG_WITH_TIMESTAMP, msg_id("ulog"),
                            struct.pack("<q", 55) + b"\x05"), addr)
        client = connect()
        assert _wait(lambda: len(client.time_series("udp.x")[0]) == 4
                     and client.get_msgs("ulog"))
        ts, vals = client.time_series("udp.x")
        assert list(ts) == [0, 100, 200, 300] and list(vals) == [0.0, 2.0, 4.0, 6.0]
        assert client.get_msgs("ulog") == [(55, "\x05")]
    finally:
        sock.close()


def test_runt_frame_does_not_kill_connection(wire):
    srv, edb, connect = wire
    client = connect()
    writer = client.table_writer({"rn.x": edb.f64})
    writer.write(timestamp_us=1, values={"rn.x": 1.0})
    time.sleep(0.2)
    client._conn.send_bytes((0).to_bytes(4, "little"))
    client._conn.send_bytes((2).to_bytes(4, "little") + b"\x00\x01")
    time.sleep(0.2)
    writer.write(timestamp_us=2, values={"rn.x": 2.0})
    assert _wait(lambda: float(client.latest("rn.x").values) == 2.0)
    writer.close()


@pytest.mark.parametrize("leader_pkg,follower_pkg", [("torch", "torch"), ("jax", "torch"),
                                                      ("torch", "jax")])
def test_follow_replication(tmp_path, leader_pkg, follower_pkg):
    leader = PKG[leader_pkg].Server.start(str(tmp_path / "leader"))
    try:
        f = FOLLOW[follower_pkg].follow(leader.addr, str(tmp_path / "follower"))
        time.sleep(0.3)
        client = PKG[leader_pkg].Client.connect(leader.addr)
        writer = client.table_writer({"f.x": PKG[leader_pkg].f64})
        for i in range(5):
            writer.write(timestamp_us=i, values={"f.x": float(i)})
        assert _wait(lambda: f.rows_mirrored >= 5)
        store = f.db.by_name("f.x")
        assert store is not None and store.len >= 5
        np.testing.assert_array_equal(store.values[:5, 0], np.arange(5.0))
        f.stop()
        writer.close()
        client.close()
    finally:
        leader.stop()


def test_cpp_client_against_the_port(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    exe = tmp_path / "client"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O2", f"-I{os.path.join(ROOT, 'native', 'include')}",
         os.path.join(ROOT, "native", "examples", "client.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    srv = tdb.Server.start(str(tmp_path / "db"))
    try:
        proc = subprocess.run([str(exe), srv.addr.rsplit(":", 1)[1], "50"],
                              capture_output=True, text=True, timeout=30)
        assert proc.returncode == 0, proc.stderr
        assert "wrote 50 rows" in proc.stdout
        client = tdb.Client.connect(srv.addr)
        assert _wait(lambda: len(client.time_series("cpp.imu.accel", 0, 2**62)[0]) == 50)
        ts, accel = client.time_series("cpp.imu.accel", 0, 2**62)
        np.testing.assert_allclose(accel[0], [0.0, 0.0, -9.81])
        np.testing.assert_allclose(accel[-1], [0.0, 0.0, -9.81 + 0.49])
        assert ts[0] == 1_700_000_000_000_000
        assert client.time_series("cpp.status", 0, 2**62)[1][-1] == 49
        assert "cpp.imu.gyro" in client.components()
        msgs = client.get_msgs("cpp.events")
        assert msgs and msgs[0][1] == {"event": "boot"}
        client.close()
    finally:
        srv.stop()
