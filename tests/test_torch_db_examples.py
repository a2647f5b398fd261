"""The four database examples on the port, on the CPU, held to the JAX
package's: db-client, logstream, video-stream and udp-component-broadcast
(``elodin_tpu_torch/examples/{db_client,logstream,video_stream,
udp_component_broadcast}``).

* db-client end to end (``tests/test_examples.py::test_db_client_example``):
  its ball sim an s10 child (``--device cpu``), the client's live
  telemetry, SQL, sparkline and write back; the child's process group
  gone after.
* logstream (``test_logstream_producer_and_msg_persistence``): the
  producer into the port's server and into the JAX package's, the same
  stored entries; and the example's own run, the producer an s10 process
  beside the served ball sim.
* video-stream (``test_video_stream_frames_roundtrip``): frames through
  the port's server, and the rolling ball 240 ticks against the JAX
  example's within 1e-12 relative (max |Δ| / max |ref|).
* udp-component-broadcast (``tests/test_udp_broadcast.py``): the port's
  broadcaster and receiver between two port databases, and the port's
  broadcaster into the JAX example's receiver.  ``google.protobuf`` is
  imported in the child processes only.

Waits poll what they wait for, with deadlines.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import elodin_tpu.db as jdb
import elodin_tpu_torch.db as tdb
from elodin_tpu_torch.db.postcard import msg_id
from elodin_tpu_torch.db.storage import Database
from elodin_tpu_torch.examples.logstream import main as logstream
from elodin_tpu_torch.examples.video_stream import main as video_stream
from torch_port_util import float_policy, jax_example

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_UDP = os.path.join(REPO, "examples", "udp-component-broadcast")
UDP = "elodin_tpu_torch.examples.udp_component_broadcast"
PKG = {"jax": jdb, "torch": tdb}
TOL = 1e-12
WAIT_S = 60.0


def _free_port(kind=socket.SOCK_STREAM):
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    env.update(kw)
    return env


def _until(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while True:
        try:
            if cond():
                return
        except (OSError, RuntimeError):
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def test_db_client_example():
    """Full cross-process pipeline: sim serving over TCP, client reads live
    telemetry + SQL + writes back (reference examples/db-client)."""
    proc = subprocess.run(
        [sys.executable, "-m", "elodin_tpu_torch.examples.db_client.main",
         "--device", "cpu", "--addr", f"127.0.0.1:{_free_port()}"],
        env=_env(ELODIN_MAX_TICKS="400"), cwd=REPO,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "sql rows: 5" in proc.stdout
    assert "wrote ground.station_temp: 21.5" in proc.stdout
    assert "plot overview:" in proc.stdout


def test_db_client_run_reaps_its_sim():
    from elodin_tpu_torch.examples.db_client import main as db_client

    out = db_client.run(f"127.0.0.1:{_free_port()}", device="cpu",
                        env={"ELODIN_MAX_TICKS": "200"})
    assert "ball.world_pos" in out["components"]
    assert out["sql_rows"] == 5 and 0 < out["series_rows"] <= 50
    assert float(out["written"]) == 21.5 and len(out["latest"]) == 7
    with pytest.raises(ProcessLookupError):
        os.killpg(out["pgid"], 0)


@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
def test_logstream_producer_and_msg_persistence(tmp_path, server_pkg):
    """Producer -> server -> msg log -> reopen (the logstream example flow,
    plus the MsgLog reload path), into either package's server."""
    path = str(tmp_path / "db")
    srv = PKG[server_pkg].Server.start(path)
    try:
        n = logstream.log_producer(srv.addr, n=12)
        assert n == 12
        c = tdb.Client.connect(srv.addr)
        _until(lambda: len(c.get_msgs(logstream.LOG_TOPIC)) == 12, "12 log messages")
        c.close()
    finally:
        srv.stop()

    db = Database(path)
    log = db.msg_log(msg_id("fsw_log"))
    entries = [json.loads(d) for _, d in log.entries]
    assert len(entries) == 12
    assert entries[0]["message"].startswith("boot:")
    assert entries[-1]["level"] == 4
    assert [e["message"] for e in entries[3:10]] == [
        f"tick {i}: attitude nominal" for i in range(3, 10)]


def test_logstream_example_runs_its_producer_beside_the_sim(tmp_path):
    """``python -m ...logstream.main run ADDR --device cpu``: the ball sim
    serves while its s10 producer writes the 40 log messages."""
    addr = f"127.0.0.1:{_free_port()}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "elodin_tpu_torch.examples.logstream.main", "run", addr,
         "--device", "cpu"],
        env=_env(ELODIN_MAX_TICKS="120", ELODIN_KEEP_ALIVE="1",
                 ELODIN_DB_PATH=str(tmp_path / "db")),
        cwd=REPO, start_new_session=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        client = []

        def landed():
            if proc.poll() is not None:
                raise AssertionError(proc.stderr.read()[-2000:])
            if not client:
                client.append(tdb.Client.connect(addr))
            return (len(client[0].get_msgs(logstream.LOG_TOPIC)) == 40
                    and len(client[0].time_series("ball.world_pos")[0]) == 121)

        _until(landed, "40 log messages and 121 ball rows", timeout=120)
        msgs = client[0].get_msgs(logstream.LOG_TOPIC)
        last = msgs[-1][1]
        assert last == {"level": 4, "message": "nav: GPS fix lost"}
        client[0].close()
    finally:
        os.killpg(proc.pid, 15)
        proc.wait(timeout=30)


def test_video_stream_frames_roundtrip(tmp_path):
    """Opaque frame messages flow producer -> db -> consumer with the frame
    header intact (reference examples/video-stream data plane)."""
    srv = tdb.Server.start(str(tmp_path / "db"))
    try:
        n = video_stream.stream_frames(srv.addr, n_frames=12)
        assert n == 12
        client = tdb.Client.connect(srv.addr)
        _until(lambda: len(client.get_msgs(video_stream.STREAM_NAME)) == 12, "12 frames")
        msgs = client.get_msgs(video_stream.STREAM_NAME)
        client.close()
    finally:
        srv.stop()
    assert len(msgs) == 12
    payload = msgs[5][1]
    if isinstance(payload, str):
        payload = payload.encode("latin1")
    assert bytes(payload[:3]) == b"FRM"
    assert int.from_bytes(bytes(payload[3:7]), "little") == 5
    # ball sim runs alongside
    ex = video_stream.world().build(video_stream.system(),
                                    simulation_rate=1.0 / video_stream.SIM_TIME_STEP,
                                    device="cpu")
    ex.run(240, show_progress=False)
    p = np.asarray(ex.read_component("ball.world_pos")).ravel()[4:]
    assert np.all(np.abs(p[:2]) < video_stream.BOUNDARY + 0.5)


def test_video_stream_is_the_jax_example():
    """The same 240 ticks of the rolling ball in both packages, within
    1e-12 relative; the same frames, byte for byte."""
    jmod = jax_example("video-stream", "main")
    ticks = 240
    with float_policy("f64"):
        ours = video_stream.world().build(video_stream.system(),
                                          simulation_rate=1.0 / video_stream.SIM_TIME_STEP,
                                          device="cpu")
        ours.run(ticks, show_progress=False)
    ref = jmod.world().build(jmod.system(), simulation_rate=1.0 / jmod.SIM_TIME_STEP)
    ref.run(ticks, show_progress=False)
    for name in ("ball.world_pos", "ball.world_vel"):
        a = np.asarray(ours.read_component(name)).ravel()
        b = np.asarray(ref.read_component(name)).ravel()
        assert np.max(np.abs(a - b)) <= TOL * np.max(np.abs(b)), name
    for i in (0, 1, 77, 300):
        assert video_stream.make_frame(i) == jmod.make_frame(i)


def test_broadcast_between_two_dbs(tmp_path):
    """UDP component broadcast bridging two port databases
    (fsw/udp_component_broadcast parity)."""
    _broadcast(tmp_path, [sys.executable, "-m", f"{UDP}.receive"], REPO, tdb)


def test_port_broadcast_into_the_jax_receiver(tmp_path):
    _broadcast(tmp_path, [sys.executable, "receive.py"], JAX_UDP, jdb)


def _broadcast(tmp_path, receive_cmd, receive_cwd, dst_pkg):
    src = tdb.Server.start(str(tmp_path / "src"))
    dst = dst_pkg.Server.start(str(tmp_path / "dst"))
    try:
        cs = tdb.Client.connect(src.addr)
        pos = np.array([0.0, 0.0, 0.0, 1.0, 1.0, 2.0, 3.0])
        for i in range(5):
            cs.send("bdx.world_pos", pos + 0.1 * i, timestamp_us=1_000_000 + i * 1000)
        _until(lambda: len(cs.time_series("bdx.world_pos")[0]) == 5, "5 source rows")

        port = _free_port(socket.SOCK_DGRAM)
        recv = subprocess.Popen(
            receive_cmd + ["--listen", f"127.0.0.1:{port}", "--db-addr", dst.addr,
                           "--max-samples", "3", "--timeout", "60"],
            cwd=receive_cwd, env=_env(JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        # the receiver's readiness line, never a fixed sleep
        line = recv.stdout.readline()
        assert "listening" in line, line + recv.stderr.read()
        bcast = subprocess.run(
            [sys.executable, "-m", f"{UDP}.broadcast",
             "--db-addr", src.addr,
             "--component", "bdx.world_pos",
             "--rename", "target.world_pos",
             "--rate", "50",
             "--target", f"127.0.0.1:{port}",
             "--source-id", "bdx",
             "--max-samples", "6"],
            cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60,
        )
        assert bcast.returncode == 0, bcast.stderr
        assert "broadcast 6 samples" in bcast.stdout
        out, err = recv.communicate(timeout=90)
        assert recv.returncode == 0, err
        assert "received 3 samples (0 lost)" in out

        cd = tdb.Client.connect(dst.addr)
        _until(lambda: len(cd.time_series("target.world_pos")[0]) == 3, "3 received rows")
        sample = cd.latest("target.world_pos")
        assert sample is not None
        np.testing.assert_array_equal(sample.values, pos + 0.4)
        assert sample.timestamp_us == 1_004_000  # source timestamp carried
        assert "bdx.world_pos" not in cd.components()  # renamed, not mirrored
        cd.close()
        cs.close()
    finally:
        src.stop()
        dst.stop()
