"""The port's MSP DisplayPort OSD (``elodin_tpu_torch.msp_osd``), on the
CPU: the five cases of ``tests/test_msp_osd.py``, then the same
``TelemetryState`` rendered by both packages, which gives identical grids,
MSP bytes and terminal frames."""

import io
import math
import time

import numpy as np
import pytest

from elodin_tpu import msp_osd as josd
from elodin_tpu_torch import msp_osd as osd
from elodin_tpu_torch.db import Client, Server


def _parse_msp(stream: bytes):
    """An MSP v1 / v2 frame parser of its own, to read the bytes sent."""
    frames = []
    i = 0
    while i < len(stream):
        assert stream[i] == ord("$")
        if stream[i + 1] == ord("M"):
            size, cmd = stream[i + 3], stream[i + 4]
            payload = stream[i + 5:i + 5 + size]
            x = size ^ cmd
            for b in payload:
                x ^= b
            assert x == stream[i + 5 + size], "MSPv1 checksum mismatch"
            frames.append(("v1", cmd, bytes(payload)))
            i += 6 + size
        else:
            assert stream[i + 1] == ord("X")
            cmd = int.from_bytes(stream[i + 4:i + 6], "little")
            size = int.from_bytes(stream[i + 6:i + 8], "little")
            frames.append(("v2", cmd, bytes(stream[i + 8:i + 8 + size])))
            i += 9 + size
    return frames


def test_crc8_dvb_s2_check_value():
    assert osd.crc8_dvb_s2(b"123456789") == 0xBC  # the published check value
    assert osd.crc8_dvb_s2(b"") == 0


def test_msp_frame_encoding():
    f = osd.encode_msp_v1(osd.MSP_DISPLAYPORT, b"\x03\x02\x05\x00hi\x00")
    assert f[:3] == b"$M>"
    assert _parse_msp(f) == [("v1", 182, b"\x03\x02\x05\x00hi\x00")]
    f2 = osd.encode_msp_v2(osd.MSP2_COMMON_SET_RECORDING, b"\x01")
    assert f2[:3] == b"$X<"
    assert f2[-1] == osd.crc8_dvb_s2(f2[3:-1])
    assert _parse_msp(f2) == [("v2", 0x3005, b"\x01")]
    with pytest.raises(ValueError, match="max 255"):
        osd.encode_msp_v1(osd.MSP_DISPLAYPORT, bytes(256))


def test_osd_grid():
    g = osd.OsdGrid(4, 10)
    g.write_text(1, 2, "hello")
    assert g.line(1) == "  hello   "
    g.write_centered(2, "ab")
    assert g.line(2) == "    ab    "
    g.write_right_aligned(3, "xy")
    assert g.line(3) == "        xy"
    g.write_text(0, 8, "clip-me")  # clipped at the right edge
    assert g.line(0) == "        cl"
    g.write_text(9, 0, "off")  # an off-grid row is ignored
    assert [r for r, _ in g.non_empty_lines()] == [0, 1, 2, 3]
    g.clear()
    assert list(g.non_empty_lines()) == []


def test_telemetry_derivations():
    s = osd.TelemetryState()
    half = math.radians(15)  # 30 degrees of yaw about z, at (1, 2, 120)
    s.update_world_pos(np.array([0.0, 0.0, math.sin(half), math.cos(half), 1.0, 2.0, 120.0]))
    s.update_world_vel(np.array([0.0, 0.0, 0.0, 3.0, 4.0, 0.0]))
    assert s.altitude_m() == 120.0
    assert abs(s.speed_ms() - 5.0) < 1e-12
    roll, pitch, yaw = s.euler_deg()
    assert abs(roll) < 1e-9 and abs(pitch) < 1e-9
    assert abs(yaw - 30.0) < 1e-9
    # moving: the heading is the course over ground, not the yaw
    assert abs(s.heading_deg() - math.degrees(math.atan2(4, 3))) < 1e-9
    s.update_world_vel(np.zeros(6))
    assert abs(s.heading_deg() - 30.0) < 1e-9


def test_osd_service_live_db(tmp_path):
    """A live port database -> the MSP DisplayPort byte stream."""
    srv = Server.start(str(tmp_path / "db"))
    try:
        c = Client.connect(srv.addr)
        c.send("drone.world_pos", np.array([0.0, 0.0, 0.0, 1.0, 10.0, 20.0, 55.5]),
               timestamp_us=1_000_000)
        c.send("drone.world_vel", np.array([0.0, 0.0, 0.0, 6.0, 8.0, 0.0]),
               timestamp_us=1_000_000)
        c.send("tgt.world_pos", np.array([0.0, 0.0, 0.0, 1.0, 100.0, 20.0, 55.5]),
               timestamp_us=1_000_000)
        for name in ("drone.world_pos", "drone.world_vel", "tgt.world_pos"):
            for _ in range(250):
                if c.latest(name) is not None:
                    break
                time.sleep(0.02)
        buf = io.BytesIO()
        svc = osd.MspOsdService(srv.addr, "drone", osd.DisplayPortBackend(buf),
                                target_entity="tgt", rate_hz=50.0)
        assert svc.run(max_frames=2) == 2
        c.close()
    finally:
        srv.stop()
    frames = _parse_msp(buf.getvalue())
    subcmds = [p[0] for v, cmd, p in frames if (v, cmd) == ("v1", 182)]
    # init: options and a heartbeat; then a frame: clear, writes, draw
    assert subcmds[:2] == [osd.MSP_DP_OPTIONS, osd.MSP_DP_HEARTBEAT]
    assert subcmds.count(osd.MSP_DP_CLEAR_SCREEN) == 3  # 2 frames and the cleanup
    assert subcmds.count(osd.MSP_DP_DRAW_SCREEN) == 3
    writes = [p for v, cmd, p in frames
              if (v, cmd) == ("v1", 182) and p[0] == osd.MSP_DP_WRITE_STRING]
    texts = [w[4:-1].decode() for w in writes]
    assert any("ALT    55.5" in t for t in texts), texts
    assert any("SPD   10.0" in t for t in texts), texts
    assert any(t.startswith("TGT") for t in texts), texts
    assert any("RDY DB" in t for t in texts), texts
    for w in writes:
        assert w[1] < 18 and w[2] < 50


@pytest.mark.parametrize("rows,cols", [(18, 50), (16, 30)])
def test_one_state_renders_alike_in_both_packages(rows, cols):
    """The same telemetry (rolled, pitched, moving, with a target) through
    both packages' ``render`` and back ends: the same grid, the same MSP
    bytes (init, a frame, recording, cleanup) and the same terminal frame."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    pos = np.concatenate([q, [12.0, -40.0, 310.25]])
    vel = np.array([0.1, -0.2, 0.3, 14.0, -3.0, 1.5])
    out = []
    for pkg in (osd, josd):
        state = pkg.TelemetryState()
        state.update_world_pos(pos)
        state.update_world_vel(vel)
        state.target_position = np.array([500.0, 200.0, 300.0])
        state.db_connected = True
        grid = pkg.OsdGrid(rows, cols)
        pkg.render(grid, state)
        buf = io.BytesIO()
        backend = pkg.DisplayPortBackend(buf, heartbeat_s=3600.0)
        backend.init()
        backend.render(grid)
        backend.set_recording(True)
        backend.cleanup()
        term = io.StringIO()
        pkg.TerminalBackend(term).render(grid)
        out.append(([grid.line(r) for r in range(rows)], buf.getvalue(), term.getvalue()))
    assert out[0] == out[1]
    assert any("TGT" in line for line in out[0][0])
