"""MSP DisplayPort OSD service — renders live telemetry as a character grid
and streams it to a video transmitter over MSP, or to the terminal in debug
mode (counterpart of ``elodin_tpu/msp_osd.py``).

Parity: fsw/msp-osd — MSP v1/v2 framing with the DisplayPort subcommands
(src/backends/displayport.rs:13-24), the in-memory OSD character grid
(src/osd_grid.rs), a telemetry processor fed from elodin-db world_pos /
world_vel (src/telemetry.rs, src/db_client.rs), and the HUD layout: compass
tape, altitude/speed boxes, artificial horizon, status bar (src/layout.rs).

A host-only copy over the port's ``db.Client``: the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np

MSP_DISPLAYPORT = 182
MSP_DP_HEARTBEAT = 0
MSP_DP_CLEAR_SCREEN = 2
MSP_DP_WRITE_STRING = 3
MSP_DP_DRAW_SCREEN = 4
MSP_DP_OPTIONS = 5
MSP2_COMMON_SET_RECORDING = 0x3005


def crc8_dvb_s2(data: bytes) -> int:
    """CRC-8/DVB-S2 (poly 0xD5), used by MSP v2."""
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0xD5) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def encode_msp_v1(cmd: int, payload: bytes) -> bytes:
    """``$M>`` + size + cmd + payload + xor checksum
    (displayport.rs:69-91)."""
    if len(payload) > 255:
        raise ValueError(
            f"MSP v1 payload is {len(payload)} bytes (max 255) — a masked "
            "size byte would desync the VTX parser"
        )
    out = bytearray(b"$M>")
    out.append(len(payload) & 0xFF)
    out.append(cmd & 0xFF)
    cksum = (len(payload) & 0xFF) ^ (cmd & 0xFF)
    for b in payload:
        out.append(b)
        cksum ^= b
    out.append(cksum)
    return bytes(out)


def encode_msp_v2(cmd: int, payload: bytes) -> bytes:
    """``$X<`` + flags + cmd:2LE + size:2LE + payload + crc8-dvb-s2 over
    everything after the 3-byte header (displayport.rs:97-119)."""
    out = bytearray(b"$X<")
    out.append(0)  # flags
    out += int(cmd).to_bytes(2, "little")
    out += len(payload).to_bytes(2, "little")
    out += payload
    out.append(crc8_dvb_s2(bytes(out[3:])))
    return bytes(out)


class OsdGrid:
    """In-memory text grid (osd_grid.rs). HD DisplayPort is 18x50; analog
    PAL/NTSC is 16x30."""

    def __init__(self, rows: int = 18, cols: int = 50):
        self.rows = rows
        self.cols = cols
        self.cells = [[" "] * cols for _ in range(rows)]

    def clear(self) -> None:
        for row in self.cells:
            for c in range(self.cols):
                row[c] = " "

    def set_char(self, row: int, col: int, ch: str) -> None:
        if 0 <= row < self.rows and 0 <= col < self.cols:
            self.cells[row][col] = ch

    def write_text(self, row: int, col: int, text: str) -> None:
        if not 0 <= row < self.rows:
            return
        for c, ch in zip(range(col, self.cols), text):
            if c >= 0:
                self.cells[row][c] = ch

    def write_centered(self, row: int, text: str) -> None:
        start = max(0, (self.cols - len(text)) // 2)
        self.write_text(row, start, text)

    def write_right_aligned(self, row: int, text: str) -> None:
        self.write_text(row, max(0, self.cols - len(text)), text)

    def line(self, row: int) -> str:
        return "".join(self.cells[row])

    def non_empty_lines(self):
        for r in range(self.rows):
            text = self.line(r)
            if text.strip():
                yield r, text


# -- telemetry ---------------------------------------------------------------


@dataclass
class TelemetryState:
    """World-frame pose/velocity decoded from elodin components
    (telemetry.rs — quaternions arrive [x, y, z, w])."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    quat_xyzw: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0])
    )
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(3))
    target_position: np.ndarray | None = None
    db_connected: bool = False
    update_count: int = 0

    def update_world_pos(self, spatial7: np.ndarray) -> None:
        """SpatialTransform wire layout: [qx qy qz qw, x y z]."""
        s = np.asarray(spatial7, dtype=np.float64).reshape(-1)
        self.quat_xyzw = s[:4].copy()
        self.position = s[4:7].copy()
        self.update_count += 1

    def update_world_vel(self, spatial6: np.ndarray) -> None:
        """SpatialMotion wire layout: [wx wy wz, vx vy vz]."""
        s = np.asarray(spatial6, dtype=np.float64).reshape(-1)
        self.velocity = s[3:6].copy()

    # derived quantities ------------------------------------------------

    def altitude_m(self) -> float:
        return float(self.position[2])

    def speed_ms(self) -> float:
        return float(np.linalg.norm(self.velocity))

    def euler_deg(self) -> tuple[float, float, float]:
        """(roll, pitch, yaw) in degrees, ZYX convention."""
        x, y, z, w = self.quat_xyzw
        roll = math.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        sp = 2 * (w * y - z * x)
        pitch = math.asin(max(-1.0, min(1.0, sp)))
        yaw = math.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        return math.degrees(roll), math.degrees(pitch), math.degrees(yaw)

    def heading_deg(self) -> float:
        """Compass heading: course over ground when moving, else yaw."""
        vx, vy = self.velocity[0], self.velocity[1]
        if vx * vx + vy * vy > 0.25:
            return (math.degrees(math.atan2(vy, vx)) + 360.0) % 360.0
        return (self.euler_deg()[2] + 360.0) % 360.0


# -- layout ------------------------------------------------------------------

_COMPASS = ["N", ".", ".", "E", ".", ".", "S", ".", ".", "W", ".", "."]


def render(grid: OsdGrid, state: TelemetryState) -> None:
    """HUD layout (layout.rs): compass tape top-center, speed left,
    altitude right, artificial-horizon pitch ladder center, status bar
    bottom."""
    grid.clear()
    # compass tape: 9 cells centered on the heading
    hdg = state.heading_deg()
    cells = []
    for k in range(-4, 5):
        idx = int(round((hdg + k * 30.0) / 30.0)) % 12
        cells.append(_COMPASS[idx])
    grid.write_centered(0, " ".join(cells))
    grid.write_centered(1, f"{hdg:5.1f}")
    # left: speed, right: altitude
    mid = grid.rows // 2
    grid.write_text(mid, 1, f"SPD {state.speed_ms():6.1f}")
    grid.write_right_aligned(mid, f"ALT {state.altitude_m():7.1f} ")
    # artificial horizon: roll-tilted line through the center
    roll, pitch, _ = state.euler_deg()
    half = min(8, grid.cols // 2 - 12)
    pitch_off = int(round(pitch / 10.0))
    for dx in range(-half, half + 1):
        dy = -dx * math.tan(math.radians(max(-60, min(60, roll))))
        r = mid - pitch_off + int(round(dy * 0.5))
        grid.set_char(r, grid.cols // 2 + dx, "-")
    grid.set_char(mid, grid.cols // 2, "+")
    # target marker when present: bearing arrow + distance
    if state.target_position is not None:
        d = state.target_position - state.position
        dist = float(np.linalg.norm(d))
        bearing = (math.degrees(math.atan2(d[1], d[0])) + 360.0) % 360.0
        rel = (bearing - hdg + 540.0) % 360.0 - 180.0
        arrow = "^" if abs(rel) < 45 else (">" if rel > 0 else "<")
        grid.write_centered(2, f"TGT {arrow} {dist:6.0f}m")
    # status bar
    status = "RDY" if state.update_count else "INIT"
    link = "DB" if state.db_connected else "--"
    grid.write_text(
        grid.rows - 1, 1,
        f"{status} {link} n={state.update_count}",
    )


# -- backends ----------------------------------------------------------------


class DisplayPortBackend:
    """Streams the grid as MSP DisplayPort frames to a serial port or any
    writable binary stream (displayport.rs render loop: heartbeat each
    500 ms, clear, one WRITE_STRING per non-empty line, draw)."""

    def __init__(self, port, heartbeat_s: float = 0.5):
        self.port = port
        self.heartbeat_s = heartbeat_s
        self._last_hb = 0.0

    def _send(self, cmd_payload: bytes) -> None:
        self.port.write(encode_msp_v1(MSP_DISPLAYPORT, cmd_payload))

    def init(self) -> None:
        self._send(bytes([MSP_DP_OPTIONS, 0]))
        self._send(bytes([MSP_DP_HEARTBEAT]))
        self._last_hb = time.monotonic()

    def render(self, grid: OsdGrid) -> None:
        now = time.monotonic()
        if now - self._last_hb > self.heartbeat_s:
            self._send(bytes([MSP_DP_HEARTBEAT]))
            self._last_hb = now
        self._send(bytes([MSP_DP_CLEAR_SCREEN]))
        for row, text in grid.non_empty_lines():
            start = len(text) - len(text.lstrip(" "))
            trimmed = text.strip()
            payload = (
                bytes([MSP_DP_WRITE_STRING, row, start, 0])
                + trimmed.encode("ascii", "replace")
                + b"\x00"
            )
            self._send(payload)
        self._send(bytes([MSP_DP_DRAW_SCREEN]))
        if hasattr(self.port, "flush"):
            self.port.flush()

    def set_recording(self, start: bool) -> None:
        self.port.write(
            encode_msp_v2(
                MSP2_COMMON_SET_RECORDING, bytes([1 if start else 0])
            )
        )

    def cleanup(self) -> None:
        self._send(bytes([MSP_DP_CLEAR_SCREEN]))
        self._send(bytes([MSP_DP_DRAW_SCREEN]))


class TerminalBackend:
    """Debug mode: draw the grid to stdout (backends/terminal.rs)."""

    def __init__(self, out=None):
        self.out = out or sys.stdout

    def init(self) -> None:
        pass

    def render(self, grid: OsdGrid) -> None:
        self.out.write("\x1b[2J\x1b[H" if self.out.isatty() else "")
        self.out.write("+" + "-" * grid.cols + "+\n")
        for r in range(grid.rows):
            self.out.write("|" + grid.line(r) + "|\n")
        self.out.write("+" + "-" * grid.cols + "+\n")
        self.out.flush()

    def cleanup(self) -> None:
        pass


# -- service -----------------------------------------------------------------


class MspOsdService:
    """Tails an entity's world_pos/world_vel from the DB and renders the OSD
    at a fixed rate (main.rs + db_client.rs loop)."""

    def __init__(self, db_addr: str, entity: str, backend,
                 target_entity: str | None = None,
                 rows: int = 18, cols: int = 50, rate_hz: float = 10.0):
        self.db_addr = db_addr
        self.entity = entity
        self.target_entity = target_entity
        self.backend = backend
        self.grid = OsdGrid(rows, cols)
        self.rate_hz = rate_hz
        self.state = TelemetryState()

    def step(self, client) -> None:
        got = False
        try:
            pos = client.latest(f"{self.entity}.world_pos")
            if pos is not None:
                self.state.update_world_pos(pos.values)
                got = True
            vel = client.latest(f"{self.entity}.world_vel")
            if vel is not None:
                self.state.update_world_vel(vel.values)
                got = True
            if self.target_entity:
                tgt = client.latest(f"{self.target_entity}.world_pos")
                if tgt is not None:
                    self.state.target_position = np.asarray(
                        tgt.values, dtype=np.float64
                    ).reshape(-1)[4:7]
        except Exception:
            got = False  # DB unreachable: keep rendering the last state
        self.state.db_connected = got
        render(self.grid, self.state)
        self.backend.render(self.grid)

    def run(self, max_frames: int | None = None) -> int:
        from .db import Client

        client = Client.connect(self.db_addr)
        self.backend.init()
        frames = 0
        period = 1.0 / self.rate_hz
        try:
            while max_frames is None or frames < max_frames:
                t0 = time.monotonic()
                if client is None:
                    # DB restarted: keep trying to reattach (the reference
                    # db_client loop reconnects) while the OSD renders the
                    # stale state with the link-down flag
                    try:
                        client = Client.connect(self.db_addr)
                    except Exception:  # noqa: BLE001
                        client = None
                self.step(client)
                if not self.state.db_connected and client is not None:
                    # connection went dead mid-flight: drop it so the next
                    # frame reconnects instead of polling a dead socket
                    try:
                        client.close()
                    except Exception:  # noqa: BLE001
                        pass
                    client = None
                frames += 1
                time.sleep(max(0.0, period - (time.monotonic() - t0)))
        except KeyboardInterrupt:
            pass
        finally:
            self.backend.cleanup()
            client.close()
        return frames


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="elodin-msp-osd",
        description="MSP DisplayPort OSD service fed from elodin-db",
    )
    p.add_argument("--db-addr", default="127.0.0.1:2240")
    p.add_argument("--entity", default="drone")
    p.add_argument("--target-entity", default=None)
    p.add_argument("--mode", choices=("debug", "serial"), default="debug")
    p.add_argument("--serial-port", default=None)
    p.add_argument("--rate", type=float, default=10.0)
    p.add_argument("--rows", type=int, default=18)
    p.add_argument("--cols", type=int, default=50)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--auto-record", action="store_true")
    args = p.parse_args(argv)

    if args.mode == "serial":
        if not args.serial_port:
            p.error("--serial-port is required in serial mode")
        port = open(args.serial_port, "wb", buffering=0)
        backend = DisplayPortBackend(port)
        if args.auto_record:
            backend.set_recording(True)
    else:
        backend = TerminalBackend()
    svc = MspOsdService(
        args.db_addr, args.entity, backend,
        target_entity=args.target_entity,
        rows=args.rows, cols=args.cols, rate_hz=args.rate,
    )
    n = svc.run(max_frames=args.max_frames)
    print(f"rendered {n} OSD frames", file=sys.stderr)


if __name__ == "__main__":
    main()
