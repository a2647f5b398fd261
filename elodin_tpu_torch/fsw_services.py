"""FSW service equivalents: serial-bridge and blackbox (counterpart of
``elodin_tpu/fsw_services.py``).

The reference runs these as standalone Rust binaries on the flight computer
(fsw/serial-bridge/src/main.rs: UART -> COBS-framed impeller2 packets ->
DB; fsw/blackbox: decode SD-card logs into the DB).  Here they are Python
services over the same wire formats (COBS framing from db/framing.py,
packets from db/msgs.py), testable against a pty / log file.

A host-only copy over the port's ``db/``: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import os
import threading

from .db import msgs as M
from .db.framing import CobsStream, cobs_encode
from .db.storage import Database, now_timestamp_us
from .db.vtable import VTable


class SerialBridge:
    """Bridge a COBS-framed serial byte stream into an elodin-db server
    (fsw/serial-bridge/src/main.rs).

    Each COBS frame carries one impeller2 packet WITHOUT the 4-byte length
    prefix (the frame boundary is the length).  Table packets are realized
    against vtables previously registered on the stream; msg packets are
    appended to the DB's msg logs.
    """

    def __init__(self, fd: int, db_addr: str):
        from .db.client import _Conn

        self.fd = fd
        if os.isatty(fd):
            # serial/pty endpoints must be raw: canonical mode cooks the
            # binary stream (CR/LF translation, echo, EOF chars)
            import tty

            tty.setraw(fd)
        self.conn = _Conn(db_addr)
        self.stream = CobsStream()
        self.frames_forwarded = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="serial-bridge")
        self._thread.start()

    def _pump(self) -> None:
        while not self._stop.is_set():
            try:
                chunk = os.read(self.fd, 4096)
            except OSError:
                break
            if not chunk:
                break
            try:
                frames = list(self.stream.feed(chunk))
            except ValueError:
                # corrupt/partial COBS frame (mid-stream attach, line
                # noise): drop buffered bytes and resync at the next
                # delimiter instead of killing the pump thread forever
                self.stream = CobsStream()
                self.dropped_frames = getattr(self, "dropped_frames", 0) + 1
                continue
            for frame in frames:
                if len(frame) < M.PACKET_HEADER_LEN:
                    continue
                # re-frame with the TCP length prefix and forward verbatim
                self.conn.send_bytes(
                    len(frame).to_bytes(4, "little") + frame
                )
                self.frames_forwarded += 1

    def stop(self) -> None:
        self._stop.set()
        try:
            os.close(self.fd)
        except OSError:
            pass
        self._thread.join(timeout=2)
        self.conn.close()


def frame_packet_cobs(pkt_with_len: bytes) -> bytes:
    """Encode one length-prefixed packet as a COBS frame (strip the TCP
    length prefix; the frame boundary carries it).  cobs_encode already
    appends the 0x00 delimiter — adding another would emit a spurious
    empty frame per packet (strict embedded decoders reject those)."""
    return cobs_encode(pkt_with_len[4:])


class BlackboxDecoder:
    """Decode a COBS-framed packet log (the blackbox SD format:
    back-to-back zero-terminated COBS frames of impeller2 packets) into a
    Database (fsw/blackbox equivalent)."""

    def __init__(self, db: Database):
        self.db = db
        self.vtables: dict[bytes, VTable] = {}
        self.rows = 0
        self.msgs = 0
        # metadata that arrived before its component's first row
        self._pending_meta: dict[int, tuple] = {}

    def feed_file(self, path: str) -> "BlackboxDecoder":
        stream = CobsStream()
        with open(path, "rb") as f:
            while True:
                chunk = f.read(1 << 16)
                if not chunk:
                    break
                try:
                    frames = list(stream.feed(chunk))
                except ValueError:
                    # torn tail / corrupt frame in an SD log that lost
                    # power mid-write: resync at the next delimiter
                    stream = CobsStream()
                    continue
                for frame in frames:
                    self._handle(frame)
        return self

    def _handle(self, frame: bytes) -> None:
        if len(frame) < M.PACKET_HEADER_LEN:
            return
        pkt = M.parse_packet(frame)
        if pkt.ty == M.TY_MSG and pkt.id == M.VTableMsg.ID:
            vtm = M.VTableMsg.decode(pkt.body)
            self.vtables[vtm.id] = vtm.vtable
            self.db.vtables[vtm.id] = vtm.vtable
        elif pkt.ty == M.TY_TABLE:
            vt = self.vtables.get(pkt.id)
            if vt is None:
                return
            default_ts = now_timestamp_us()
            for f in vt.realize_fields(pkt.body):
                cid = f["component_id"]
                if cid is None or f["ty"] is None:
                    continue
                store = self.db.get_or_create(cid, f["ty"], f["shape"])
                pend = self._pending_meta.pop(cid, None)
                if pend is not None:
                    store.set_metadata(name=pend[0], metadata=pend[1])
                ts = f["timestamp"] if f["timestamp"] is not None else default_ts
                store.append(ts, f["data"])
                self.rows += 1
        elif pkt.ty == M.TY_MSG_WITH_TIMESTAMP:
            ts = int.from_bytes(pkt.body[:8], "little", signed=True)
            self.db.msg_log(pkt.id).append(ts, pkt.body[8:])
            self.msgs += 1
        elif pkt.ty == M.TY_MSG and pkt.id == M.SetComponentMetadata.ID:
            # control-plane metadata must be APPLIED (the serial stream
            # carries the same SetComponentMetadata frames the TCP path
            # does) or decoded databases lose every component name,
            # breaking SQL table naming and display
            m = M.SetComponentMetadata.decode(pkt.body)
            store = self.db.components.get(m.component_id)
            if store is not None:
                store.set_metadata(name=m.name, metadata=m.metadata)
            else:
                self._pending_meta[m.component_id] = (m.name, dict(m.metadata))
        elif pkt.ty == M.TY_MSG and pkt.id in M.MSG_TYPES:
            pass  # other control-plane msgs need a live reply path; skip
        elif pkt.ty == M.TY_MSG:
            self.db.msg_log(pkt.id).append(now_timestamp_us(), pkt.body)
            self.msgs += 1


def decode_blackbox(log_path: str, db_path: str | None = None) -> Database:
    """CLI-style one-shot: decode a blackbox log into a (new) Database."""
    db = Database(db_path)
    BlackboxDecoder(db).feed_file(log_path)
    return db


class HostTelemetryBridge:
    """Publish host/SoC stats into the DB at a fixed rate
    (fsw/tegrastats-bridge equivalent, generalized from Jetson tegrastats
    to /proc): cpu busy fraction, mem used/total, load average, under
    ``<prefix>.cpu`` / ``<prefix>.mem`` / ``<prefix>.load``."""

    def __init__(self, db_addr: str, prefix: str = "host",
                 rate_hz: float = 1.0):
        from .db.client import Client, f64

        self.client = Client.connect(db_addr)
        self.writer = self.client.table_writer(
            {
                f"{prefix}.cpu": f64,
                f"{prefix}.mem": f64[2].labeled("used_kb", "total_kb"),
                f"{prefix}.load": f64,
            }
        )
        self.rate_hz = rate_hz
        self.samples = 0
        self._prev_cpu: tuple[int, int] | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="host-telemetry")
        self._thread.start()

    @staticmethod
    def _cpu_times() -> tuple[int, int]:
        with open("/proc/stat") as f:
            parts = f.readline().split()[1:]
        vals = [int(p) for p in parts]
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
        return sum(vals), idle

    @staticmethod
    def _mem_kb() -> tuple[float, float]:
        total = avail = 0.0
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = float(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = float(line.split()[1])
        return total - avail, total

    def sample(self) -> dict:
        total, idle = self._cpu_times()
        busy = 0.0
        if self._prev_cpu is not None:
            dt_total = total - self._prev_cpu[0]
            dt_idle = idle - self._prev_cpu[1]
            busy = 1.0 - dt_idle / dt_total if dt_total else 0.0
        self._prev_cpu = (total, idle)
        used, total_kb = self._mem_kb()
        return {
            "cpu": busy,
            "mem": [used, total_kb],
            "load": os.getloadavg()[0],
        }

    def _pump(self) -> None:
        prefix = self.writer.fields[0].name.rsplit(".", 1)[0]
        while not self._stop.wait(1.0 / self.rate_hz):
            s = self.sample()
            try:
                self.writer.write(
                    timestamp_us=now_timestamp_us(),
                    values={
                        f"{prefix}.cpu": s["cpu"],
                        f"{prefix}.mem": s["mem"],
                        f"{prefix}.load": s["load"],
                    },
                )
                self.samples += 1
            except Exception:
                break

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        self.writer.close()
        self.client.close()
