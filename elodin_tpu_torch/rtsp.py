"""RTSP H.264 ingest into elodin-db message logs (counterpart of
``elodin_tpu/rtsp.py``).

Parity: libs/rtsp-ingest (AVCC→Annex-B reframing with SPS/PPS injection,
source-PTS→DB-timestamp clock mapping — src/annexb.rs, src/clock.rs) plus the
fsw/rtsp-streamer producer binary that drives an RTSP session into the DB.
The reference splits these because its session manager is the `retina` crate;
this package ships a self-contained minimal RTSP/RTP-over-TCP client:

- `ClockMapper` — anchors the first frame to a base timestamp, adds per-frame
  PTS deltas, and enforces strict monotonicity (MsgLog binary-searches its
  timestamps).
- `AnnexBConverter` — length-prefixed AVC access units → Annex-B, injecting
  out-of-band SPS/PPS ahead of IDR pictures so keyframes decode standalone.
- `H264Depacketizer` — RFC 6184 RTP payloads (single NAL / STAP-A / FU-A)
  reassembled into access units on the marker bit.
- `RtspSession` — DESCRIBE / SETUP (RTP/AVP/TCP interleaved) / PLAY, SDP
  `sprop-parameter-sets` parsing, and the `$`-interleaved demux loop.

Ingested logs replay through `export-videos` (db/video.py) and the editor's
video panes.

A host-only copy over the port's ``db/video.py`` and ``db/postcard.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import socket
import struct
import time
from dataclasses import dataclass, field

from .db.video import (  # shared H.264 vocabulary (db/video.py)
    NAL_IDR,
    NAL_PPS,
    NAL_SPS,
    START_CODE_4 as START_CODE,
)

NAL_NON_IDR = 1
RTP_CLOCK_HZ = 90_000
RTP_TS_MOD = 1 << 32


def nal_unit_type(nal: bytes) -> int | None:
    return nal[0] & 0x1F if nal else None


# -- clock mapping (parity: rtsp-ingest/src/clock.rs) ----------------------


class ClockMapper:
    """Maps stream PTS (us) onto strictly-increasing DB timestamps (us)."""

    def __init__(self, base_us: int):
        self.base_us = int(base_us)
        self.first_pts_us: int | None = None
        self.last_written_us: int | None = None

    def peek(self, pts_us: int) -> int:
        first = self.first_pts_us if self.first_pts_us is not None else pts_us
        ts = self.base_us + max(0, pts_us - first)
        if self.last_written_us is not None and ts <= self.last_written_us:
            ts = self.last_written_us + 1
        return ts

    def commit(self, pts_us: int, ts: int) -> None:
        if self.first_pts_us is None:
            self.first_pts_us = pts_us
        self.last_written_us = ts

    def map(self, pts_us: int) -> int:
        ts = self.peek(pts_us)
        self.commit(pts_us, ts)
        return ts

    def reanchor(self, base_us: int) -> None:
        """After a reconnect: new base, fresh PTS origin, monotonicity kept."""
        self.base_us = int(base_us)
        self.first_pts_us = None


# -- AVC → Annex-B (parity: rtsp-ingest/src/annexb.rs) ---------------------


@dataclass
class ParameterSets:
    sps: bytes = b""
    pps: bytes = b""

    def is_complete(self) -> bool:
        return bool(self.sps) and bool(self.pps)


def split_avc_nals(buf: bytes, nal_length_size: int = 4) -> list[bytes]:
    if not 1 <= nal_length_size <= 4:
        raise ValueError(f"invalid NAL length size: {nal_length_size}")
    nals, pos = [], 0
    while pos < len(buf):
        if pos + nal_length_size > len(buf):
            raise ValueError("AVC NAL length prefix is truncated")
        ln = int.from_bytes(buf[pos : pos + nal_length_size], "big")
        pos += nal_length_size
        if ln == 0:
            raise ValueError("AVC NAL has a declared length of zero")
        if pos + ln > len(buf):
            raise ValueError("AVC NAL length prefix is truncated")
        nals.append(buf[pos : pos + ln])
        pos += ln
    if not nals:
        raise ValueError("access unit contains no NAL units")
    return nals


class AnnexBConverter:
    """Length-prefixed AVC access units → self-contained Annex-B, with
    SPS/PPS injected ahead of IDR pictures lacking in-band parameter sets."""

    def __init__(self, params: ParameterSets, nal_length_size: int = 4):
        if not 1 <= nal_length_size <= 4:
            raise ValueError(f"invalid NAL length size: {nal_length_size}")
        self.params = params
        self.nal_length_size = nal_length_size

    def update_parameter_sets(self, params: ParameterSets,
                              nal_length_size: int = 4) -> None:
        if not 1 <= nal_length_size <= 4:
            raise ValueError(f"invalid NAL length size: {nal_length_size}")
        self.params = params
        self.nal_length_size = nal_length_size

    def convert(self, avc_au: bytes) -> bytes:
        nals = split_avc_nals(avc_au, self.nal_length_size)
        return self.assemble(nals)

    def assemble(self, nals: list[bytes]) -> bytes:
        """Annex-B AU from raw NALs (shared by the RTP depacketizer path)."""
        has_idr = any(nal_unit_type(n) == NAL_IDR for n in nals)
        has_sps = any(nal_unit_type(n) == NAL_SPS for n in nals)
        out = bytearray()
        if has_idr and not has_sps:
            if not self.params.is_complete():
                raise ValueError(
                    "access unit contains an IDR slice but no SPS/PPS are "
                    "available to inject"
                )
            out += START_CODE + self.params.sps
            out += START_CODE + self.params.pps
        for n in nals:
            out += START_CODE + n
        return bytes(out)


# -- RTP H.264 depacketizer (RFC 6184) --------------------------------------


class H264Depacketizer:
    """Reassembles RTP H.264 payloads into access units.

    Feed `(payload, timestamp, marker)` per RTP packet; completed AUs are
    returned as `(nals, rtp_timestamp)` on the marker bit (or on a timestamp
    change, for senders that never set the marker)."""

    STAP_A = 24
    FU_A = 28

    def __init__(self):
        self.nals: list[bytes] = []
        self.fu_buf: bytearray | None = None
        self.au_ts: int | None = None

    def push(self, payload: bytes, timestamp: int, marker: bool):
        done: list[tuple[list[bytes], int]] = []
        if self.au_ts is not None and timestamp != self.au_ts and self.nals:
            done.append((self.nals, self.au_ts))
            self.nals = []
        self.au_ts = timestamp
        if not payload:
            return done
        t = payload[0] & 0x1F
        if 1 <= t <= 23:  # single NAL unit
            self.nals.append(payload)
        elif t == self.STAP_A:  # aggregation
            pos = 1
            while pos + 2 <= len(payload):
                ln = struct.unpack_from(">H", payload, pos)[0]
                pos += 2
                self.nals.append(payload[pos : pos + ln])
                pos += ln
        elif t == self.FU_A:  # fragmentation
            indicator, header = payload[0], payload[1]
            start, end = header & 0x80, header & 0x40
            if start:
                recon = bytes([(indicator & 0xE0) | (header & 0x1F)])
                self.fu_buf = bytearray(recon)
            if self.fu_buf is not None:
                self.fu_buf += payload[2:]
                if end:
                    self.nals.append(bytes(self.fu_buf))
                    self.fu_buf = None
        # other types (FU-B, MTAP) unsupported; dropped
        if marker and self.nals:
            done.append((self.nals, timestamp))
            self.nals = []
            self.au_ts = None
        return done


# -- RTSP session ------------------------------------------------------------


def _parse_sdp_params(sdp: str) -> tuple[ParameterSets, str | None]:
    """Extract sprop-parameter-sets and the H.264 track control URL."""
    params = ParameterSets()
    control: str | None = None
    in_video = False
    for line in sdp.splitlines():
        line = line.strip()
        if line.startswith("m="):
            in_video = line.startswith("m=video")
        elif in_video and line.startswith("a=control:"):
            control = line[len("a=control:"):]
        elif in_video and "sprop-parameter-sets=" in line:
            val = line.split("sprop-parameter-sets=", 1)[1]
            val = val.split(";")[0].split()[0]
            parts = [p for p in val.split(",") if p]
            decoded = []
            for p in parts:
                pad = "=" * (-len(p) % 4)
                decoded.append(base64.b64decode(p + pad))
            for d in decoded:
                t = nal_unit_type(d)
                if t == NAL_SPS and not params.sps:
                    params.sps = d
                elif t == NAL_PPS and not params.pps:
                    params.pps = d
    return params, control


@dataclass
class RtspSession:
    """Minimal RTSP client: TCP-interleaved RTP, H.264 only."""

    url: str
    timeout: float = 10.0
    sock: socket.socket | None = None
    cseq: int = 0
    session_id: str | None = None
    params: ParameterSets = field(default_factory=ParameterSets)
    control: str | None = None

    def connect(self) -> None:
        rest = self.url.split("rtsp://", 1)[1]
        hostport = rest.split("/", 1)[0]
        host, _, port = hostport.partition(":")
        self.sock = socket.create_connection(
            (host, int(port or 554)), timeout=self.timeout
        )
        self._rx = b""

    def _request(self, method: str, url: str | None = None,
                 headers: dict | None = None) -> dict:
        self.cseq += 1
        lines = [f"{method} {url or self.url} RTSP/1.0", f"CSeq: {self.cseq}"]
        if self.session_id:
            lines.append(f"Session: {self.session_id}")
        for k, v in (headers or {}).items():
            lines.append(f"{k}: {v}")
        self.sock.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        return self._read_response()

    def _read_exact(self, n: int) -> bytes:
        while len(self._rx) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("RTSP peer closed")
            self._rx += chunk
        out, self._rx = self._rx[:n], self._rx[n:]
        return out

    def _read_response(self) -> dict:
        # responses may be interleaved with $-framed RTP; skip RTP here
        while True:
            first = self._read_exact(1)
            if first == b"$":
                hdr = self._read_exact(3)
                ln = struct.unpack(">H", hdr[1:3])[0]
                self._read_exact(ln)  # drop; data loop not started yet
                continue
            # accumulate header block
            buf = bytearray(first)
            while not bytes(buf).endswith(b"\r\n\r\n"):
                buf += self._read_exact(1)
            text = bytes(buf).decode("latin-1")
            head, _, _ = text.partition("\r\n\r\n")
            lines = head.split("\r\n")
            status = int(lines[0].split()[1])
            hdrs = {}
            for ln_ in lines[1:]:
                if ":" in ln_:
                    k, v = ln_.split(":", 1)
                    hdrs[k.strip().lower()] = v.strip()
            body = b""
            if "content-length" in hdrs:
                body = self._read_exact(int(hdrs["content-length"]))
            if status != 200:
                raise ConnectionError(f"RTSP {lines[0]}")
            return {"status": status, "headers": hdrs, "body": body}

    def describe(self) -> None:
        resp = self._request("DESCRIBE", headers={"Accept": "application/sdp"})
        sdp = resp["body"].decode("latin-1")
        self.params, control = _parse_sdp_params(sdp)
        if control:
            self.control = (
                control if control.startswith("rtsp://")
                else self.url.rstrip("/") + "/" + control
            )
        else:
            self.control = self.url

    def setup(self) -> None:
        resp = self._request(
            "SETUP", self.control,
            headers={"Transport": "RTP/AVP/TCP;unicast;interleaved=0-1"},
        )
        sess = resp["headers"].get("session", "")
        self.session_id = sess.split(";")[0] or None

    def play(self) -> None:
        self._request("PLAY", headers={"Range": "npt=0.000-"})

    def stream(self, on_access_unit, max_aus: int | None = None) -> int:
        """Demux interleaved RTP, reassemble AUs, call
        `on_access_unit(annexb_bytes, pts_us)`. Returns AUs delivered."""
        depack = H264Depacketizer()
        conv = AnnexBConverter(self.params)
        count = 0
        ts_base = 0          # unwrap offset for the 32-bit RTP timestamp
        ts_prev: int | None = None
        try:
            while max_aus is None or count < max_aus:
                first = self._read_exact(1)
                if first != b"$":
                    # mid-stream RTSP message (e.g. keepalive response or
                    # server ANNOUNCE/GET_PARAMETER): skip headers AND any
                    # Content-Length body, or the demux desynchronizes and
                    # treats body bytes as interleaved framing
                    buf = bytearray(first)
                    while not bytes(buf).endswith(b"\r\n\r\n"):
                        buf += self._read_exact(1)
                    body_len = 0
                    for line in bytes(buf).split(b"\r\n"):
                        name, _, value = line.partition(b":")
                        if name.strip().lower() == b"content-length":
                            try:
                                body_len = int(value.strip())
                            except ValueError:
                                pass
                    if body_len > 0:
                        self._read_exact(body_len)
                    continue
                ch, ln = struct.unpack(">BH", self._read_exact(3))
                data = self._read_exact(ln)
                if ch != 0 or len(data) < 12:
                    continue  # RTCP / runt
                marker = bool(data[1] & 0x80)
                ts32 = struct.unpack_from(">I", data, 4)[0]
                # unwrap: the 32-bit 90 kHz clock rolls over every ~13.25 h
                if ts_prev is not None and ts32 < ts_prev - (RTP_TS_MOD >> 1):
                    ts_base += RTP_TS_MOD
                ts_prev = ts32
                ts = ts_base + ts32
                try:
                    cc = data[0] & 0x0F
                    payload = data[12 + 4 * cc:]
                    if data[0] & 0x10:  # extension header
                        ext_len = struct.unpack_from(">H", payload, 2)[0]
                        payload = payload[4 + 4 * ext_len:]
                    units = depack.push(payload, ts, marker)
                except (IndexError, struct.error):
                    continue  # malformed packet: skip, keep the session up
                for nals, rtp_ts in units:
                    # in-band parameter sets override the SDP's
                    for n in nals:
                        t = nal_unit_type(n)
                        if t == NAL_SPS:
                            conv.params.sps = n
                        elif t == NAL_PPS:
                            conv.params.pps = n
                    au = conv.assemble(nals)
                    pts_us = rtp_ts * 1_000_000 // RTP_CLOCK_HZ
                    on_access_unit(au, pts_us)
                    count += 1
        except (ConnectionError, socket.timeout):
            pass
        return count

    def teardown(self) -> None:
        try:
            self._request("TEARDOWN")
        except Exception:
            pass
        if self.sock:
            self.sock.close()


def ingest(url: str, db, msg_name: str, max_aus: int | None = None,
           base_us: int | None = None) -> int:
    """Stream an RTSP H.264 source into `db`'s msg log `msg_name`
    (the fsw/rtsp-streamer producer loop)."""
    from .db.postcard import msg_id
    from .db import msgs as M

    mid = msg_id(msg_name)
    log = db.msg_log(mid)
    if log.metadata is None:
        log.set_metadata(M.MsgMetadata(
            int.from_bytes(mid, "little"), msg_name, {"mime": "video/h264"}
        ))
    clock = ClockMapper(
        base_us if base_us is not None else time.time_ns() // 1000
    )
    sess = RtspSession(url)
    sess.connect()
    sess.describe()
    sess.setup()
    sess.play()

    def write(au: bytes, pts_us: int) -> None:
        ts = clock.peek(pts_us)
        log.append(ts, au)
        clock.commit(pts_us, ts)
        db.notify([], ts)

    n = sess.stream(write, max_aus=max_aus)
    sess.teardown()
    db.flush()
    return n


def main(argv=None):
    import argparse

    from .db.storage import Database

    p = argparse.ArgumentParser(
        prog="elodin-rtsp-ingest",
        description="stream an RTSP H.264 source into an elodin-db",
    )
    p.add_argument("url", help="rtsp:// source URL")
    p.add_argument("--db", required=True, help="database directory")
    p.add_argument("--name", default="video.rtsp", help="msg log name")
    p.add_argument("--max-aus", type=int, default=None)
    args = p.parse_args(argv)
    db = Database(args.db)
    n = ingest(args.url, db, args.name, max_aus=args.max_aus)
    print(f"ingested {n} access units into {args.name}")


if __name__ == "__main__":
    main()
