"""The port's RTSP H.264 ingest (``elodin_tpu_torch.rtsp``), on the CPU:
the four cases of ``tests/test_rtsp.py``, then one loopback stream
ingested by both packages, whose message logs agree bitwise in their
payloads and in their timestamps after each log's first is subtracted.
"""

import base64
import socket
import struct
import threading

import pytest

from elodin_tpu import rtsp as jrtsp
from elodin_tpu.db.storage import Database as JaxDatabase
from elodin_tpu_torch.db.postcard import msg_id
from elodin_tpu_torch.db.storage import Database
from elodin_tpu_torch.db.video import is_keyframe
from elodin_tpu_torch.rtsp import (
    AnnexBConverter,
    ClockMapper,
    ParameterSets,
    ingest,
    split_avc_nals,
)

SC = b"\x00\x00\x00\x01"
SPS = b"\x67\x42\x00\x1e\x01"
PPS = b"\x68\xce\x38\x80"
SPROP = base64.b64encode(SPS).decode() + "," + base64.b64encode(PPS).decode()
IDR_BODY = bytes(range(10, 60))  # an IDR slice's payload, fragmented
P_NAL = b"\x41" + bytes(range(5, 25))  # a whole non-IDR NAL
JOIN_S = 5.0


def test_rtsp_clock_mapper():
    """PTS -> database timestamps (rtsp-ingest/src/clock.rs)."""
    c = ClockMapper(1_000_000)
    assert c.map(50_000) == 1_000_000  # the first frame lands on the base
    assert c.map(83_333) == 1_033_333  # the PTS delta added
    assert c.map(83_333) == 1_033_334  # strictly monotonic
    assert c.map(10_000) == 1_033_335  # a PTS going back clamps forward
    c.reanchor(2_000_000)
    assert c.map(5_000) == 2_000_000  # a fresh origin on the new base
    c2 = ClockMapper(100)
    ts = c2.peek(0)
    assert c2.peek(0) == ts  # peek is pure
    c2.commit(0, ts)
    assert c2.peek(0) == ts + 1


def test_rtsp_annexb_converter():
    """AVCC -> Annex-B with SPS/PPS injection (rtsp-ingest/src/annexb.rs)."""
    idr, p = b"\x65pic", b"\x41pic"

    def au(*nals):
        return b"".join(len(n).to_bytes(4, "big") + n for n in nals)

    sps, pps = b"\x67sps", b"\x68pps"
    conv = AnnexBConverter(ParameterSets(sps, pps))
    assert conv.convert(au(idr)) == SC + sps + SC + pps + SC + idr
    assert conv.convert(au(p)) == SC + p
    assert conv.convert(au(sps, pps, idr)) == SC + sps + SC + pps + SC + idr
    with pytest.raises(ValueError, match="no SPS/PPS"):
        AnnexBConverter(ParameterSets()).convert(au(idr))
    conv2 = AnnexBConverter(ParameterSets(sps, pps), nal_length_size=2)
    assert conv2.convert(len(p).to_bytes(2, "big") + p) == SC + p
    with pytest.raises(ValueError, match="truncated"):
        split_avc_nals(b"\x00\x00\x00\x09ab")


def _rtp(seq, ts, payload, marker=False, pt=96):
    return struct.pack(">BBHII", 0x80, (0x80 if marker else 0) | pt, seq, ts,
                       0x1234) + payload


def _fu_a(frag, start, end):
    indicator = (0x65 & 0xE0) | 28
    header = (0x80 if start else 0) | (0x40 if end else 0) | (0x65 & 0x1F)
    return bytes([indicator, header]) + frag


SDP = (
    "v=0\r\n"
    "o=- 0 0 IN IP4 127.0.0.1\r\n"
    "s=cam\r\n"
    "m=video 0 RTP/AVP 96\r\n"
    "a=rtpmap:96 H264/90000\r\n"
    f"a=fmtp:96 packetization-mode=1;sprop-parameter-sets={SPROP}\r\n"
    "a=control:track1\r\n"
).encode()

PACKETS = [
    _rtp(1, 0, _fu_a(IDR_BODY[:20], True, False)),
    _rtp(2, 0, _fu_a(IDR_BODY[20:40], False, False)),
    _rtp(3, 0, _fu_a(IDR_BODY[40:], False, True), marker=True),
    _rtp(4, 3000, P_NAL, marker=True),  # 3000 ticks at 90 kHz: 33.3 ms
    _rtp(5, 6000, b"\x7c", marker=True),  # a 1-byte FU-A runt: skipped
    _rtp(6, 9000, P_NAL[:1] + bytes(7), marker=True),
]


def _serve(sdp, packets):
    """A canned RTSP server on a free loopback port: it answers DESCRIBE,
    SETUP and PLAY, then sends ``packets`` interleaved on channel 0 and
    closes.  Returns (port, thread, listening socket)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        conn, _ = srv.accept()
        buf = b""
        played = False
        while not played:
            while b"\r\n\r\n" not in buf:
                d = conn.recv(4096)
                if not d:
                    conn.close()
                    return
                buf += d
            req, _, buf = buf.partition(b"\r\n\r\n")
            lines = req.decode().split("\r\n")
            method = lines[0].split()[0]
            cseq = next(ln.split(":")[1].strip() for ln in lines
                        if ln.lower().startswith("cseq"))
            body, extra = b"", ""
            if method == "DESCRIBE":
                body, extra = sdp, "Content-Type: application/sdp\r\n"
            elif method == "SETUP":
                assert "interleaved=0-1" in req.decode()
                extra = ("Session: 12345678\r\n"
                         "Transport: RTP/AVP/TCP;unicast;interleaved=0-1\r\n")
            elif method == "PLAY":
                extra, played = "Session: 12345678\r\n", True
            head = (f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n{extra}"
                    + (f"Content-Length: {len(body)}\r\n" if body else "") + "\r\n")
            conn.sendall(head.encode() + body)
        for pkt in packets:
            conn.sendall(b"$" + struct.pack(">BH", 0, len(pkt)) + pkt)
        conn.close()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    return srv.getsockname()[1], thread, srv


def _ingest(ingest_fn, db, packets, max_aus, **kw):
    port, thread, srv = _serve(SDP, packets)
    try:
        n = ingest_fn(f"rtsp://127.0.0.1:{port}/cam", db, "video.rtsp", max_aus=max_aus, **kw)
        thread.join(timeout=JOIN_S)
        assert not thread.is_alive()
    finally:
        srv.close()
    return n


def test_rtsp_ingest_loopback(tmp_path):
    """A whole RTSP session against a canned loopback server: DESCRIBE /
    SETUP / PLAY, FU-A and single-NAL depacketization, SPS/PPS injection,
    monotonic database timestamps (fsw/rtsp-streamer)."""
    db = Database(str(tmp_path / "db"))
    assert _ingest(ingest, db, PACKETS[:4], 2, base_us=5_000_000) == 2
    log = db.msg_logs[msg_id("video.rtsp")]
    assert log.metadata.name == "video.rtsp"
    assert len(log.entries) == 2
    (ts0, au0), (ts1, au1) = log.entries
    assert au0 == SC + SPS + SC + PPS + SC + b"\x65" + IDR_BODY
    assert au1 == SC + P_NAL
    assert ts0 == 5_000_000
    assert ts1 == 5_000_000 + 3000 * 1_000_000 // 90_000
    assert is_keyframe(au0) and not is_keyframe(au1)


def test_rtp_timestamp_unwrap_and_runt_tolerance(tmp_path):
    """The 32-bit RTP timestamp's wrap unwraps; a malformed packet is
    skipped and the session stays up."""
    idr = b"\x65" + bytes(20)
    near_wrap = (1 << 32) - 3000
    pkts = [
        _rtp(1, near_wrap, idr, marker=True),
        _rtp(2, near_wrap, b"\x7c", marker=True),  # a 1-byte FU-A runt: skipped
        _rtp(3, 1500, P_NAL[:11], marker=True),  # wrapped: 4500 ticks later
    ]
    db = Database(str(tmp_path / "db"))
    assert _ingest(ingest, db, pkts, 2, base_us=0) == 2
    (ts0, _), (ts1, _) = db.msg_logs[msg_id("video.rtsp")].entries
    # 4500 ticks at 90 kHz is 50 ms forward, not a wrap to a tiny delta
    assert ts1 - ts0 == 4500 * 1_000_000 // 90_000


def test_one_stream_ingested_by_both_packages(tmp_path):
    """The same stream through both packages' ``ingest`` (each on its own
    clock): the same access units bitwise, the same metadata, the same
    timestamps after each log's first is subtracted."""
    ours = Database(str(tmp_path / "ours"))
    ref = JaxDatabase(str(tmp_path / "jax"))
    assert _ingest(ingest, ours, PACKETS, None) == 3
    assert _ingest(jrtsp.ingest, ref, PACKETS, None) == 3
    mid = msg_id("video.rtsp")
    a, b = ours.msg_logs[mid], ref.msg_logs[mid]
    assert [au for _, au in a.entries] == [au for _, au in b.entries]
    assert (a.metadata.msg_id, a.metadata.name, a.metadata.metadata) == (
        b.metadata.msg_id, b.metadata.name, b.metadata.metadata)
    rel = [[ts - log.entries[0][0] for ts, _ in log.entries] for log in (a, b)]
    assert rel[0] == rel[1] == [0, 33333, 100000]
