"""WebSocket transport for the DB wire protocol (RFC 6455, no deps).

The reference's impeller2 speaks TCP / UDP / serial (COBS) / shared-memory
/ **WebSocket** (libs/impeller2/README.md; libs/db/src/lib.rs:1673-1699 —
the axum `ws` route bridging browser clients onto the same packet
protocol).  This module is the equivalent: the assets HTTP
server upgrades ``GET /ws`` and then relays raw bytes between WebSocket
binary frames and a loopback TCP connection to the DB port, so a browser
(or any WS client) gets the FULL wire protocol — vtables, streams, SQL,
msg logs — with no second protocol surface to maintain.  Framing is
byte-stream semantics: impeller2 packets are already length-prefixed, so
any WS message chunking reassembles correctly on either side.

Server side: ``handshake_response`` + ``serve_bridge`` (called from
db/assets.py inside a ThreadingHTTPServer handler thread, which the
bridge simply occupies for the connection's lifetime).
Client side: ``WsClient`` — used by the tests and usable as a minimal
Python client transport.

A host-only copy of ``elodin_tpu/db/ws.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import hashlib
import os
import socket
import struct
import threading

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(payload: bytes, opcode: int = OP_BINARY,
                 mask: bool = False) -> bytes:
    """One FIN frame.  Servers MUST NOT mask; clients MUST (RFC 6455 5.3)."""
    head = bytearray([0x80 | opcode])
    n = len(payload)
    mask_bit = 0x80 if mask else 0
    if n < 126:
        head.append(mask_bit | n)
    elif n < (1 << 16):
        head.append(mask_bit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", n)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise ConnectionError("websocket peer closed mid-frame")
        buf += chunk
    return buf


def _read_one_frame(rfile) -> tuple[bool, int, bytes]:
    """One raw frame -> (fin, opcode, unmasked payload)."""
    b0, b1 = _read_exact(rfile, 2)
    opcode = b0 & 0x0F
    fin = bool(b0 & 0x80)
    masked = bool(b1 & 0x80)
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", _read_exact(rfile, 2))
    elif n == 127:
        (n,) = struct.unpack(">Q", _read_exact(rfile, 8))
    key = _read_exact(rfile, 4) if masked else None
    payload = _read_exact(rfile, n) if n else b""
    if key:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return fin, opcode, payload


def read_frame(rfile, on_control=None) -> tuple[int, bytes]:
    """One MESSAGE -> (opcode, unmasked payload).  Raises ConnectionError
    on EOF.  Fragmentation (FIN=0) is reassembled across OP_CONT frames;
    control frames (PING/PONG) interjected between fragments — explicitly
    allowed by RFC 6455 §5.4, and browsers do ping mid-send — are handed
    to ``on_control(opcode, payload)`` (dropped if None); an interjected
    CLOSE ends the message and is returned as-is."""
    fin, opcode, payload = _read_one_frame(rfile)
    if fin:
        return opcode, payload
    parts = [payload]
    while True:
        fin2, op2, p2 = _read_one_frame(rfile)
        if op2 >= OP_CLOSE:  # control frames are never fragmented
            if op2 == OP_CLOSE:
                return op2, p2
            if on_control is not None:
                on_control(op2, p2)
            continue
        if op2 != OP_CONT:
            raise ConnectionError("interleaved websocket fragments")
        parts.append(p2)
        if fin2:
            return opcode, b"".join(parts)


def handshake_fields(headers) -> dict | None:
    """Validate an HTTP Upgrade request; returns response headers or None
    if this is not a websocket upgrade."""
    if (headers.get("Upgrade", "").lower() != "websocket"
            or "upgrade" not in headers.get("Connection", "").lower()):
        return None
    key = headers.get("Sec-WebSocket-Key")
    if not key:
        return None
    return {
        "Upgrade": "websocket",
        "Connection": "Upgrade",
        "Sec-WebSocket-Accept": accept_key(key),
    }


def serve_bridge(ws_rfile, ws_sock, tcp_port: int,
                 host: str = "127.0.0.1") -> None:
    """Relay bytes between an upgraded websocket and a loopback TCP
    connection to the DB until either side closes.  Runs in (and occupies)
    the caller's thread; a daemon thread pumps TCP->WS."""
    tcp = socket.create_connection((host, tcp_port))
    tcp_closed = threading.Event()
    send_lock = threading.Lock()  # pong vs data-pump interleave

    def tcp_to_ws() -> None:
        try:
            while True:
                chunk = tcp.recv(1 << 16)
                if not chunk:
                    break
                with send_lock:
                    ws_sock.sendall(encode_frame(chunk, OP_BINARY))
        except OSError:
            pass
        finally:
            tcp_closed.set()
            try:
                with send_lock:
                    ws_sock.sendall(encode_frame(b"", OP_CLOSE))
            except OSError:
                pass

    pump = threading.Thread(target=tcp_to_ws, daemon=True)
    pump.start()

    def pong(op: int, p: bytes) -> None:
        if op != OP_PING:  # an interjected PONG needs no reply
            return
        with send_lock:
            ws_sock.sendall(encode_frame(p, OP_PONG))

    try:
        while not tcp_closed.is_set():
            try:
                opcode, payload = read_frame(ws_rfile, on_control=pong)
            except ConnectionError:
                break
            if opcode == OP_CLOSE:
                break
            if opcode == OP_PING:
                with send_lock:
                    ws_sock.sendall(encode_frame(payload, OP_PONG))
                continue
            if opcode in (OP_BINARY, OP_TEXT) and payload:
                tcp.sendall(payload)
    finally:
        try:
            tcp.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        tcp.close()
        pump.join(timeout=2.0)


class WsClient:
    """Minimal client transport: byte-stream semantics over WS binary
    frames (each recv returns one message's payload; senders may chunk
    packets arbitrarily — they are length-prefixed)."""

    def __init__(self, host: str, port: int, path: str = "/ws"):
        self.sock = socket.create_connection((host, port))
        self._rfile = self.sock.makefile("rb")
        key = base64.b64encode(os.urandom(16)).decode()
        req = (
            f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
        )
        self.sock.sendall(req.encode())
        status = self._rfile.readline()
        if b"101" not in status:
            raise ConnectionError(f"websocket upgrade refused: {status!r}")
        expect = accept_key(key).encode()
        ok = False
        while True:
            line = self._rfile.readline().strip()
            if not line:
                break
            if line.lower().startswith(b"sec-websocket-accept:"):
                ok = line.split(b":", 1)[1].strip() == expect
        if not ok:
            raise ConnectionError("bad Sec-WebSocket-Accept")

    def send_bytes(self, data: bytes) -> None:
        self.sock.sendall(encode_frame(data, OP_BINARY, mask=True))

    def recv_bytes(self) -> bytes:
        def pong(op: int, p: bytes) -> None:
            if op == OP_PING:
                self.sock.sendall(encode_frame(p, OP_PONG, mask=True))

        while True:
            opcode, payload = read_frame(self._rfile, on_control=pong)
            if opcode == OP_CLOSE:
                raise ConnectionError("websocket closed")
            if opcode == OP_PING:
                self.sock.sendall(encode_frame(payload, OP_PONG, mask=True))
                continue
            if opcode in (OP_BINARY, OP_TEXT):
                return payload

    def close(self) -> None:
        try:
            self.sock.sendall(encode_frame(b"", OP_CLOSE, mask=True))
        except OSError:
            pass
        self.sock.close()
