"""Elodin-DB Python client (parity: python/elodin/db.py).

Same public surface: ``Field``/``f64[3].labeled(...)`` schemas,
``TableWriter`` emitting one aligned Table packet per row, ``Client`` with
``send``/``send_msg``/``get_msgs``/``stream``/``latest``/``time_series``/
``sql``, and ``Server.start`` for an embedded database.

A host-only copy of ``elodin_tpu/db/client.py``:
the port imports nothing of the JAX package.  Its reader thread reads the
socket a chunk at a time, not a packet's header and body apart, and a
component stream skips a table of no subscribed component by its vtable's
static layout before realizing it.
"""

from __future__ import annotations

import json
import queue
import socket
import threading
import time
from dataclasses import dataclass, field as dc_field, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np

from . import msgs as M
from .postcard import msg_id
from .sql import sanitize_sql_table_name
from .storage import Database, now_timestamp_us
from .vtable import PRIM_NP, build_table_vtable, component_id_of

sql_table_name = sanitize_sql_table_name


_MAX_FIELD_RANK = 3


@dataclass(frozen=True)
class Field:
    """Component schema spec for TableWriter columns: primitive dtype,
    tensor shape, optional per-element display labels.  Behavioral parity
    with the reference SDK's field specs (python/elodin/db.py) — built as
    ``f64[3].labeled("x", "y", "z")`` style chains, each step returning a
    new frozen spec."""

    prim: str
    shape: Tuple[int, ...] = ()
    element_names: Tuple[str, ...] = dc_field(default_factory=tuple)

    def __getitem__(self, dims) -> "Field":
        """``field[3]`` / ``field[3, 3]`` — attach a tensor shape."""
        shape = tuple(np.atleast_1d(np.asarray(dims, dtype=np.int64)).tolist())
        if not shape or min(shape) < 1:
            raise ValueError(
                f"field shape must be positive dims, got {shape!r}"
            )
        if len(shape) > _MAX_FIELD_RANK:
            raise ValueError(
                f"field rank {len(shape)} exceeds the wire limit of "
                f"{_MAX_FIELD_RANK}"
            )
        return replace(self, shape=shape)

    def labeled(self, *names: str) -> "Field":
        """Attach display labels, one per flattened element."""
        if len(names) != self.count:
            raise ValueError(
                f"label count {len(names)} != element count {self.count}"
            )
        return replace(self, element_names=tuple(str(n) for n in names))

    @property
    def dtype(self) -> np.dtype:
        return PRIM_NP[self.prim]

    @property
    def count(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.count * self.dtype.itemsize


f64 = Field("f64")
f32 = Field("f32")
i64 = Field("i64")
i32 = Field("i32")
i16 = Field("i16")
i8 = Field("i8")
u64 = Field("u64")
u32 = Field("u32")
u16 = Field("u16")
u8 = Field("u8")
bool_ = Field("bool")


@dataclass(frozen=True)
class Sample:
    name: str
    timestamp_us: int
    values: np.ndarray


@dataclass(frozen=True)
class ComponentInfo:
    name: str
    prim: str
    shape: Tuple[int, ...]
    metadata: Dict[str, str]


class _Conn:
    """Blocking framed-socket connection with a reader thread."""

    def __init__(self, addr: str, timeout: float = 10.0):
        host, _, port = addr.rpartition(":")
        host = host.strip("[]") or "127.0.0.1"
        if host == "::":
            host = "127.0.0.1"
        self.sock = socket.create_connection((host, int(port)), timeout=timeout)
        self.sock.settimeout(None)
        self.lock = threading.Lock()
        self._req_id = 0
        self._pending: dict[int, queue.Queue] = {}
        self._stream_handlers: list = []
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def next_req_id(self) -> int:
        """Allocate a wire req id (one byte, 1..255).  Ids registered in
        ``_pending`` (long-lived stream subscriptions) are skipped so a
        wrapped counter can't collide with a live stream — a collision
        would deliver stream packets as another request's reply and then
        orphan the stream's queue."""
        with self.lock:
            for _ in range(255):
                self._req_id = self._req_id % 255 + 1
                if self._req_id not in self._pending:
                    return self._req_id
            raise RuntimeError(
                "no free request ids: 255 live requests/streams on one "
                "connection"
            )

    def release(self, req_id: int) -> None:
        """Drop a stream subscription's queue and wake any blocked reader
        with a None sentinel (consumed as end-of-stream)."""
        q = self._pending.pop(req_id, None)
        if q is not None:
            q.put(None)

    def send_bytes(self, data: bytes) -> None:
        with self.lock:
            self.sock.sendall(data)

    def request(self, pkt: bytes, req_id: int, timeout: float = 10.0,
                n_replies: int = 1) -> list[M.Packet]:
        q: queue.Queue = queue.Queue()
        self._pending[req_id] = q
        try:
            self.send_bytes(pkt)
            return [q.get(timeout=timeout) for _ in range(n_replies)]
        finally:
            self._pending.pop(req_id, None)

    def request_stream(self, pkt: bytes, req_id: int) -> queue.Queue:
        q: queue.Queue = queue.Queue()
        self._pending[req_id] = q
        self.send_bytes(pkt)
        return q

    def add_stream_handler(self, fn) -> None:
        self._stream_handlers.append(fn)

    def _read_loop(self) -> None:
        # one recv a chunk, every whole packet in it dispatched: a recv a
        # packet's header and another its body released the interpreter
        # lock twice a packet, which on a many-core host hands it to the
        # server's and the stream consumer's threads every time
        buf = bytearray()
        try:
            while True:
                chunk = self.sock.recv(1 << 16)
                if not chunk:
                    return
                buf += chunk
                pos = 0
                while len(buf) - pos >= 4:
                    n = int.from_bytes(buf[pos:pos + 4], "little")
                    if len(buf) - pos - 4 < n:
                        break
                    pkt = M.parse_packet(bytes(buf[pos + 4:pos + 4 + n]))
                    pos += 4 + n
                    q = self._pending.get(pkt.req_id)
                    if q is not None:
                        q.put(pkt)
                    for fn in self._stream_handlers:
                        fn(pkt)
                del buf[:pos]
        except OSError:
            pass

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class _PackedField:
    __slots__ = ("name", "spec", "offset")

    def __init__(self, name: str, spec: Field, offset: int):
        self.name = name
        self.spec = spec
        self.offset = offset


class TableWriter:
    """One aligned Table packet per write, shared i64 timestamp at offset 0
    (db.py:142-276)."""

    _next_id = 0x0100

    def __init__(self, addr: str, schema: Dict[str, Field],
                 queue_policy: str = "drop-oldest", maxlen: int = 1024,
                 timestamp: str = "us"):
        if timestamp not in ("us", "ns"):
            raise ValueError("timestamp must be 'us' or 'ns'")
        self._timestamp_unit = timestamp
        self._dropped = 0
        self._last_error: Optional[str] = None
        # pack: shared timestamp then fields ordered by descending alignment
        offset = 8
        self.fields: list[_PackedField] = []
        for name, spec in sorted(
            schema.items(), key=lambda kv: -kv[1].dtype.itemsize
        ):
            pad = (-offset) % spec.dtype.itemsize
            offset += pad
            self.fields.append(_PackedField(name, spec, offset))
            offset += spec.nbytes
        self.row_nbytes = offset

        TableWriter._next_id += 1
        self._vt_id = TableWriter._next_id.to_bytes(2, "little")
        vt = build_table_vtable(
            [
                (pf.name, pf.spec.prim, pf.spec.shape, pf.offset, pf.spec.nbytes)
                for pf in self.fields
            ],
            timestamp_offset=0,
        )
        self._vt_pkt = M.VTableMsg(self._vt_id, vt).packet()
        self._conn = _Conn(addr)
        self._conn.send_bytes(self._vt_pkt)
        # register names (+ element labels) so the DB can derive SQL table
        # names and display metadata
        for pf in self.fields:
            md = {}
            if pf.spec.element_names:
                md["element_names"] = ",".join(pf.spec.element_names)
            meta = M.SetComponentMetadata(
                component_id_of(pf.name), pf.name, md
            )
            self._conn.send_bytes(meta.packet())

    @property
    def dropped(self) -> int:
        return self._dropped

    @property
    def last_error(self) -> Optional[str]:
        return self._last_error

    @property
    def state(self) -> str:
        return "connected"

    @property
    def row_size(self) -> int:
        return self.row_nbytes

    def _timestamp(self, timestamp_us, timestamp_ns) -> int:
        if timestamp_ns is not None:
            return int(timestamp_ns) // (1 if self._timestamp_unit == "ns" else 1000)
        if timestamp_us is not None:
            return int(timestamp_us) * (1000 if self._timestamp_unit == "ns" else 1)
        now = time.time_ns()
        return now if self._timestamp_unit == "ns" else now // 1000

    def _pack(self, timestamp: int, values: Dict[str, Any]) -> bytes:
        row = bytearray(self.row_nbytes)
        ts = timestamp if self._timestamp_unit == "us" else timestamp // 1000
        row[0:8] = np.int64(ts).tobytes()
        for pf in self.fields:
            if pf.name not in values:
                raise KeyError(f"missing value for {pf.name!r}")
            arr = np.asarray(values[pf.name], dtype=pf.spec.dtype).reshape(-1)
            if arr.size != pf.spec.count:
                raise ValueError(
                    f"{pf.name}: {arr.size} values for shape {pf.spec.shape}"
                )
            row[pf.offset : pf.offset + pf.spec.nbytes] = arr.tobytes()
        return bytes(row)

    def write(self, timestamp_us=None, values=None, timestamp_ns=None) -> None:
        ts = self._timestamp(timestamp_us, timestamp_ns)
        body = self._pack(ts, values or {})
        try:
            self._conn.send_bytes(M.frame(M.TY_TABLE, self._vt_id, body))
        except OSError as e:
            self._last_error = str(e)
            raise

    def write_batch(self, timestamps_us, values: Dict[str, Any]) -> int:
        """Vectorized bulk write: N rows packed with numpy into one
        contiguous buffer of N table packets and sent with one syscall
        (the high-rate producer path; per-row ``write`` costs a Python
        pack + send each).  ``values[name]`` is an (N, *shape) array."""
        # NOTE: row timestamps are microseconds ON THE WIRE regardless of
        # the writer's input unit (write() converts ns inputs to us in
        # _pack); timestamps_us is already us, so no conversion here
        ts = np.ascontiguousarray(np.asarray(timestamps_us, dtype=np.int64))
        n = len(ts)
        rows = np.zeros((n, self.row_nbytes), dtype=np.uint8)
        rows[:, 0:8] = ts.astype("<i8").view(np.uint8).reshape(n, 8)
        for pf in self.fields:
            arr = np.asarray(values[pf.name], dtype=pf.spec.dtype)
            arr = np.ascontiguousarray(arr).reshape(n, pf.spec.count)
            raw = arr.view(np.uint8).reshape(n, pf.spec.nbytes)
            rows[:, pf.offset : pf.offset + pf.spec.nbytes] = raw
        header = (
            (M.PACKET_HEADER_LEN + self.row_nbytes).to_bytes(4, "little")
            + bytes([M.TY_TABLE])
            + self._vt_id
            + b"\x00"
        )
        hdr = np.frombuffer(header, dtype=np.uint8)
        frames = np.zeros((n, len(header) + self.row_nbytes), dtype=np.uint8)
        frames[:, : len(header)] = hdr
        frames[:, len(header):] = rows
        self._conn.send_bytes(frames.tobytes())
        return n

    def write_nowait(self, timestamp_us=None, values=None, timestamp_ns=None) -> None:
        try:
            self.write(timestamp_us, values, timestamp_ns)
        except Exception as e:  # noqa: BLE001
            self._dropped += 1
            self._last_error = str(e)

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "TableWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def _encode_msg_payload(payload: Any) -> bytes:
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return bytes(payload)
    if isinstance(payload, str):
        return payload.encode()
    return json.dumps(payload).encode()


def _decode_msg_payload(data: bytes) -> Any:
    try:
        return json.loads(data)
    except (UnicodeDecodeError, json.JSONDecodeError):
        try:
            return data.decode()
        except UnicodeDecodeError:
            return bytes(data)


def _to_array(data: bytes, prim: str, shape) -> np.ndarray:
    values = np.frombuffer(data, dtype=PRIM_NP[prim])
    if shape:
        return values.reshape(*[int(d) for d in shape])
    return values.reshape(())


class StreamRow:
    def __init__(self, timestamp_us: int, values: Dict[str, np.ndarray]):
        self.timestamp_us = timestamp_us
        self._values = values

    def __getitem__(self, name: str) -> np.ndarray:
        return self._values[name]

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def keys(self):
        return self._values.keys()


class ComponentStream:
    def __init__(self, conn: _Conn, q: queue.Queue, names,
                 req_id: int | None = None):
        self._conn = conn
        self._q = q
        self._names = set(names) if names else None
        self._vtables: dict[bytes, object] = {}
        # vtable id -> its fields' component ids (None: not a static layout)
        self._vt_cids: dict[bytes, list | None] = {}
        self._id_to_name: dict[int, str] = {}
        self._req_id = req_id
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> StreamRow:
        while True:
            if self._closed:
                raise StopIteration
            pkt = self._q.get()
            if pkt is None:  # close() sentinel
                raise StopIteration
            if pkt.ty == M.TY_MSG and pkt.id == M.VTableMsg.ID:
                vtm = M.VTableMsg.decode(pkt.body)
                self._vtables[vtm.id] = vtm.vtable
                self._vt_cids.pop(vtm.id, None)
                continue
            if pkt.ty == M.TY_TABLE:
                vt = self._vtables.get(pkt.id)
                if vt is None or not self._wanted(pkt.id, vt):
                    continue
                values = {}
                ts = now_timestamp_us()
                for f in vt.realize_fields(pkt.body):
                    if f["component_id"] is None:
                        continue
                    name = self._id_to_name.get(f["component_id"])
                    if name is None:
                        name = f"{f['component_id']:016x}"
                    if f["timestamp"] is not None:
                        ts = f["timestamp"]
                    if self._names is None or name in self._names:
                        values[name] = _to_array(f["data"], f["ty"], f["shape"])
                if values:
                    return StreamRow(ts, values)

    def _wanted(self, vt_id: bytes, vt) -> bool:
        """Whether a table of this vtable can hold a subscribed component,
        read from its static layout without realizing the table (a table
        of another component is skipped as the loop below would skip it)."""
        if self._names is None:
            return True
        cids = self._vt_cids.get(vt_id, False)
        if cids is False:
            layout = vt.static_layout()
            cids = None if layout is None else [f["component_id"] for f in layout]
            self._vt_cids[vt_id] = cids
        if cids is None:
            return True
        return any(cid is not None and self._id_to_name.get(cid, f"{cid:016x}") in self._names
                   for cid in cids)

    def close(self) -> None:
        self._closed = True
        if self._req_id is not None:
            self._conn.release(self._req_id)
            self._req_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class _RawTableStream:
    """Iterator over (vtable, raw table bytes) pairs from a VTableStream
    subscription: VTableMsg packets update the layout, TY_TABLE packets
    yield realized rows."""

    def __init__(self, q: queue.Queue, vtable_id: bytes,
                 conn: _Conn | None = None, req_id: int | None = None):
        self._q = q
        self.vtable_id = vtable_id
        self.vtable = None
        self._conn = conn
        self._req_id = req_id
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._closed:
                raise StopIteration
            pkt = self._q.get()
            if pkt is None:  # close() sentinel
                raise StopIteration
            if pkt.ty == M.TY_MSG and pkt.id == M.VTableMsg.ID:
                self.vtable = M.VTableMsg.decode(pkt.body).vtable
                continue
            if pkt.ty == M.TY_TABLE:
                fields = (
                    list(self.vtable.realize_fields(pkt.body))
                    if self.vtable is not None
                    else []
                )
                return pkt.body, fields

    def close(self) -> None:
        self._closed = True
        if self._conn is not None and self._req_id is not None:
            self._conn.release(self._req_id)
            self._req_id = None


class MessageStream:
    def __init__(self, q: queue.Queue, raw: bool,
                 conn: _Conn | None = None, req_id: int | None = None):
        self._q = q
        self._raw = raw
        self._conn = conn
        self._req_id = req_id
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        pkt = self._q.get()
        if pkt is None:  # close() sentinel
            raise StopIteration
        ts = int.from_bytes(pkt.body[:8], "little", signed=True)
        data = pkt.body[8:] if pkt.ty == M.TY_MSG_WITH_TIMESTAMP else pkt.body
        if self._raw:
            return ts, bytes(data)
        return ts, _decode_msg_payload(data)

    def close(self) -> None:
        self._closed = True
        if self._conn is not None and self._req_id is not None:
            self._conn.release(self._req_id)
            self._req_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class Client:
    """Client for a running Elodin-DB (db.py:421-608)."""

    def __init__(self, addr: str):
        self._addr = addr
        self._conn = _Conn(addr)
        self._send_writers: Dict[str, TableWriter] = {}
        self._send_lock = threading.Lock()
        self._info_cache: Dict[str, ComponentInfo] = {}

    def _component_info(self, name: str) -> Optional[ComponentInfo]:
        """Schema lookup with a one-shot cache: schemas are immutable once
        a component exists, so high-rate callers (HzDriver polls every
        tick) must not pay two metadata round trips per call."""
        info = self._info_cache.get(name)
        if info is None:
            self._info_cache = self.components()
            info = self._info_cache.get(name)
        return info

    @classmethod
    def connect(cls, addr: str) -> "Client":
        return cls(addr)

    @property
    def addr(self) -> str:
        return self._addr

    # -- write ------------------------------------------------------------

    def table_writer(self, schema: Dict[str, Field], queue: str = "drop-oldest",
                     maxlen: int = 1024, timestamp: str = "us") -> TableWriter:
        return TableWriter(self._addr, schema, queue, maxlen, timestamp)

    def send(self, name: str, values: Any, timestamp_us: int) -> None:
        arr = np.asarray(values, dtype=np.float64).reshape(-1)
        with self._send_lock:
            w = self._send_writers.get(name)
            if w is None:
                spec = f64[len(arr)] if arr.size > 1 else f64
                w = self.table_writer({name: spec})
                self._send_writers[name] = w
        w.write(timestamp_us, {name: arr})

    # -- messages ----------------------------------------------------------

    def send_msg(self, name: str, payload: Any, timestamp_us: int) -> None:
        data = _encode_msg_payload(payload)
        body = np.int64(timestamp_us).tobytes() + data
        self._conn.send_bytes(
            M.frame(M.TY_MSG_WITH_TIMESTAMP, msg_id(name), body)
        )

    def get_msgs(self, name: str, start_us: int = 0,
                 stop_us: int = 2**62, limit: int | None = None):
        req_id = self._conn.next_req_id()
        msg = M.GetMsgs(msg_id(name), start_us, stop_us, limit)
        [pkt] = self._conn.request(msg.packet(req_id), req_id)
        batch = M.MsgBatch.decode(pkt.body)
        return [(ts, _decode_msg_payload(d)) for ts, d in batch.data]

    def msg_stream(self, name: str, maxlen: int = 1024, raw: bool = False):
        req_id = self._conn.next_req_id()
        q = self._conn.request_stream(
            M.MsgStream(msg_id(name)).packet(req_id), req_id
        )
        return MessageStream(q, raw, conn=self._conn, req_id=req_id)

    # -- reads -------------------------------------------------------------

    def components(self) -> Dict[str, ComponentInfo]:
        req_id = self._conn.next_req_id()
        [pkt] = self._conn.request(M.DumpMetadata().packet(req_id), req_id)
        meta = M.DumpMetadataResp.decode(pkt.body)
        req_id = self._conn.next_req_id()
        [spkt] = self._conn.request(M.DumpSchema().packet(req_id), req_id)
        schemas = M.DumpSchemaResp.decode(spkt.body).schemas
        out = {}
        for cm in meta.component_metadata:
            schema = schemas.get(cm.component_id)
            out[cm.name] = ComponentInfo(
                cm.name,
                schema.prim if schema else "f64",
                tuple(schema.shape) if schema else (),
                cm.metadata,
            )
        return out

    def earliest_timestamp(self) -> int:
        req_id = self._conn.next_req_id()
        [pkt] = self._conn.request(
            M.GetEarliestTimestamp().packet(req_id), req_id
        )
        return M.EarliestTimestamp.decode(pkt.body).timestamp

    def stream(self, components=None, frequency: int | None = None):
        req_id = self._conn.next_req_id()
        if frequency:
            behavior = M.FixedRateBehavior(
                "earliest", int(1e9 / frequency), frequency
            )
            msg = M.Stream(behavior, id=req_id)
        else:
            msg = M.Stream("real-time", id=req_id)
        q = self._conn.request_stream(msg.packet(req_id), req_id)
        stream = ComponentStream(self._conn, q, components, req_id=req_id)
        # learn component names for id resolution
        try:
            for name, info in self.components().items():
                stream._id_to_name[component_id_of(name)] = name
        except Exception:
            pass
        return stream

    def latest(self, name: str) -> Optional[Sample]:
        cid = component_id_of(name)
        req_id = self._conn.next_req_id()
        msg = M.GetTimeSeries(
            b"\x00\x01", -(2**62), 2**62, cid, limit=1
        )
        [pkt] = self._conn.request(msg.packet(req_id), req_id)
        if pkt.ty != M.TY_TIME_SERIES:
            return None
        n = int.from_bytes(pkt.body[:8], "little")
        if n == 0:
            return None
        ts = np.frombuffer(pkt.body[8 : 8 + n * 8], dtype="<i8")
        info = self._component_info(name)
        prim = info.prim if info else "f64"
        shape = info.shape if info else ()
        data = np.frombuffer(pkt.body[8 + n * 8 :], dtype=PRIM_NP[prim])
        per_row = max(1, int(np.prod(shape)) if shape else 1)
        values = data.reshape(n, per_row)
        return Sample(name, int(ts[-1]), values[-1].reshape(shape or ()))

    def time_series(self, name: str, start_us: int = -(2**62),
                    stop_us: int = 2**62, limit: int | None = None):
        cid = component_id_of(name)
        req_id = self._conn.next_req_id()
        msg = M.GetTimeSeries(b"\x00\x01", start_us, stop_us, cid, limit)
        [pkt] = self._conn.request(msg.packet(req_id), req_id)
        if pkt.ty == M.TY_MSG and pkt.id == M.ErrorResponse.ID:
            raise RuntimeError(M.ErrorResponse.decode(pkt.body).description)
        n = int.from_bytes(pkt.body[:8], "little")
        ts = np.frombuffer(pkt.body[8 : 8 + n * 8], dtype="<i8").copy()
        info = self._component_info(name)
        prim = info.prim if info else "f64"
        shape = info.shape if info else ()
        data = np.frombuffer(pkt.body[8 + n * 8 :], dtype=PRIM_NP[prim])
        per_row = max(1, int(np.prod(shape)) if shape else 1)
        values = data.reshape(n, per_row) if n else data.reshape(0, per_row)
        if shape:
            values = values.reshape((n,) + tuple(shape))
        else:
            values = values.reshape(n)
        return ts, values

    def sql(self, query: str):
        import io

        import pyarrow.ipc as ipc

        req_id = self._conn.next_req_id()
        # reply shape differs by outcome — N ArrowIPC batches then an
        # ArrowIPC(None) terminator on success, a single ErrorResponse on
        # failure — so read until terminator/error rather than asking for a
        # fixed reply count (which would hang on errors)
        q = self._conn.request_stream(M.SQLQuery(query).packet(req_id), req_id)
        tables = []
        try:
            while True:
                pkt = q.get(timeout=10.0)
                if pkt is None:
                    break
                if pkt.id == M.ErrorResponse.ID:
                    raise RuntimeError(
                        M.ErrorResponse.decode(pkt.body).description
                    )
                arrow = M.ArrowIPC.decode(pkt.body)
                if arrow.batch is None:
                    break  # terminator
                with ipc.open_stream(io.BytesIO(arrow.batch)) as r:
                    tables.append(r.read_all())
        finally:
            self._conn._pending.pop(req_id, None)
        import pyarrow as pa

        return pa.concat_tables(tables) if tables else None

    def sparkline(self, name: str, max_points: int):
        """LTTB-downsampled (time, value) arrays for a component
        (SparklineQuery, impeller2/wkt/src/msgs.rs:549)."""
        import io

        import pyarrow.ipc as ipc

        from .sql import sanitize_sql_table_name

        table_name = sanitize_sql_table_name(name)
        req_id = self._conn.next_req_id()
        [pkt] = self._conn.request(
            M.SparklineQuery(table_name, max_points).packet(req_id), req_id
        )
        if pkt.id == M.ErrorResponse.ID:
            raise RuntimeError(M.ErrorResponse.decode(pkt.body).description)
        arrow = M.ArrowIPC.decode(pkt.body)
        if arrow.batch:
            with ipc.open_stream(io.BytesIO(arrow.batch)) as r:
                t = r.read_all()
            return (
                t["time"].cast("int64").to_numpy(),
                t[table_name].to_numpy(),
            )
        return np.array([], dtype="<i8"), np.array([])

    def plot_overview(self, name: str, start_us: int = -(2**62),
                      stop_us: int = 2**62, max_points: int = 512,
                      element_index: int = 0):
        """Downsampled historical window (PlotOverviewQuery, msgs.rs:565)."""
        cid = component_id_of(name)
        req_id = self._conn.next_req_id()
        msg = M.PlotOverviewQuery(
            b"\x00\x02", cid, start_us, stop_us, max_points, element_index
        )
        [pkt] = self._conn.request(msg.packet(req_id), req_id)
        if pkt.ty == M.TY_MSG and pkt.id == M.ErrorResponse.ID:
            raise RuntimeError(M.ErrorResponse.decode(pkt.body).description)
        n = int.from_bytes(pkt.body[:8], "little")
        ts = np.frombuffer(pkt.body[8 : 8 + n * 8], dtype="<i8").copy()
        info = self._component_info(name)
        prim = info.prim if info else "f64"
        values = np.frombuffer(pkt.body[8 + n * 8 :], dtype=PRIM_NP[prim]).copy()
        return ts, values

    def vtable_stream(self, vtable_id: bytes, maxlen: int = 1024):
        """Subscribe to raw tables written under one vtable id
        (VTableStream, msgs.rs:33)."""
        req_id = self._conn.next_req_id()
        q = self._conn.request_stream(
            M.VTableStream(vtable_id).packet(req_id), req_id
        )
        return _RawTableStream(q, vtable_id, conn=self._conn, req_id=req_id)

    def timestamped_msg_stream(self, name: str, maxlen: int = 1024):
        """Message stream preserving source timestamps
        (TimestampedMsgStream, msgs.rs:786)."""
        from .postcard import msg_id as _msg_id

        mid = name if isinstance(name, bytes) else _msg_id(name)
        req_id = self._conn.next_req_id()
        q = self._conn.request_stream(
            M.TimestampedMsgStream(mid).packet(req_id), req_id
        )
        return MessageStream(q, raw=True, conn=self._conn, req_id=req_id)

    def fixed_rate_msg_stream(self, name: str, frequency: int = 60,
                              timestep_ns: int | None = None,
                              initial="earliest"):
        """Fixed-rate replay of a message log (FixedRateMsgStream)."""
        from .postcard import msg_id as _msg_id

        mid = name if isinstance(name, bytes) else _msg_id(name)
        behavior = M.FixedRateBehavior(
            initial, timestep_ns or int(1e9 / frequency), frequency
        )
        req_id = self._conn.next_req_id()
        q = self._conn.request_stream(
            M.FixedRateMsgStream(
                mid, M.FixedRateOp(req_id, behavior)
            ).packet(req_id),
            req_id,
        )
        return MessageStream(q, raw=True, conn=self._conn, req_id=req_id)

    def save_archive(self, path: str, format: str = "arrow_ipc"):
        req_id = self._conn.next_req_id()
        [pkt] = self._conn.request(
            M.SaveArchive(path, format).packet(req_id), req_id
        )
        if pkt.id == M.ErrorResponse.ID:
            raise RuntimeError(M.ErrorResponse.decode(pkt.body).description)
        return M.ArchiveSaved.decode(pkt.body).path

    @property
    def state(self) -> str:
        return "connected"

    def close(self) -> None:
        self._conn.close()


class Server:
    """Embedded server handle (db.py Server.start)."""

    def __init__(self, native_server):
        self._server = native_server

    @staticmethod
    def start(path: str | None = None, addr: str = "127.0.0.1:0") -> "Server":
        from .server import Server as NativeServer

        db = Database(path)
        native = NativeServer(db, addr).start()
        return Server(native)

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self._server.port}"

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def db(self) -> Database:
        return self._server.db

    def stop(self) -> None:
        self._server.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False
