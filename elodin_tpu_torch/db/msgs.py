"""Well-known impeller2 messages (libs/impeller2/wkt/src/msgs.rs).

Each message knows its packet ID (manual [224, n] assignments or the
FNV1a-16-XOR auto-derived ID) and its postcard body layout, matching the
Rust serde derivations field-for-field.

A host-only copy of ``elodin_tpu/db/msgs.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .postcard import Reader, Writer, auto_msg_id
from .vtable import VTable

# -- packet framing ----------------------------------------------------------

PACKET_HEADER_LEN = 4
TY_MSG, TY_TABLE, TY_TIME_SERIES, TY_MSG_WITH_TIMESTAMP = 0, 1, 2, 3


def frame(ty: int, pkt_id: bytes, body: bytes, req_id: int = 0) -> bytes:
    """Length-prefixed packet: u32 LE length of (header+body), then header,
    then body (libs/impeller2/src/types.rs:631-646)."""
    n = PACKET_HEADER_LEN + len(body)
    return (
        n.to_bytes(4, "little")
        + bytes([ty])
        + pkt_id
        + bytes([req_id])
        + body
    )


@dataclass
class Packet:
    ty: int
    id: bytes
    req_id: int
    body: bytes


def parse_packet(buf: bytes) -> Packet:
    return Packet(buf[0], bytes(buf[1:3]), buf[3], bytes(buf[4:]))


# -- message registry --------------------------------------------------------


class MsgBase:
    ID: bytes = b"\x00\x00"

    def encode(self) -> bytes:
        w = Writer()
        self.write(w)
        return w.bytes()

    def packet(self, req_id: int = 0) -> bytes:
        return frame(TY_MSG, self.ID, self.encode(), req_id)

    def write(self, w: Writer) -> None:  # pragma: no cover
        raise NotImplementedError

    @classmethod
    def decode(cls, body: bytes):
        return cls.read(Reader(body))


@dataclass
class VTableMsg(MsgBase):
    ID = auto_msg_id("VTableMsg")
    id: bytes = b"\x00\x00"
    vtable: VTable = dc_field(default_factory=VTable)

    def write(self, w: Writer) -> None:
        w.raw(self.id)
        self.vtable.write(w)

    @classmethod
    def read(cls, r: Reader) -> "VTableMsg":
        pkt_id = r.raw(2)
        return cls(pkt_id, VTable.read(r))


@dataclass
class FixedRateBehavior:
    initial_timestamp: object = "earliest"  # "earliest" | "latest" | int
    timestep: int = int(1e9 / 60)
    frequency: int = 60

    def write(self, w: Writer) -> None:
        if self.initial_timestamp == "earliest":
            w.discriminant(0)
        elif self.initial_timestamp == "latest":
            w.discriminant(1)
        else:
            w.discriminant(2)
            w.zigzag(int(self.initial_timestamp))
        w.varint(self.timestep)
        w.varint(self.frequency)

    @classmethod
    def read(cls, r: Reader) -> "FixedRateBehavior":
        d = r.discriminant()
        init = ["earliest", "latest"][d] if d < 2 else r.zigzag()
        return cls(init, r.varint(), r.varint())


@dataclass
class Stream(MsgBase):
    ID = auto_msg_id("Stream")
    behavior: object = "real-time"  # "real-time" | FixedRateBehavior | "unified"
    id: int = 0

    def write(self, w: Writer) -> None:
        if self.behavior == "real-time":
            w.discriminant(0)
        elif isinstance(self.behavior, FixedRateBehavior):
            w.discriminant(1)
            self.behavior.write(w)
        else:
            w.discriminant(2)
        w.varint(self.id)

    @classmethod
    def read(cls, r: Reader) -> "Stream":
        d = r.discriminant()
        if d == 0:
            behavior = "real-time"
        elif d == 1:
            behavior = FixedRateBehavior.read(r)
        else:
            behavior = "unified"
        return cls(behavior, r.varint())


@dataclass
class FixedRateOp(MsgBase):
    ID = auto_msg_id("FixedRateOp")
    stream_id: int = 0
    behavior: FixedRateBehavior = dc_field(default_factory=FixedRateBehavior)

    def write(self, w: Writer) -> None:
        w.varint(self.stream_id)
        self.behavior.write(w)

    @classmethod
    def read(cls, r: Reader) -> "FixedRateOp":
        return cls(r.varint(), FixedRateBehavior.read(r))


@dataclass
class SetStreamState(MsgBase):
    ID = bytes([224, 2])
    id: int = 0
    playing: bool | None = None
    timestamp: int | None = None
    time_step_ns: int | None = None
    frequency: int | None = None

    def write(self, w: Writer) -> None:
        w.varint(self.id)
        w.option(self.playing, lambda w, v: w.bool(v))
        w.option(self.timestamp, lambda w, v: w.zigzag(v))
        # Duration serializes as (secs: u64, nanos: u32)
        def dur(w, ns):
            w.varint(ns // 1_000_000_000)
            w.varint(ns % 1_000_000_000)

        w.option(self.time_step_ns, dur)
        w.option(self.frequency, lambda w, v: w.varint(v))

    @classmethod
    def read(cls, r: Reader) -> "SetStreamState":
        sid = r.varint()
        playing = r.option(lambda r: r.bool())
        ts = r.option(lambda r: r.zigzag())

        def dur(r):
            return r.varint() * 1_000_000_000 + r.varint()

        step = r.option(dur)
        freq = r.option(lambda r: r.varint())
        return cls(sid, playing, ts, step, freq)


@dataclass
class GetTimeSeries(MsgBase):
    ID = bytes([224, 3])
    id: bytes = b"\x00\x00"
    start: int = 0
    stop: int = 0
    component_id: int = 0
    limit: int | None = None

    def write(self, w: Writer) -> None:
        w.raw(self.id)
        w.zigzag(self.start)
        w.zigzag(self.stop)
        w.varint(self.component_id)
        w.option(self.limit, lambda w, v: w.varint(v))

    @classmethod
    def read(cls, r: Reader) -> "GetTimeSeries":
        return cls(
            r.raw(2), r.zigzag(), r.zigzag(), r.varint(),
            r.option(lambda r: r.varint()),
        )


@dataclass
class SchemaMsg(MsgBase):
    ID = bytes([224, 4])
    prim: str = "f64"
    shape: tuple = ()

    def write(self, w: Writer) -> None:
        from .vtable import PRIM_TO_IDX

        w.discriminant(PRIM_TO_IDX[self.prim])
        w.seq(list(self.shape), lambda w, v: w.varint(v))

    @classmethod
    def read(cls, r: Reader) -> "SchemaMsg":
        from .vtable import PRIM_TYPES

        prim = PRIM_TYPES[r.discriminant()]
        shape = tuple(r.seq(lambda r: r.varint()))
        return cls(prim, shape)


@dataclass
class GetSchema(MsgBase):
    ID = bytes([224, 5])
    component_id: int = 0

    def write(self, w: Writer) -> None:
        w.varint(self.component_id)

    @classmethod
    def read(cls, r: Reader) -> "GetSchema":
        return cls(r.varint())


@dataclass
class ComponentMetadata(MsgBase):
    ID = auto_msg_id("ComponentMetadata")
    component_id: int = 0
    name: str = ""
    metadata: dict = dc_field(default_factory=dict)

    def write(self, w: Writer) -> None:
        w.varint(self.component_id)
        w.string(self.name)
        w.map(self.metadata, lambda w, k: w.string(k), lambda w, v: w.string(v))

    @classmethod
    def read(cls, r: Reader) -> "ComponentMetadata":
        return cls(
            r.varint(),
            r.string(),
            r.map(lambda r: r.string(), lambda r: r.string()),
        )


@dataclass
class GetComponentMetadata(MsgBase):
    ID = bytes([224, 6])
    component_id: int = 0

    def write(self, w: Writer) -> None:
        w.varint(self.component_id)

    @classmethod
    def read(cls, r: Reader) -> "GetComponentMetadata":
        return cls(r.varint())


class SetComponentMetadata(ComponentMetadata):
    """serde(transparent) over ComponentMetadata (msgs.rs:205-224)."""

    ID = auto_msg_id("SetComponentMetadata")


@dataclass
class DumpMetadata(MsgBase):
    ID = bytes([224, 14])

    def write(self, w: Writer) -> None:
        pass

    @classmethod
    def read(cls, r: Reader) -> "DumpMetadata":
        return cls()


@dataclass
class MsgMetadata(MsgBase):
    ID = bytes([224, 30])
    msg_id: int = 0
    name: str = ""
    metadata: dict = dc_field(default_factory=dict)

    def write(self, w: Writer) -> None:
        w.varint(self.msg_id)
        w.string(self.name)
        w.map(self.metadata, lambda w, k: w.string(k), lambda w, v: w.string(v))

    @classmethod
    def read(cls, r: Reader) -> "MsgMetadata":
        return cls(
            r.varint(), r.string(), r.map(lambda r: r.string(), lambda r: r.string())
        )


@dataclass
class DumpMetadataResp(MsgBase):
    ID = bytes([224, 15])
    component_metadata: list = dc_field(default_factory=list)
    msg_metadata: list = dc_field(default_factory=list)
    db_config: dict = dc_field(default_factory=dict)

    def write(self, w: Writer) -> None:
        w.seq(self.component_metadata, lambda w, m: m.write(w))
        w.seq(self.msg_metadata, lambda w, m: m.write(w))
        # DbConfig serialized as a simplified map-like struct; we emit the
        # reference's field order with defaults (recording, time_step)
        w.bool(self.db_config.get("recording", True))
        w.varint(self.db_config.get("default_stream_time_step", int(1e9 / 60)))

    @classmethod
    def read(cls, r: Reader) -> "DumpMetadataResp":
        comps = r.seq(lambda r: ComponentMetadata.read(r))
        msgs = r.seq(lambda r: MsgMetadata.read(r))
        cfg = {}
        if r.remaining():
            cfg["recording"] = r.bool()
        if r.remaining():
            cfg["default_stream_time_step"] = r.varint()
        return cls(comps, msgs, cfg)


@dataclass
class GetEarliestTimestamp(MsgBase):
    ID = bytes([224, 22])

    def write(self, w: Writer) -> None:
        pass

    @classmethod
    def read(cls, r: Reader) -> "GetEarliestTimestamp":
        return cls()


@dataclass
class EarliestTimestamp(MsgBase):
    ID = bytes([224, 23])
    timestamp: int = 0

    def write(self, w: Writer) -> None:
        w.zigzag(self.timestamp)

    @classmethod
    def read(cls, r: Reader) -> "EarliestTimestamp":
        return cls(r.zigzag())


@dataclass
class DumpSchema(MsgBase):
    ID = bytes([224, 24])

    def write(self, w: Writer) -> None:
        pass

    @classmethod
    def read(cls, r: Reader) -> "DumpSchema":
        return cls()


@dataclass
class DumpSchemaResp(MsgBase):
    ID = bytes([224, 25])
    schemas: dict = dc_field(default_factory=dict)  # component_id -> SchemaMsg

    def write(self, w: Writer) -> None:
        w.map(
            self.schemas,
            lambda w, k: w.varint(k),
            lambda w, v: v.write(w),
        )

    @classmethod
    def read(cls, r: Reader) -> "DumpSchemaResp":
        return cls(r.map(lambda r: r.varint(), lambda r: SchemaMsg.read(r)))


@dataclass
class StreamTimestamp(MsgBase):
    ID = bytes([224, 26])
    timestamp: int = 0
    stream_id: int = 0

    def write(self, w: Writer) -> None:
        w.zigzag(self.timestamp)
        w.varint(self.stream_id)

    @classmethod
    def read(cls, r: Reader) -> "StreamTimestamp":
        return cls(r.zigzag(), r.varint())


@dataclass
class SQLQuery(MsgBase):
    ID = bytes([224, 27])
    query: str = ""

    def write(self, w: Writer) -> None:
        w.string(self.query)

    @classmethod
    def read(cls, r: Reader) -> "SQLQuery":
        return cls(r.string())


@dataclass
class ArrowIPC(MsgBase):
    ID = bytes([224, 28])
    batch: bytes | None = None

    def write(self, w: Writer) -> None:
        w.option(self.batch, lambda w, v: w.bytes_(v))

    @classmethod
    def read(cls, r: Reader) -> "ArrowIPC":
        return cls(r.option(lambda r: r.bytes_()))


@dataclass
class ErrorResponse(MsgBase):
    ID = bytes([224, 29])
    description: str = ""

    def write(self, w: Writer) -> None:
        w.string(self.description)

    @classmethod
    def read(cls, r: Reader) -> "ErrorResponse":
        return cls(r.string())


@dataclass
class SetMsgMetadata(MsgBase):
    ID = bytes([224, 31])
    id: bytes = b"\x00\x00"
    metadata: MsgMetadata = None

    def write(self, w: Writer) -> None:
        w.raw(self.id)
        self.metadata.write(w)

    @classmethod
    def read(cls, r: Reader) -> "SetMsgMetadata":
        return cls(r.raw(2), MsgMetadata.read(r))


@dataclass
class MsgStream(MsgBase):
    ID = auto_msg_id("MsgStream")
    msg_id: bytes = b"\x00\x00"

    def write(self, w: Writer) -> None:
        w.raw(self.msg_id)

    @classmethod
    def read(cls, r: Reader) -> "MsgStream":
        return cls(r.raw(2))


@dataclass
class GetMsgs(MsgBase):
    ID = bytes([224, 34])
    msg_id: bytes = b"\x00\x00"
    start: int = 0
    stop: int = 0
    limit: int | None = None

    def write(self, w: Writer) -> None:
        w.raw(self.msg_id)
        w.zigzag(self.start)
        w.zigzag(self.stop)
        w.option(self.limit, lambda w, v: w.varint(v))

    @classmethod
    def read(cls, r: Reader) -> "GetMsgs":
        return cls(r.raw(2), r.zigzag(), r.zigzag(), r.option(lambda r: r.varint()))


@dataclass
class MsgBatch(MsgBase):
    ID = bytes([224, 35])
    data: list = dc_field(default_factory=list)  # [(timestamp, bytes)]

    def write(self, w: Writer) -> None:
        def item(w, tv):
            ts, data = tv
            w.zigzag(ts)
            w.bytes_(data)

        w.seq(self.data, item)

    @classmethod
    def read(cls, r: Reader) -> "MsgBatch":
        def item(r):
            return (r.zigzag(), r.bytes_())

        return cls(r.seq(item))


@dataclass
class SaveArchive(MsgBase):
    ID = auto_msg_id("SaveArchive")
    path: str = ""
    format: str = "arrow_ipc"  # arrow_ipc | parquet | csv

    _FORMATS = ["arrow_ipc", "parquet", "csv"]

    def write(self, w: Writer) -> None:
        w.string(self.path)
        w.discriminant(self._FORMATS.index(self.format))

    @classmethod
    def read(cls, r: Reader) -> "SaveArchive":
        path = r.string()
        return cls(path, cls._FORMATS[r.discriminant()])


@dataclass
class ArchiveSaved(MsgBase):
    ID = auto_msg_id("ArchiveSaved")
    path: str = ""

    def write(self, w: Writer) -> None:
        w.string(self.path)

    @classmethod
    def read(cls, r: Reader) -> "ArchiveSaved":
        return cls(r.string())


@dataclass
class SubscribeLastUpdated(MsgBase):
    ID = bytes([224, 17])

    def write(self, w: Writer) -> None:
        pass

    @classmethod
    def read(cls, r: Reader) -> "SubscribeLastUpdated":
        return cls()


@dataclass
class LastUpdated(MsgBase):
    ID = bytes([224, 18])
    timestamp: int = 0

    def write(self, w: Writer) -> None:
        w.zigzag(self.timestamp)

    @classmethod
    def read(cls, r: Reader) -> "LastUpdated":
        return cls(r.zigzag())


@dataclass
class SetDbConfig(MsgBase):
    ID = bytes([224, 19])
    recording: bool | None = None

    def write(self, w: Writer) -> None:
        w.option(self.recording, lambda w, v: w.bool(v))

    @classmethod
    def read(cls, r: Reader) -> "SetDbConfig":
        return cls(r.option(lambda r: r.bool()) if r.remaining() else None)


@dataclass
class GetDbSettings(MsgBase):
    ID = bytes([224, 21])

    def write(self, w: Writer) -> None:
        pass

    @classmethod
    def read(cls, r: Reader) -> "GetDbSettings":
        return cls()


@dataclass
class DbConfig(MsgBase):
    ID = bytes([224, 20])
    recording: bool = True
    default_stream_time_step_ns: int = int(1e9 / 60)
    metadata: dict = dc_field(default_factory=dict)

    def write(self, w: Writer) -> None:
        w.bool(self.recording)
        w.varint(self.default_stream_time_step_ns // 1_000_000_000)
        w.varint(self.default_stream_time_step_ns % 1_000_000_000)
        w.map(self.metadata, lambda w, k: w.string(k), lambda w, v: w.string(v))

    @classmethod
    def read(cls, r: Reader) -> "DbConfig":
        rec = r.bool()
        ns = r.varint() * 1_000_000_000 + r.varint()
        meta = r.map(lambda r: r.string(), lambda r: r.string()) if r.remaining() else {}
        return cls(rec, ns, meta)


@dataclass
class StoreAsset(MsgBase):
    ID = bytes([224, 40])
    key: str = ""
    data: bytes = b""

    def write(self, w: Writer) -> None:
        w.string(self.key)
        w.bytes_(self.data)

    @classmethod
    def read(cls, r: Reader) -> "StoreAsset":
        return cls(r.string(), r.bytes_())


@dataclass
class UdpUnicast(MsgBase):
    ID = auto_msg_id("UdpUnicast")
    stream: Stream = dc_field(default_factory=Stream)
    addr: str = ""

    def write(self, w: Writer) -> None:
        self.stream.write(w)
        w.string(self.addr)

    @classmethod
    def read(cls, r: Reader) -> "UdpUnicast":
        return cls(Stream.read(r), r.string())


@dataclass
class LogEntry(MsgBase):
    """Structured FSW text-log entry (impeller2/wkt/src/msgs.rs:639 —
    level: 0 trace, 1 debug, 2 info, 3 warn, 4 error).  Sent on a MsgLog
    stream named by the producer (see examples/logstream)."""

    ID = auto_msg_id("LogEntry")
    level: int = 2
    message: str = ""

    def write(self, w: Writer) -> None:
        w.u8(self.level)
        w.string(self.message)

    @classmethod
    def read(cls, r: Reader) -> "LogEntry":
        return cls(r.u8(), r.string())


@dataclass
class VTableStream(MsgBase):
    """Subscribe to raw tables tagged with one vtable id
    (impeller2/wkt/src/msgs.rs:33-48, db dispatch lib.rs:2558)."""

    ID = auto_msg_id("VTableStream")
    id: bytes = b"\x00\x00"

    def write(self, w: Writer) -> None:
        w.raw(self.id)

    @classmethod
    def read(cls, r: Reader) -> "VTableStream":
        return cls(r.raw(2))


@dataclass
class SparklineQuery(MsgBase):
    """Server-side LTTB-downsampled series for the editor's sparklines
    (msgs.rs:549-563); replies ArrowIPC."""

    ID = bytes([224, 36])
    table_name: str = ""
    max_points: int = 0

    def write(self, w: Writer) -> None:
        w.string(self.table_name)
        w.varint(self.max_points)

    @classmethod
    def read(cls, r: Reader) -> "SparklineQuery":
        return cls(r.string(), r.varint())


@dataclass
class PlotOverviewQuery(MsgBase):
    """Downsampled historical window for the plot panel (msgs.rs:565-590);
    replies an OwnedTimeSeries packet keyed by ``id``."""

    ID = bytes([224, 32])
    id: bytes = b"\x00\x00"
    component_id: int = 0
    start: int = 0
    stop: int = 0
    max_points: int = 0
    element_index: int = 0

    def write(self, w: Writer) -> None:
        w.raw(self.id)
        w.varint(self.component_id)
        w.zigzag(self.start)
        w.zigzag(self.stop)
        w.varint(self.max_points)
        w.varint(self.element_index)

    @classmethod
    def read(cls, r: Reader) -> "PlotOverviewQuery":
        return cls(
            r.raw(2), r.varint(), r.zigzag(), r.zigzag(), r.varint(), r.varint()
        )


@dataclass
class FixedRateMsgStream(MsgBase):
    """Fixed-rate replay of a message log (msgs.rs:680-688)."""

    ID = auto_msg_id("FixedRateMsgStream")
    msg_id: bytes = b"\x00\x00"
    fixed_rate: FixedRateOp = dc_field(default_factory=FixedRateOp)

    def write(self, w: Writer) -> None:
        w.raw(self.msg_id)
        self.fixed_rate.write(w)

    @classmethod
    def read(cls, r: Reader) -> "FixedRateMsgStream":
        return cls(r.raw(2), FixedRateOp.read(r))


@dataclass
class TimestampedMsgStream(MsgBase):
    """MsgStream preserving source timestamps (msgs.rs:786-795), used by
    follow replication."""

    ID = bytes([224, 38])
    msg_id: bytes = b"\x00\x00"

    def write(self, w: Writer) -> None:
        w.raw(self.msg_id)

    @classmethod
    def read(cls, r: Reader) -> "TimestampedMsgStream":
        return cls(r.raw(2))


@dataclass
class FollowStream(MsgBase):
    """Unified replication stream: metadata + schemas + history + live
    (msgs.rs:760-775)."""

    ID = bytes([224, 37])
    target_packet_size: int = 1500

    def write(self, w: Writer) -> None:
        w.varint(self.target_packet_size)

    @classmethod
    def read(cls, r: Reader) -> "FollowStream":
        return cls(r.varint() if r.remaining() else 1500)


@dataclass
class NewConnection(MsgBase):
    """Connection hello (msgs.rs:434-438)."""

    ID = bytes([225, 1])

    def write(self, w: Writer) -> None:
        pass

    @classmethod
    def read(cls, r: Reader) -> "NewConnection":
        return cls()


@dataclass
class ConnectionSettings(MsgBase):
    """Per-connection behavior flags (msgs.rs:440-448): silent=True means
    the server sends no replies on this connection."""

    ID = bytes([224, 39])
    silent: bool = False

    def write(self, w: Writer) -> None:
        w.bool(self.silent)

    @classmethod
    def read(cls, r: Reader) -> "ConnectionSettings":
        return cls(r.bool() if r.remaining() else False)


@dataclass
class GetMsgMetadata(MsgBase):
    """Request a message log's metadata (msgs.rs:690-701)."""

    ID = bytes([224, 33])
    msg_id: bytes = b"\x00\x00"

    def write(self, w: Writer) -> None:
        w.raw(self.msg_id)

    @classmethod
    def read(cls, r: Reader) -> "GetMsgMetadata":
        return cls(r.raw(2))


@dataclass
class UdpVTableStream(MsgBase):
    """Mirror one vtable id's raw tables to a UDP address
    (msgs.rs:733-737)."""

    ID = auto_msg_id("UdpVTableStream")
    id: bytes = b"\x00\x00"
    addr: str = ""

    def write(self, w: Writer) -> None:
        w.raw(self.id)
        w.string(self.addr)

    @classmethod
    def read(cls, r: Reader) -> "UdpVTableStream":
        return cls(r.raw(2), r.string())


@dataclass
class MeanOp(MsgBase):
    """Windowed-mean stream stage, referenced as a vtable ext op
    (msgs.rs:797-799, applied in db/src/vtable_stream.rs:81-83)."""

    ID = auto_msg_id("MeanOp")
    window: int = 0

    def write(self, w: Writer) -> None:
        w.varint(self.window)

    @classmethod
    def read(cls, r: Reader) -> "MeanOp":
        return cls(r.varint())


MSG_TYPES = {
    cls.ID: cls
    for cls in [
        VTableMsg, Stream, FixedRateOp, SetStreamState, GetTimeSeries,
        SchemaMsg, GetSchema, ComponentMetadata, GetComponentMetadata,
        SetComponentMetadata, DumpMetadata, DumpMetadataResp,
        GetEarliestTimestamp, EarliestTimestamp, DumpSchema, DumpSchemaResp,
        StreamTimestamp, SQLQuery, ArrowIPC, ErrorResponse, MsgMetadata,
        SetMsgMetadata, MsgStream, GetMsgs, MsgBatch, SaveArchive, StoreAsset, SubscribeLastUpdated, LastUpdated, SetDbConfig, GetDbSettings, DbConfig,
        ArchiveSaved, UdpUnicast, LogEntry,
        VTableStream, SparklineQuery, PlotOverviewQuery, FixedRateMsgStream,
        TimestampedMsgStream, FollowStream, MeanOp,
        NewConnection, ConnectionSettings, GetMsgMetadata, UdpVTableStream,
    ]
}
