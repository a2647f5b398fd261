"""Foxglove-compatible MCAP export (parity: libs/db/src/export_mcap.rs).

Channel mapping (export_mcap.rs:1-18):
  - each component -> ``/<name with '.' replaced by '/'>`` (JSON object keyed
    by element names, nested at ``.`` boundaries)
  - pose components (``*.world_pos``, 7 elements) -> ``/tf``
    (foxglove.FrameTransforms)
  - schematic ``object_3d`` / static ``vector_arrow`` / ``line_3d`` ->
    ``/scene/<entity>`` (foxglove.SceneUpdate, one topic+message per entity;
    GLBs embedded as base64)
  - dynamic ``vector_arrow`` (EQL-backed) -> ``/scene_dynamic/<name>``
    (separate topics so latest-per-topic backfill keeps every arrow alive)
  - message logs -> foxglove.Log (LogEntry streams), foxglove.CompressedVideo
    (H.264 Annex-B), or raw base64 JSON
  - DB / component metadata -> MCAP metadata records; schematics and
    referenced GLB assets -> MCAP attachments
  - the active schematic also generates ``<name>.foxglove-layout.json``

The writer is dependency-free and non-chunked/uncompressed (both optional
per the public MCAP spec) but writes a full summary section — schema and
channel repeats, statistics, attachment and metadata indexes, and summary
offsets — so index-based readers (``mcap.Summary::read``) work.

Foxglove channel schemas are the full official foxglove-sdk jsonschemas
(vendored, MIT) — see foxglove_schemas/README.md for why subsets break.

A host-only copy of ``elodin_tpu/db/export_mcap.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import fnmatch
import functools
import heapq
import json
import math
import re
import struct
from dataclasses import dataclass, field as dc_field
from pathlib import Path

MAGIC = b"\x89MCAP0\r\n"

OP_HEADER = 0x01
OP_FOOTER = 0x02
OP_SCHEMA = 0x03
OP_CHANNEL = 0x04
OP_MESSAGE = 0x05
OP_ATTACHMENT = 0x09
OP_ATTACHMENT_INDEX = 0x0A
OP_STATISTICS = 0x0B
OP_METADATA = 0x0C
OP_METADATA_INDEX = 0x0D
OP_SUMMARY_OFFSET = 0x0E
OP_DATA_END = 0x0F

_SCHEMA_DIR = Path(__file__).parent / "foxglove_schemas"

_B64 = base64.b64encode


@functools.lru_cache(maxsize=None)
def _schema_bytes(name: str) -> bytes:
    return (_SCHEMA_DIR / f"{name}.json").read_bytes()


SCHEMA_RAW_BYTES = (
    b'{"title": "elodin.RawMessage", "type": "object",'
    b' "properties": {"data": {"type": "string", "contentEncoding": "base64"}}}'
)


def _s(text: str) -> bytes:
    raw = text.encode()
    return struct.pack("<I", len(raw)) + raw


def _record(op: int, payload: bytes) -> bytes:
    return struct.pack("<BQ", op, len(payload)) + payload


def _kv_map(d: dict[str, str]) -> bytes:
    body = b"".join(_s(str(k)) + _s(str(v)) for k, v in d.items())
    return struct.pack("<I", len(body)) + body


class McapWriter:
    """Append-only MCAP writer: data section + attachments + metadata +
    summary section with indexes (non-chunked, uncompressed)."""

    def __init__(self, fh, profile: str = "", library: str = "elodin-tpu"):
        self._fh = fh
        self._next_schema = 1
        self._next_channel = 0
        self._sequences: dict[int, int] = {}
        self._schema_records: list[bytes] = []
        self._channel_records: list[bytes] = []
        self._msg_counts: dict[int, int] = {}
        self._msg_time: list[int] = []  # [min, max]
        self._attachment_indexes: list[bytes] = []
        self._metadata_indexes: list[bytes] = []
        fh.write(MAGIC)
        fh.write(_record(OP_HEADER, _s(profile) + _s(library)))

    def add_schema(self, name: str, encoding: str, data: bytes) -> int:
        sid = self._next_schema
        self._next_schema += 1
        payload = struct.pack("<H", sid) + _s(name) + _s(encoding)
        payload += struct.pack("<I", len(data)) + data
        self._schema_records.append(payload)
        self._fh.write(_record(OP_SCHEMA, payload))
        return sid

    def add_channel(self, topic: str, schema_id: int,
                    message_encoding: str = "json",
                    metadata: dict[str, str] | None = None) -> int:
        cid = self._next_channel
        self._next_channel += 1
        payload = (
            struct.pack("<H", cid)
            + struct.pack("<H", schema_id)
            + _s(topic)
            + _s(message_encoding)
            + _kv_map(metadata or {})
        )
        self._channel_records.append(payload)
        self._fh.write(_record(OP_CHANNEL, payload))
        self._sequences[cid] = 0
        return cid

    def write_message(self, channel_id: int, log_time_ns: int,
                      data: bytes) -> None:
        seq = self._sequences[channel_id]
        self._sequences[channel_id] = seq + 1
        log_time_ns = max(0, int(log_time_ns))
        payload = struct.pack(
            "<HIQQ", channel_id, seq, log_time_ns, log_time_ns
        ) + data
        self._fh.write(_record(OP_MESSAGE, payload))
        self._msg_counts[channel_id] = self._msg_counts.get(channel_id, 0) + 1
        if not self._msg_time:
            self._msg_time = [log_time_ns, log_time_ns]
        else:
            self._msg_time[0] = min(self._msg_time[0], log_time_ns)
            self._msg_time[1] = max(self._msg_time[1], log_time_ns)

    def attach(self, name: str, media_type: str, data: bytes,
               log_time_ns: int = 0) -> None:
        """Attachment record + its summary AttachmentIndex."""
        offset = self._fh.tell()
        payload = (
            struct.pack("<QQ", log_time_ns, log_time_ns)
            + _s(name)
            + _s(media_type)
            + struct.pack("<Q", len(data))
            + data
            + struct.pack("<I", 0)  # crc not computed (allowed by spec)
        )
        rec = _record(OP_ATTACHMENT, payload)
        self._fh.write(rec)
        self._attachment_indexes.append(
            struct.pack("<QQQQQ", offset, len(rec), log_time_ns, log_time_ns,
                        len(data))
            + _s(name)
            + _s(media_type)
        )

    def write_metadata(self, name: str, metadata: dict[str, str]) -> None:
        offset = self._fh.tell()
        rec = _record(OP_METADATA, _s(name) + _kv_map(metadata))
        self._fh.write(rec)
        self._metadata_indexes.append(
            struct.pack("<QQ", offset, len(rec)) + _s(name)
        )

    def finish(self) -> None:
        self._fh.write(_record(OP_DATA_END, struct.pack("<I", 0)))
        # --- summary section: schema/channel repeats, statistics, indexes ---
        groups: list[tuple[int, int, int]] = []  # (opcode, start, length)

        def group(op: int, payloads: list[bytes]) -> None:
            if not payloads:
                return
            start = self._fh.tell()
            for p in payloads:
                self._fh.write(_record(op, p))
            groups.append((op, start, self._fh.tell() - start))

        summary_start = self._fh.tell()
        group(OP_SCHEMA, self._schema_records)
        group(OP_CHANNEL, self._channel_records)
        counts = b"".join(
            struct.pack("<HQ", cid, n)
            for cid, n in sorted(self._msg_counts.items())
        )
        t0, t1 = (self._msg_time or [0, 0])
        stats = (
            struct.pack(
                "<QHIIIIQQ",
                sum(self._msg_counts.values()),
                len(self._schema_records),
                len(self._channel_records),
                len(self._attachment_indexes),
                len(self._metadata_indexes),
                0,  # chunk_count (non-chunked writer)
                t0, t1,
            )
            + struct.pack("<I", len(counts))
            + counts
        )
        group(OP_STATISTICS, [stats])
        group(OP_ATTACHMENT_INDEX, self._attachment_indexes)
        group(OP_METADATA_INDEX, self._metadata_indexes)
        if not groups:
            summary_start = 0
        summary_offset_start = self._fh.tell() if groups else 0
        for op, start, length in groups:
            self._fh.write(
                _record(OP_SUMMARY_OFFSET, struct.pack("<BQQ", op, start, length))
            )
        self._fh.write(
            _record(OP_FOOTER,
                    struct.pack("<QQI", summary_start, summary_offset_start, 0))
        )
        self._fh.write(MAGIC)


# ---------------------------------------------------------------------------
# Reader (round-trip validation + tooling without the mcap package)
# ---------------------------------------------------------------------------


@dataclass
class McapFile:
    channels: dict[int, dict]
    messages: list[tuple[int, int, bytes]]  # (channel_id, log_time_ns, data)
    attachments: list[dict] = dc_field(default_factory=list)
    metadata: list[dict] = dc_field(default_factory=list)
    statistics: dict | None = None
    attachment_indexes: list[dict] = dc_field(default_factory=list)
    metadata_indexes: list[dict] = dc_field(default_factory=list)


def _rd_str(buf, p):
    (ln,) = struct.unpack_from("<I", buf, p)
    return buf[p + 4 : p + 4 + ln].decode(), p + 4 + ln


def _rd_map(buf, p):
    (mlen,) = struct.unpack_from("<I", buf, p)
    q, end = p + 4, p + 4 + mlen
    out = {}
    while q < end:
        k, q = _rd_str(buf, q)
        v, q = _rd_str(buf, q)
        out[k] = v
    return out, end


def read_mcap_full(path: str) -> McapFile:
    """Parse an MCAP file: data section + attachments/metadata + summary."""
    raw = Path(path).read_bytes()
    if raw[:8] != MAGIC or raw[-8:] != MAGIC:
        raise ValueError("not an MCAP file (bad magic)")
    pos = 8
    schemas: dict[int, dict] = {}
    out = McapFile({}, [])
    while pos < len(raw) - 8:
        op, ln = struct.unpack_from("<BQ", raw, pos)
        body = raw[pos + 9 : pos + 9 + ln]
        pos += 9 + ln
        if op == OP_SCHEMA:
            (sid,) = struct.unpack_from("<H", body, 0)
            name, p = _rd_str(body, 2)
            enc, p = _rd_str(body, p)
            (dlen,) = struct.unpack_from("<I", body, p)
            schemas[sid] = {
                "name": name, "encoding": enc,
                "data": bytes(body[p + 4 : p + 4 + dlen]),
            }
        elif op == OP_CHANNEL:
            cid, sid = struct.unpack_from("<HH", body, 0)
            topic, p = _rd_str(body, 4)
            enc, p = _rd_str(body, p)
            meta, _ = _rd_map(body, p)
            out.channels[cid] = {
                "topic": topic,
                "schema": schemas.get(sid),
                "encoding": enc,
                "metadata": meta,
            }
        elif op == OP_MESSAGE:
            cid, _seq, log_t, _pub = struct.unpack_from("<HIQQ", body, 0)
            out.messages.append((cid, log_t, bytes(body[22:])))
        elif op == OP_ATTACHMENT:
            log_t, create_t = struct.unpack_from("<QQ", body, 0)
            name, p = _rd_str(body, 16)
            media, p = _rd_str(body, p)
            (dlen,) = struct.unpack_from("<Q", body, p)
            out.attachments.append({
                "name": name, "media_type": media,
                "log_time": log_t, "create_time": create_t,
                "data": bytes(body[p + 8 : p + 8 + dlen]),
            })
        elif op == OP_METADATA:
            name, p = _rd_str(body, 0)
            meta, _ = _rd_map(body, p)
            out.metadata.append({"name": name, "metadata": meta})
        elif op == OP_STATISTICS:
            (mc, sc, cc, ac, mdc, chc, t0, t1) = struct.unpack_from(
                "<QHIIIIQQ", body, 0
            )
            counts, p = {}, 42
            (clen,) = struct.unpack_from("<I", body, p)
            q, end = p + 4, p + 4 + clen
            while q < end:
                cid, n = struct.unpack_from("<HQ", body, q)
                counts[cid] = n
                q += 10
            out.statistics = {
                "message_count": mc, "schema_count": sc, "channel_count": cc,
                "attachment_count": ac, "metadata_count": mdc,
                "chunk_count": chc, "message_start_time": t0,
                "message_end_time": t1, "channel_message_counts": counts,
            }
        elif op == OP_ATTACHMENT_INDEX:
            off, length, log_t, create_t, dsize = struct.unpack_from(
                "<QQQQQ", body, 0
            )
            name, p = _rd_str(body, 40)
            media, _ = _rd_str(body, p)
            out.attachment_indexes.append({
                "offset": off, "length": length, "name": name,
                "media_type": media, "data_size": dsize,
            })
        elif op == OP_METADATA_INDEX:
            off, length = struct.unpack_from("<QQ", body, 0)
            name, _ = _rd_str(body, 16)
            out.metadata_indexes.append(
                {"offset": off, "length": length, "name": name}
            )
        elif op == OP_FOOTER:
            break
    return out


def read_mcap(path: str):
    """Back-compat reader: returns (channels, messages)."""
    f = read_mcap_full(path)
    return f.channels, f.messages


# ---------------------------------------------------------------------------
# Structural EQL analysis (element refs, literal tuples, camera offsets)
# ---------------------------------------------------------------------------
#
# The exporter needs the *shape* of schematic EQL expressions — which
# components they reference, explicit element indices, trailing literal
# tuples — not their values, so it carries a tiny tuple-aware parser
# (reference: export_mcap.rs uses eql::Context::parse_str the same way).

_EQL_TOKEN = re.compile(
    r"\s*(?:(?P<num>-?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)"
    r"|(?P<str>'[^']*'|\"[^\"]*\")|(?P<ident>[A-Za-z_][\w]*)"
    r"|(?P<op>[-+*/().\[\],]))"
)


class _EqlParser:
    def __init__(self, text: str):
        self.tokens: list[tuple[str, object]] = []
        pos = 0
        while pos < len(text):
            m = _EQL_TOKEN.match(text, pos)
            if not m:
                if text[pos:].strip():
                    raise ValueError(f"EQL parse error at {text[pos:]!r}")
                break
            pos = m.end()
            if m.group("num"):
                self.tokens.append(("num", float(m.group("num"))))
            elif m.group("str"):
                self.tokens.append(("str", m.group("str")[1:-1]))
            elif m.group("ident"):
                self.tokens.append(("ident", m.group("ident")))
            else:
                self.tokens.append(("op", m.group("op")))
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else (None, None)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def expect(self, op):
        kind, val = self.next()
        if kind != "op" or val != op:
            raise ValueError(f"EQL: expected {op!r}, got {val!r}")

    def top(self):
        items = [self.expr()]
        while self.peek() == ("op", ","):
            self.next()
            items.append(self.expr())
        return items[0] if len(items) == 1 else ("tuple", items)

    def expr(self):
        node = self.term()
        while self.peek() in (("op", "+"), ("op", "-")):
            _, op = self.next()
            node = ("binop", op, node, self.term())
        return node

    def term(self):
        node = self.postfix()
        while self.peek() in (("op", "*"), ("op", "/")):
            _, op = self.next()
            node = ("binop", op, node, self.postfix())
        return node

    def postfix(self):
        node = self.atom()
        while True:
            kind, val = self.peek()
            if (kind, val) == ("op", "."):
                self.next()
                k2, name = self.next()
                if k2 != "ident":
                    raise ValueError("EQL: expected identifier after '.'")
                if self.peek() == ("op", "("):
                    self.next()
                    args = []
                    while self.peek() != ("op", ")"):
                        args.append(self.expr())
                        if self.peek() == ("op", ","):
                            self.next()
                    self.expect(")")
                    node = ("call", name, node, args)
                elif node[0] == "path":
                    node = ("path", node[1] + "." + name)
                else:
                    node = ("call", name, node, [])
            elif (kind, val) == ("op", "["):
                self.next()
                k2, idx = self.next()
                if k2 != "num":
                    raise ValueError("EQL: expected index")
                self.expect("]")
                node = ("index", node, int(idx))
            else:
                return node

    def atom(self):
        kind, val = self.next()
        if (kind, val) == ("op", "-"):
            return ("binop", "-", ("num", 0.0), self.postfix())
        if kind == "num":
            return ("num", val)
        if kind == "str":
            return ("str", val)
        if kind == "ident":
            return ("path", val)
        if (kind, val) == ("op", "("):
            node = self.top()
            self.expect(")")
            return node
        raise ValueError(f"EQL: unexpected token {val!r}")


def _parse_eql(text: str):
    try:
        return _EqlParser(str(text)).top()
    except ValueError:
        return None


def _flatten_literals(node) -> list[float] | None:
    """All-numeric flatten of a (possibly nested) tuple/num node."""
    if node is None:
        return None
    if node[0] == "num":
        return [node[1]]
    if node[0] == "tuple":
        out: list[float] = []
        for item in node[1]:
            sub = _flatten_literals(item)
            if sub is None:
                return None
            out.extend(sub)
        return out
    return None


def _literal_tuple(text: str) -> list[float] | None:
    """Parse ``"(1, 0, 0)"``-style literal tuples (parse_literal_tuple)."""
    node = _parse_eql(text)
    if node is None or node[0] != "tuple":
        return None
    return _flatten_literals(node)


def _find_literal_tuple(node) -> list[float] | None:
    if node is None:
        return None
    if node[0] == "tuple":
        return _flatten_literals(node)
    if node[0] == "binop":
        return _find_literal_tuple(node[2]) or _find_literal_tuple(node[3])
    return None


def _component_paths(node, out: list) -> None:
    """Collect (dotted_path, index|None) refs in expression order."""
    if node is None:
        return
    kind = node[0]
    if kind == "path":
        out.append((node[1], None))
    elif kind == "index":
        if node[1][0] == "path":
            out.append((node[1][1], node[2]))
        else:
            _component_paths(node[1], out)
    elif kind == "tuple":
        for item in node[1]:
            _component_paths(item, out)
    elif kind == "binop":
        _component_paths(node[2], out)
        _component_paths(node[3], out)
    elif kind == "call":
        _component_paths(node[2], out)
        for a in node[3]:
            _component_paths(a, out)


def _camera_offset(node) -> list[float] | None:
    """Trailing camera offset from a viewport ``pos`` EQL
    (camera_offset_from_pos, export_mcap.rs:649-724): the last 3 literals of
    an added tuple, or the sum of ``translate*`` formula literals."""
    vals = _find_literal_tuple(node)
    if vals is not None and len(vals) >= 3:
        e, n, u = vals[-3:]
        if (e, n, u) != (0.0, 0.0, 0.0):
            return [e, n, u]
        return None

    def formula_offset(nd) -> list[float]:
        if nd is None or nd[0] != "call":
            return [0.0, 0.0, 0.0]
        off = formula_offset(nd[2])
        lits = [a[1] for a in nd[3] if a[0] == "num"]
        name = nd[1]
        add = [0.0, 0.0, 0.0]
        if name in ("translate_world", "translate") and len(lits) == 3:
            add = lits
        elif name in ("translate_world_x", "translate_x") and len(lits) == 1:
            add = [lits[0], 0.0, 0.0]
        elif name in ("translate_world_y", "translate_y") and len(lits) == 1:
            add = [0.0, lits[0], 0.0]
        elif name in ("translate_world_z", "translate_z") and len(lits) == 1:
            add = [0.0, 0.0, lits[0]]
        return [o + a for o, a in zip(off, add)]

    off = formula_offset(node)
    if off != [0.0, 0.0, 0.0]:
        return off
    return None


# ---------------------------------------------------------------------------
# Colors (impeller2-kdl color_names.rs public vocabulary)
# ---------------------------------------------------------------------------

_NAMED_COLORS = {
    "black": (0.0, 0.0, 0.0), "white": (1.0, 1.0, 1.0),
    "blue": (0.0, 0.0, 1.0), "red": (1.0, 0.0, 0.0),
    "orange": (1.0, 0.5, 0.0), "yellow": (1.0, 1.0, 0.0),
    "yalk": (1.0, 0.9, 0.2), "pink": (1.0, 0.7529412, 0.79607844),
    "cyan": (0.0, 1.0, 1.0), "gray": (0.5, 0.5, 0.5),
    "green": (0.0, 1.0, 0.0), "mint": (0.53, 0.87, 0.62),
    "turquoise": (0.41, 0.7, 0.75), "slate": (0.5, 0.44, 1.0),
    "pumpkin": (1.0, 0.44, 0.12), "yolk": (1.0, 0.77, 0.02),
    "peach": (1.0, 0.84, 0.7), "reddish": (0.913, 0.125, 0.0335),
    "hyperblue": (0.08, 0.38, 0.82),
}


def _color_from_text(text: str):
    t = str(text).strip().lower()
    if t in _NAMED_COLORS:
        return (*_NAMED_COLORS[t], 1.0)
    parts = [p.strip() for p in t.strip("()").split(",")]
    try:
        vals = [float(p) for p in parts]
    except ValueError:
        return None
    if len(vals) == 3:
        return (*vals, 1.0)
    if len(vals) == 4:
        return tuple(vals)
    return None


def _node_color(props: dict, children: list, default=(1.0, 1.0, 1.0, 1.0)):
    """Color from a ``color=`` prop or a ``color`` child node (de.rs
    parse_color_from_node_or_children)."""
    val = props.get("color")
    if val is not None:
        c = _color_from_text(val)
        if c:
            return c
    for ch in children or []:
        if getattr(ch, "name", None) != "color":
            continue
        args = list(getattr(ch, "args", []))
        if len(args) == 1 and isinstance(args[0], str):
            c = _color_from_text(args[0])
            if c:
                return c
        nums = [a for a in args if isinstance(a, (int, float))]
        if len(nums) >= 3:
            a = nums[3] if len(nums) > 3 else 1.0
            return (float(nums[0]), float(nums[1]), float(nums[2]), float(a))
        cprops = getattr(ch, "props", {})
        if {"r", "g", "b"} <= set(cprops):
            return (float(cprops["r"]), float(cprops["g"]),
                    float(cprops["b"]), float(cprops.get("a", 1.0)))
    return default


def _color_json(c) -> dict:
    return {"r": c[0], "g": c[1], "b": c[2], "a": c[3]}


def _color_to_hex(c) -> str:
    b = [max(0, min(255, round(v * 255))) for v in c[:3]]
    return f"#{b[0]:02x}{b[1]:02x}{b[2]:02x}"

# ---------------------------------------------------------------------------
# Component export plan
# ---------------------------------------------------------------------------


@dataclass
class _ExportComponent:
    store: object
    name: str
    topic: str
    element_paths: list  # list[list[str]] — nested JSON path per element
    metadata: dict
    pose_entity: str | None  # set for 7-element `<entity>.world_pos`


def _topic_for(name: str) -> str:
    """Component name -> topic path (export_mcap.rs:120: dots become path
    separators)."""
    return "/" + name.replace(".", "/")


_DEFAULT_ELEMENT_NAMES = {3: ["x", "y", "z"], 4: ["x", "y", "z", "w"]}


def _element_paths(store) -> list[list[str]]:
    """Flattened per-element JSON field paths (export_mcap.rs:128): the
    component's element_names metadata when it matches the element count with
    no duplicates, else EQL-style defaults (x,y,z[,w]; scalars -> value;
    numeric otherwise).  Dotted names nest at '.' boundaries."""
    n = store.elem_count
    meta = [
        s.strip()
        for s in (store.metadata.get("element_names") or "").split(",")
        if s.strip()
    ]
    if len(meta) == n and len(set(meta)) == n:
        names = meta
    elif n == 1:
        names = ["value"]
    else:
        names = _DEFAULT_ELEMENT_NAMES.get(n, [str(i) for i in range(n)])
    return [name.split(".") for name in names]


def _element_path_str(paths: list, idx: int) -> str | None:
    if 0 <= idx < len(paths):
        return ".".join(paths[idx])
    return None


def _insert_path(obj: dict, path: list, leaf) -> None:
    for key in path[:-1]:
        obj = obj.setdefault(key, {})
        if not isinstance(obj, dict):
            return
    obj[path[-1]] = leaf


def _component_json_schema(comp: _ExportComponent) -> bytes:
    """jsonschema for one component channel, nested at '.' boundaries
    (export_mcap.rs:178)."""
    prim = comp.store.prim
    if prim in ("f32", "f64"):
        leaf_type = "number"
    elif prim == "bool":
        leaf_type = "boolean"
    else:
        leaf_type = "integer"

    def nested_schema(paths):
        props: dict = {}
        for path in paths:
            node = props
            ok = True
            for key in path[:-1]:
                entry = node.setdefault(
                    key, {"type": "object", "properties": {}}
                )
                if "properties" not in entry:
                    # a leaf already claimed this key (e.g. names "q,q.w");
                    # skip the nested path, matching _insert_path's guard
                    ok = False
                    break
                node = entry["properties"]
            if ok:
                node[path[-1]] = {"type": leaf_type}
        return props

    return json.dumps(
        {
            "title": comp.name,
            "type": "object",
            "properties": nested_schema(comp.element_paths),
        },
        separators=(",", ":"),
    ).encode()


def _json_num(v: float):
    """JSON has no NaN/Inf; mirror serde's Number::from_f64 -> null."""
    return None if (math.isnan(v) or math.isinf(v)) else v


def _row_values(store, row) -> list:
    prim = store.prim
    if prim in ("f32", "f64"):
        return [_json_num(float(v)) for v in row]
    if prim == "bool":
        return [bool(v) for v in row]
    return [int(v) for v in row]


def _component_row_json(comp: _ExportComponent, row) -> bytes:
    obj: dict = {}
    for path, v in zip(comp.element_paths, _row_values(comp.store, row)):
        _insert_path(obj, path, v)
    return json.dumps(obj, separators=(",", ":")).encode()


def _timestamp_json(ts_ns: int) -> dict:
    return {"sec": ts_ns // 1_000_000_000, "nsec": ts_ns % 1_000_000_000}


def _us_to_ns(ts_us: int, offset_us: int) -> int:
    """DB µs -> MCAP ns after the epoch offset; negatives saturate to 0
    (export_mcap.rs:274 — callers pick an offset keeping the range >= 0)."""
    us = int(ts_us) + int(offset_us)
    return us * 1000 if us >= 0 else 0


def _tf_message(entity: str, parent: str, row, ts_ns: int) -> bytes:
    """FrameTransforms body for one `[qx,qy,qz,qw, x,y,z]` pose sample
    (export_mcap.rs:282)."""
    q = [_json_num(float(v)) or 0.0 for v in row[:7]]
    return json.dumps({
        "transforms": [{
            "timestamp": _timestamp_json(ts_ns),
            "parent_frame_id": parent,
            "child_frame_id": entity,
            "translation": {"x": q[4], "y": q[5], "z": q[6]},
            "rotation": {"x": q[0], "y": q[1], "z": q[2], "w": q[3]},
        }]
    }, separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# Quaternion helpers (scalar-last x,y,z,w)
# ---------------------------------------------------------------------------


def _quat_from_x_axis(d: list[float]) -> list[float]:
    """Quaternion rotating +X onto unit `d` (export_mcap.rs:763)."""
    if d[0] > 0.999999:
        return [0.0, 0.0, 0.0, 1.0]
    if d[0] < -0.999999:
        return [0.0, 0.0, 1.0, 0.0]
    ax, ay, az = 0.0, -d[2], d[1]
    w = 1.0 + d[0]
    norm = math.sqrt(ax * ax + ay * ay + az * az + w * w)
    return [ax / norm, ay / norm, az / norm, w / norm]


def _quat_from_euler_deg(r) -> list[float]:
    rx, ry, rz = (math.radians(float(v)) / 2.0 for v in r)
    sx, cx = math.sin(rx), math.cos(rx)
    sy, cy = math.sin(ry), math.cos(ry)
    sz, cz = math.sin(rz), math.cos(rz)
    return [
        sx * cy * cz - cx * sy * sz,
        cx * sy * cz + sx * cy * sz,
        cx * cy * sz - sx * sy * cz,
        cx * cy * cz + sx * sy * sz,
    ]


def _quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return [
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ]


def _quat_rotate_vec(q, v):
    x, y, z, w = q
    vx, vy, vz = v
    tx = 2.0 * (y * vz - z * vy)
    ty = 2.0 * (z * vx - x * vz)
    tz = 2.0 * (x * vy - y * vx)
    return [
        vx + w * tx + (y * tz - z * ty),
        vy + w * ty + (z * tx - x * tz),
        vz + w * tz + (x * ty - y * tx),
    ]


def _quat_from_mat3_cols(c0, c1, c2):
    m00, m10, m20 = c0
    m01, m11, m21 = c1
    m02, m12, m22 = c2
    trace = m00 + m11 + m22
    if trace > 0.0:
        s = math.sqrt(trace + 1.0) * 2.0
        return [(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s]
    if m00 > m11 and m00 > m22:
        s = math.sqrt(1.0 + m00 - m11 - m22) * 2.0
        return [0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s]
    if m11 > m22:
        s = math.sqrt(1.0 + m11 - m00 - m22) * 2.0
        return [(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s]
    s = math.sqrt(1.0 + m22 - m00 - m11) * 2.0
    return [(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s]


# ---------------------------------------------------------------------------
# Geodetic anchor frames (schematic `coordinate` node)
# ---------------------------------------------------------------------------


def _geo_frame_anchors(coord) -> dict | None:
    """world->NED / world->ENU anchors from the schematic's geodetic origin
    (export_mcap.rs:331; WGS84)."""
    try:
        lat = math.radians(float(coord.props.get("lat", 0.0)))
        lon = math.radians(float(coord.props.get("lon", 0.0)))
        alt = float(coord.props.get("alt", 0.0))
    except (TypeError, ValueError):
        return None
    a, e2 = 6_378_137.0, 6.6943799901413165e-3
    slat, clat = math.sin(lat), math.cos(lat)
    slon, clon = math.sin(lon), math.cos(lon)
    n = a / math.sqrt(1.0 - e2 * slat * slat)
    origin = [
        (n + alt) * clat * clon,
        (n + alt) * clat * slon,
        (n * (1.0 - e2) + alt) * slat,
    ]
    east = [-slon, clon, 0.0]
    north = [-slat * clon, -slat * slon, clat]
    up = [clat * clon, clat * slon, slat]
    return {
        "origin_ecef": origin,
        "enu_quat": _quat_from_mat3_cols(east, north, up),
        "ned_quat": _quat_from_mat3_cols(
            north, east, [-up[0], -up[1], -up[2]]
        ),
    }


def _geo_frame_tf_message(anchors: dict, ts_ns: int) -> bytes:
    x, y, z = anchors["origin_ecef"]

    def tf(frame, q):
        return {
            "timestamp": _timestamp_json(ts_ns),
            "parent_frame_id": "world",
            "child_frame_id": frame,
            "translation": {"x": x, "y": y, "z": z},
            "rotation": {"x": q[0], "y": q[1], "z": q[2], "w": q[3]},
        }

    return json.dumps({
        "transforms": [
            tf("NED", anchors["ned_quat"]),
            tf("ENU", anchors["enu_quat"]),
        ]
    }, separators=(",", ":")).encode()

# ---------------------------------------------------------------------------
# Schematic loading + component-ref resolution
# ---------------------------------------------------------------------------

import numpy as np  # noqa: E402  (cursor slicing for trajectories/poses)


def _asset_key(path: str) -> str:
    return str(path)[3:] if str(path).startswith("db:") else str(path)


@dataclass
class _Schematics:
    primary: object | None = None  # elodin_tpu.schematic.Schematic
    windows: list = dc_field(default_factory=list)  # (key, Schematic)
    raw: list = dc_field(default_factory=list)  # (key, bytes)

    def all(self):
        if self.primary is not None:
            yield self.primary
        for _, s in self.windows:
            yield s


def _load_schematics(db) -> _Schematics:
    """Active schematic + its secondary windows from the asset store
    (export_mcap.rs:522 load_schematics).  The active key comes from
    ``db.active_schematic``; fallback: ``schematic.kdl`` then the first
    ``.kdl`` asset."""
    from .. import schematic as sch_mod

    out = _Schematics()
    key = db.active_schematic
    if key is None:
        keys = db.assets.keys()
        if "schematic.kdl" in keys:
            key = "schematic.kdl"
        else:
            kdls = sorted(k for k in keys if k.endswith(".kdl"))
            key = kdls[0] if kdls else None
    if key is None:
        return out
    raw = db.assets.get(key)
    if raw is None:
        return out
    out.raw.append((key, raw))
    try:
        primary = sch_mod.load(raw.decode(), strict=False)
    except (sch_mod.SchematicError, ValueError, UnicodeDecodeError):
        return out
    for window in primary.windows:
        path = window.props.get("path")
        if not path:
            continue
        sub_key = _asset_key(path)
        sub_raw = db.assets.get(sub_key)
        if sub_raw is None:
            continue
        try:
            sub = sch_mod.load(sub_raw.decode(), strict=False)
        except (sch_mod.SchematicError, ValueError, UnicodeDecodeError):
            continue
        out.raw.append((sub_key, sub_raw))
        out.windows.append((sub_key, sub))
    out.primary = primary
    return out


def _resolve_component(path: str, comp_names) -> tuple[str, str | None] | None:
    """Longest dotted-prefix match of `path` against known component names;
    returns (component, remaining element label or None)."""
    parts = path.split(".")
    for cut in range(len(parts), 0, -1):
        prefix = ".".join(parts[:cut])
        if prefix in comp_names:
            rest = ".".join(parts[cut:])
            return prefix, (rest or None)
    return None


def _component_refs(text: str, comp_names) -> list[tuple[str, object]]:
    """Ordered (component, element) refs in an EQL expression; element is an
    int index, a label string, or None for the whole component.  A bare
    entity prefix expands to every component below it."""
    node = _parse_eql(text)
    if node is None:
        return []
    raw: list = []
    _component_paths(node, raw)
    out: list[tuple[str, object]] = []
    for path, idx in raw:
        hit = _resolve_component(path, comp_names)
        if hit is not None:
            comp, label = hit
            out.append((comp, idx if idx is not None else label))
        else:
            prefix = path + "."
            # sorted: comp_names may be a set; keep series order stable
            for name in sorted(comp_names):
                if name.startswith(prefix):
                    out.append((name, None))
    return out


def _entity_for_eql(text: str, comp_names) -> str | None:
    """Entity frame for an EQL expression: the first referenced component's
    prefix before the last dot (export_mcap.rs:577)."""
    refs = _component_refs(text, comp_names)
    if not refs:
        return None
    first = refs[0][0]
    return first.rsplit(".", 1)[0] if "." in first else first


def _literal_pose(text: str) -> list[float] | None:
    """A literal 7-element pose ``(qx,qy,qz,qw, x,y,z)``
    (export_mcap.rs:590)."""
    node = _parse_eql(text)
    vals = _flatten_literals(node) if node is not None else None
    return vals if vals is not None and len(vals) == 7 else None


# ---------------------------------------------------------------------------
# Scene building
# ---------------------------------------------------------------------------

_MAX_LINE_POINTS = 2000
_DYNAMIC_ARROW_MAX_HZ = 30.0


def _sanitize_topic_segment(s: str) -> str:
    return "".join(
        c if (c.isalnum() or c in "-_.") else "-" for c in str(s)
    )


def _scene_topic(entity_id: str) -> str:
    """One topic per entity (`/scene/<id>`): Foxglove backfills only the
    latest message per topic when a 3D panel (re)mounts, so shared topics
    drop entities (export_mcap.rs:888-895)."""
    return f"/scene/{_sanitize_topic_segment(entity_id)}"


def _scene_update_message(entity: dict) -> bytes:
    """SceneUpdate body with every schema-required primitive array present
    (schema-validating consumers reject partial entities,
    export_mcap.rs:869)."""
    for key in ("metadata", "arrows", "cubes", "spheres", "cylinders",
                "lines", "triangles", "texts", "models"):
        entity.setdefault(key, [])
    return json.dumps(
        {"deletions": [], "entities": [entity]}, separators=(",", ":")
    ).encode()


def _identity_pose() -> dict:
    return {
        "position": {"x": 0.0, "y": 0.0, "z": 0.0},
        "orientation": {"x": 0.0, "y": 0.0, "z": 0.0, "w": 1.0},
    }


def _arrow_shaft_length(length: float, scale: float, normalize: bool) -> float:
    """`|v| * scale`, or just `scale` when normalized (matches the editor)."""
    return scale if normalize else length * scale


def _arrow_primitive(direction, total, color, pos) -> dict:
    quat = _quat_from_x_axis(direction)
    return {
        "pose": {
            "position": {"x": pos[0], "y": pos[1], "z": pos[2]},
            "orientation": {
                "x": quat[0], "y": quat[1], "z": quat[2], "w": quat[3],
            },
        },
        "shaft_length": total * 0.8,
        "shaft_diameter": max(total * 0.02, 0.01),
        "head_length": total * 0.2,
        "head_diameter": max(total * 0.06, 0.02),
        "color": _color_json(color),
    }


def _tuple_prop(val) -> list[float] | None:
    """A translate/rotate prop: literal tuple string or a single number."""
    if val is None:
        return None
    if isinstance(val, (int, float)):
        return [float(val)]
    vals = _literal_tuple(str(val))
    return vals


def _next_model_entity_id(frame: str, counts: dict) -> str:
    counts[frame] = counts.get(frame, 0) + 1
    n = counts[frame]
    return f"{frame}-model" if n == 1 else f"{frame}-model-{n}"


def _mesh_color(mesh_node, default=(1.0, 1.0, 1.0, 1.0)):
    """Color for a primitive mesh: `material base_color=` child or color
    props/children."""
    for ch in getattr(mesh_node, "children", []) or []:
        if getattr(ch, "name", None) == "material":
            base = ch.props.get("base_color")
            if base is not None:
                c = _color_from_text(base)
                if c:
                    return c
            c = _node_color(ch.props, ch.children, None)
            if c:
                return c
    return _node_color(
        getattr(mesh_node, "props", {}), getattr(mesh_node, "children", []),
        default,
    )


def _build_object_entity(obj, comp_names, db, ts_ns, max_embed_bytes,
                         follow_entity, literal_counter, model_id_counts,
                         warnings):
    """(entity_json | None, referenced_asset_keys) for one object_3d
    (export_mcap.rs:1247)."""
    entity = _entity_for_eql(obj.eql, comp_names)
    if entity is not None:
        frame, model_pose, is_literal = entity, _identity_pose(), False
    else:
        pose = _literal_pose(obj.eql)
        if pose is None:
            return None, []
        literal_counter[0] += 1
        frame = f"literal-{literal_counter[0]}"
        model_pose = {
            "position": {"x": pose[4], "y": pose[5], "z": pose[6]},
            "orientation": {
                "x": pose[0], "y": pose[1], "z": pose[2], "w": pose[3],
            },
        }
        is_literal = True

    out = {
        "timestamp": _timestamp_json(ts_ns),
        "frame_id": "world" if is_literal else frame,
        "id": _next_model_entity_id(frame, model_id_counts),
        "lifetime": {"sec": 0, "nsec": 0},
        "frame_locked": True,
    }
    referenced: list[str] = []
    mesh = obj.mesh
    kind = getattr(mesh, "name", None)
    if kind == "glb":
        path = mesh.props.get("path") or (mesh.args[0] if mesh.args else None)
        if not path:
            warnings.append(f"object_3d {obj.eql}: glb without a path")
            return None, []
        key = _asset_key(path)
        data = db.assets.get(key)
        if data is None:
            warnings.append(f"object_3d {obj.eql}: GLB asset {key} not found")
            return None, []
        referenced.append(key)
        # max_embed_bytes=None = the LIVE path (/api/scene): models are
        # referenced by URL through the assets HTTP route, never embedded
        # and never dropped
        live_ref = max_embed_bytes is None
        force_embed = (
            not live_ref
            and follow_entity is not None
            and follow_entity == frame
        )
        if not live_ref and not force_embed and len(data) > max_embed_bytes:
            warnings.append(
                f"GLB {key} over embed limit; attached but not embedded"
            )
            return None, referenced
        scale = float(mesh.props.get("scale", 1.0))
        translate = (_tuple_prop(mesh.props.get("translate")) or [0.0] * 3)
        rotate = (_tuple_prop(mesh.props.get("rotate")) or [0.0] * 3)
        if len(translate) < 3:
            translate = (translate + [0.0] * 3)[:3]
        if len(rotate) < 3:
            rotate = (rotate + [0.0] * 3)[:3]
        if is_literal:
            pq = [model_pose["orientation"][k] for k in "xyzw"]
            off = _quat_rotate_vec(pq, translate)
            oq = _quat_mul(pq, _quat_from_euler_deg(rotate))
            glb_pose = {
                "position": {
                    "x": model_pose["position"]["x"] + off[0],
                    "y": model_pose["position"]["y"] + off[1],
                    "z": model_pose["position"]["z"] + off[2],
                },
                "orientation": {
                    "x": oq[0], "y": oq[1], "z": oq[2], "w": oq[3],
                },
            }
        else:
            quat = _quat_from_euler_deg(rotate)
            glb_pose = {
                "position": {
                    "x": translate[0], "y": translate[1], "z": translate[2],
                },
                "orientation": {
                    "x": quat[0], "y": quat[1], "z": quat[2], "w": quat[3],
                },
            }
        out["models"] = [{
            "pose": glb_pose,
            "scale": {"x": scale, "y": scale, "z": scale},
            "color": {"r": 1.0, "g": 1.0, "b": 1.0, "a": 1.0},
            "override_color": False,
            "url": f"/assets/{key}" if live_ref else "",
            "media_type": "model/gltf-binary",
            "data": "" if live_ref else _B64(data).decode(),
        }]
    elif kind == "sphere":
        color = _color_json(_mesh_color(mesh))
        d = 2.0 * float(mesh.props.get("radius", 0.5))
        out["spheres"] = [{
            "pose": model_pose, "size": {"x": d, "y": d, "z": d},
            "color": color,
        }]
    elif kind == "box":
        color = _color_json(_mesh_color(mesh))
        out["cubes"] = [{
            "pose": model_pose,
            "size": {
                "x": float(mesh.props.get("x", 1.0)),
                "y": float(mesh.props.get("y", 1.0)),
                "z": float(mesh.props.get("z", 1.0)),
            },
            "color": color,
        }]
    elif kind == "cylinder":
        color = _color_json(_mesh_color(mesh))
        d = 2.0 * float(mesh.props.get("radius", 0.5))
        out["cylinders"] = [{
            "pose": model_pose,
            "size": {"x": d, "y": d, "z": float(mesh.props.get("height", 1.0))},
            "bottom_scale": 1.0, "top_scale": 1.0, "color": color,
        }]
    elif kind == "plane":
        color = _color_json(_mesh_color(mesh))
        out["cubes"] = [{
            "pose": model_pose,
            "size": {
                "x": float(mesh.props.get("width", 1.0)),
                "y": float(mesh.props.get("depth", 1.0)),
                "z": 0.01,
            },
            "color": color,
        }]
    else:
        # meshless object_3d: entity exists only as a TF follow target
        return None, []
    return out, referenced


def _pose_store(entity: str, comps_by_name: dict):
    comp = comps_by_name.get(f"{entity}.world_pos")
    if comp is None or comp.store.len == 0:
        return None
    return comp.store


def _extract_trajectory(store) -> list[list[float]]:
    """Decimated xyz trajectory (<= _MAX_LINE_POINTS, endpoint kept;
    export_mcap.rs:927)."""
    n = store.len
    step = -(-n // _MAX_LINE_POINTS) if n > _MAX_LINE_POINTS else 1
    vals = store.values[:n]
    pts = [[float(v) for v in vals[i, 4:7]] for i in range(0, n, step)]
    if n > 1 and (n - 1) % step != 0:
        pts.append([float(v) for v in vals[n - 1, 4:7]])
    return pts


def _build_line_entity(line, comp_names, comps_by_name, ts_ns, geo_active,
                       warnings):
    entity = _entity_for_eql(line.eql, comp_names)
    if entity is None:
        return None
    store = _pose_store(entity, comps_by_name)
    if store is None:
        warnings.append(f"line_3d {line.eql}: pose not found")
        return None
    if store.elem_count != 7:
        warnings.append(f"line_3d {line.eql}: non-pose component")
        return None
    points = _extract_trajectory(store)
    if not points:
        return None
    color = _node_color(line.props, getattr(line, "children", []),
                        (0.2, 0.6, 1.0, 1.0))
    frame = line.props.get("frame")
    frame_id = (
        str(frame) if geo_active and str(frame) in ("NED", "ENU") else "world"
    )
    # line_width is a PIXEL width: scale_invariant, never meters
    return {
        "timestamp": _timestamp_json(ts_ns),
        "frame_id": frame_id,
        "id": f"{entity}-line",
        "lifetime": {"sec": 0, "nsec": 0},
        "frame_locked": False,
        "lines": [{
            "type": 0,  # LINE_STRIP
            "pose": _identity_pose(),
            "thickness": float(line.props.get("line_width", 1.0)),
            "scale_invariant": True,
            "points": [{"x": p[0], "y": p[1], "z": p[2]} for p in points],
            "color": _color_json(color),
            "colors": [],
            "indices": [],
        }],
    }


def _static_arrow_origin(origin, comp_names, comps_by_name):
    """World-frame origin for a static arrow: literal xyz/pose or the first
    `<entity>.world_pos` sample (export_mcap.rs:1403)."""
    if origin is None:
        return [0.0, 0.0, 0.0]
    vals = _literal_tuple(str(origin))
    if vals is not None:
        if len(vals) >= 7:
            return vals[-3:]
        if len(vals) >= 3:
            return vals[:3]
        return None
    entity = _entity_for_eql(str(origin), comp_names)
    if entity is None:
        return None
    store = _pose_store(entity, comps_by_name)
    if store is None:
        return None
    row = store.values[0]
    return [float(row[4]), float(row[5]), float(row[6])]


def _build_static_arrow(arrow, comp_names, comps_by_name):
    """(frame, ArrowPrimitive) for a literal-vector arrow; body-frame arrows
    ride the origin entity's TF, world-frame arrows sit on `world` with an
    absolute origin (export_mcap.rs:1442)."""
    vals = _literal_tuple(str(arrow.vector))
    if vals is None or len(vals) != 3:
        return None
    length = math.sqrt(sum(v * v for v in vals))
    if length == 0.0:
        return None
    direction = [v / length for v in vals]
    scale = float(arrow.props.get("scale", 1.0))
    normalize = bool(arrow.props.get("normalize", False))
    total = _arrow_shaft_length(length, scale, normalize)
    color = _node_color(arrow.props, getattr(arrow, "children", []))
    if arrow.props.get("body_frame"):
        origin = arrow.props.get("origin")
        if origin is None:
            return None
        frame = _entity_for_eql(str(origin), comp_names)
        if frame is None:
            return None
        return frame, _arrow_primitive(direction, total, color, [0.0] * 3)
    pos = _static_arrow_origin(arrow.props.get("origin"), comp_names,
                               comps_by_name)
    if pos is None:
        return None
    return "world", _arrow_primitive(direction, total, color, pos)

def _build_scene(schs: _Schematics, comps, comps_by_name, db, ts_ns,
                 max_embed_bytes, follow_entity, geo_active, warnings):
    """Static scene: one (topic, SceneUpdate body) per entity, plus the
    referenced asset keys (export_mcap.rs:1119 build_scene)."""
    comp_names = set(comps_by_name)
    messages: list[tuple[str, bytes]] = []
    referenced: list[str] = []
    arrow_groups: dict[str, list[dict]] = {}
    literal_counter = [0]
    model_id_counts: dict[str, int] = {}

    def push(entity: dict) -> None:
        messages.append(
            (_scene_topic(entity.get("id", "entity")),
             _scene_update_message(entity))
        )

    # hoisted above the schematic loop (like model_id_counts): two
    # schematics (primary + window) with the same line entity must still
    # get distinct /scene topics
    line_id_counts: dict = {}
    for sch in schs.all():
        for obj in sch.objects:
            entity, assets = _build_object_entity(
                obj, comp_names, db, ts_ns, max_embed_bytes, follow_entity,
                literal_counter, model_id_counts, warnings,
            )
            referenced.extend(assets)
            if entity is not None:
                push(entity)
        for arrow in sch.arrows:
            hit = _build_static_arrow(arrow, comp_names, comps_by_name)
            if hit is not None:
                frame, prim = hit
                arrow_groups.setdefault(frame, []).append(prim)
        for line in sch.lines:
            entity = _build_line_entity(
                line, comp_names, comps_by_name, ts_ns, geo_active, warnings
            )
            if entity is not None:
                # two line_3d nodes on the same entity must not share a
                # topic/id: Foxglove backfills one message per topic
                base = entity["id"]
                line_id_counts[base] = line_id_counts.get(base, 0) + 1
                if line_id_counts[base] > 1:
                    entity["id"] = f"{base}-{line_id_counts[base]}"
                push(entity)

    for frame, arrows in arrow_groups.items():
        push({
            "timestamp": _timestamp_json(ts_ns),
            "frame_id": frame,
            "id": f"{frame}-arrows",
            "lifetime": {"sec": 0, "nsec": 0},
            "frame_locked": True,
            "arrows": arrows,
        })

    return messages, referenced


def _vector_element_indices(text: str, comp_name: str,
                            flat_count: int) -> list[int]:
    """Element indices carrying a dynamic arrow's xyz: an explicit 3-index
    tuple over one component uses those indices, anything else the trailing
    3 elements (matches the editor's value-tail read,
    export_mcap.rs:1979)."""
    node = _parse_eql(text)
    if node is not None and node[0] == "tuple" and len(node[1]) == 3:
        idxs = []
        for item in node[1]:
            if (item[0] == "index" and item[1][0] == "path"
                    and item[1][1] == comp_name):
                idxs.append(item[2])
        if len(idxs) == 3 and all(0 <= i < flat_count for i in idxs):
            return idxs
    return [flat_count - 3, flat_count - 2, flat_count - 1]


def _pose_translation_at(store, ts_us: int) -> list[float]:
    """Last pose-sample translation at or before ts (FOHold,
    export_mcap.rs:2006)."""
    n = store.len
    idx = int(np.searchsorted(store.timestamps[:n], ts_us, side="right")) - 1
    idx = max(0, idx)
    row = store.values[idx]
    return [float(row[4]), float(row[5]), float(row[6])]


def _build_dynamic_arrows(schs: _Schematics, comps_by_name, epoch_offset_us):
    """EQL-backed vector arrows: one `/scene_dynamic/<name>` topic with a
    <=30 Hz (ts_us, SceneUpdate body) stream each (export_mcap.rs:2030)."""
    comp_names = set(comps_by_name)
    streams: list[tuple[str, list[tuple[int, bytes]]]] = []
    for sch in schs.all():
        for arrow in sch.arrows:
            if _literal_tuple(str(arrow.vector)) is not None:
                continue
            refs = _component_refs(str(arrow.vector), comp_names)
            if not refs:
                continue
            comp_name = refs[0][0]
            comp = comps_by_name.get(comp_name)
            if comp is None or comp.store.len == 0:
                continue
            flat_count = comp.store.elem_count
            if flat_count < 3:
                continue
            vec_entity = (
                comp_name.rsplit(".", 1)[0] if "." in comp_name else comp_name
            )
            ix, iy, iz = _vector_element_indices(
                str(arrow.vector), comp_name, flat_count
            )
            body_frame = bool(arrow.props.get("body_frame"))
            origin_prop = arrow.props.get("origin")
            if body_frame:
                frame = (
                    _entity_for_eql(str(origin_prop), comp_names)
                    if origin_prop is not None else None
                ) or vec_entity
                origin_store, fixed_origin = None, [0.0, 0.0, 0.0]
            else:
                frame = "world"
                origin_store, fixed_origin = None, [0.0, 0.0, 0.0]
                lit = (
                    _literal_tuple(str(origin_prop))
                    if origin_prop is not None else None
                )
                if lit is not None:
                    if len(lit) >= 7:
                        fixed_origin = lit[-3:]
                    elif len(lit) >= 3:
                        fixed_origin = lit[:3]
                    else:
                        continue
                else:
                    origin_entity = (
                        _entity_for_eql(str(origin_prop), comp_names)
                        if origin_prop is not None else None
                    ) or vec_entity
                    origin_store = _pose_store(origin_entity, comps_by_name)

            arrow_id = arrow.props.get("name") or f"{comp_name}-arrow"
            topic = f"/scene_dynamic/{_sanitize_topic_segment(arrow_id)}"
            ordinal = 1
            while any(t == topic for t, _ in streams):
                ordinal += 1
                topic = (
                    f"/scene_dynamic/{_sanitize_topic_segment(arrow_id)}"
                    f"-{ordinal}"
                )
            scale = float(arrow.props.get("scale", 1.0))
            normalize = bool(arrow.props.get("normalize", False))
            color = _node_color(arrow.props, getattr(arrow, "children", []))
            min_step_us = int(1_000_000.0 / _DYNAMIC_ARROW_MAX_HZ)
            last_emit: int | None = None
            entries: list[tuple[int, bytes]] = []
            store = comp.store
            n = store.len
            for i in range(n):
                ts_us = int(store.timestamps[i])
                if last_emit is not None and ts_us - last_emit < min_step_us:
                    continue
                row = store.values[i]
                vx, vy, vz = float(row[ix]), float(row[iy]), float(row[iz])
                length = math.sqrt(vx * vx + vy * vy + vz * vz)
                if length < 1e-12:
                    # zero samples don't advance the throttle
                    continue
                direction = [vx / length, vy / length, vz / length]
                total = _arrow_shaft_length(length, scale, normalize)
                pos = (
                    _pose_translation_at(origin_store, ts_us)
                    if origin_store is not None else fixed_origin
                )
                entity = {
                    "timestamp": _timestamp_json(
                        _us_to_ns(ts_us, epoch_offset_us)
                    ),
                    "frame_id": frame,
                    "id": arrow_id,
                    "lifetime": {"sec": 0, "nsec": 0},
                    "frame_locked": True,
                    "arrows": [
                        _arrow_primitive(direction, total, color, pos)
                    ],
                }
                entries.append((ts_us, _scene_update_message(entity)))
                last_emit = ts_us
            if entries:
                entries.sort(key=lambda e: e[0])
                streams.append((topic, entries))
    return streams

# ---------------------------------------------------------------------------
# Foxglove layout generation
# ---------------------------------------------------------------------------

_PANEL_LABELS = {
    "viewport": "Viewport", "graph": "Graph", "tabs": "Tabs",
    "hsplit": "Horizontal Split", "vsplit": "Vertical Split",
    "component_monitor": "Component Monitor", "query_table": "Query Table",
    "query_plot": "Query Plot", "video_stream": "Video Stream",
    "inspector": "Inspector", "hierarchy": "Hierarchy",
    "schematic_tree": "Schematic Tree", "data_overview": "Data Overview",
    "action_pane": "Action Pane", "sensor_view": "Sensor View",
}


def _collapse(panel):
    """Descend through single-child `tabs` wrappers only (Panel::collapse,
    impeller2/wkt/src/gui.rs:356 — splits keep their identity so their
    names stay usable as tab titles)."""
    while panel.kind == "tabs" and len(panel.children) == 1:
        panel = panel.children[0]
    return panel


def _panel_title(panel) -> str:
    name = panel.props.get("name")
    if name:
        return str(name)
    if panel.kind == "graph":
        eql = panel.props.get("eql") or ", ".join(
            str(a) for a in panel.args
        )
        return eql or "Graph"
    return _PANEL_LABELS.get(panel.kind, panel.kind)


class _LayoutBuilder:
    """Schematic panel tree -> Foxglove layout mosaic
    (export_mcap.rs:1479 LayoutBuilder)."""

    def __init__(self, comps_by_name, follow_entity, frame_entities,
                 scene_topics, warnings):
        self.config_by_id: dict[str, dict] = {}
        self.counter = 0
        self.comps_by_name = comps_by_name
        self.comp_names = set(comps_by_name)
        self.follow_entity = follow_entity
        self.frame_entities = frame_entities
        self.scene_topics = scene_topics
        self.warnings = warnings

    def add_panel(self, kind: str, config: dict) -> str:
        self.counter += 1
        pid = f"{kind}!elodin{self.counter}"
        self.config_by_id[pid] = config
        return pid

    # -- plot series ------------------------------------------------------

    def series_for_eql(self, eql_src: str) -> list[dict]:
        out: list[dict] = []
        for comp_name, elem in _component_refs(eql_src, self.comp_names):
            comp = self.comps_by_name.get(comp_name)
            if comp is None:
                continue
            short = comp_name.rsplit(".", 1)[-1]
            paths = comp.element_paths
            if elem is None:
                idxs = range(len(paths))
            elif isinstance(elem, int):
                idxs = [elem] if 0 <= elem < len(paths) else []
            else:
                idxs = [
                    i for i, p in enumerate(paths) if ".".join(p) == elem
                ]
            for i in idxs:
                path = _element_path_str(paths, i)
                out.append({
                    "value": f"{comp.topic}.{path}",
                    "enabled": True,
                    "timestampMethod": "receiveTime",
                    "label": f"{short}.{path}",
                })
        return out

    # -- panels -----------------------------------------------------------

    def panel_node(self, panel):
        kind = panel.kind
        if kind == "viewport":
            return self._viewport(panel)
        if kind == "graph":
            eql = panel.props.get("eql") or ", ".join(
                str(a) for a in panel.args
            )
            config = {
                "title": str(panel.props.get("name") or eql),
                "paths": self.series_for_eql(eql),
                "showXAxisLabels": True,
                "showYAxisLabels": True,
                "showLegend": True,
                "legendDisplay": "floating",
                "showPlotValuesInLegend": False,
                "isSynced": True,
                "xAxisVal": "timestamp",
                "sidebarDimension": 240,
            }
            return self.add_panel("Plot", config)
        if kind == "component_monitor":
            comp_name = (
                panel.props.get("component_name")
                or panel.props.get("component")
            )
            if not comp_name:
                return None
            return self.add_panel("RawMessages", {
                "topicPath": _topic_for(str(comp_name)),
                "diffEnabled": False,
                "diffMethod": "custom",
                "diffTopicPath": "",
                "showFullMessageForDiff": False,
                "expansion": "all",
            })
        if kind == "video_stream":
            msg_name = panel.props.get("msg_name")
            if not msg_name:
                return None
            return self.add_panel("Image", {
                "imageMode": {"imageTopic": f"/video/{msg_name}"},
            })
        if kind in ("hsplit", "vsplit"):
            direction = "row" if kind == "hsplit" else "column"
            children = []
            for child in panel.children:
                node = self.panel_node(child)
                if node is not None:
                    share = float(child.props.get("share", 1.0) or 1.0)
                    children.append((node, max(share, 0.001)))
            return _fold_split(children, direction)
        if kind == "tabs":
            tabs = []
            for child in panel.children:
                title = _panel_title(_collapse(child))
                node = self.panel_node(child)
                tabs.append(
                    {"title": title, "layout": node}
                    if node is not None else {"title": title}
                )
            if not tabs:
                return None
            return self.add_panel("Tab", {"activeTabIdx": 0, "tabs": tabs})
        # no Foxglove equivalent (inspector/hierarchy/query_*/gauges/...)
        return None

    def _viewport(self, panel):
        props = panel.props
        layers: dict = {}
        if props.get("show_grid"):
            layers["grid"] = {
                "layerId": "foxglove.Grid", "instanceId": "grid",
                "label": "Grid", "visible": True, "frameId": "world",
                "size": 10, "divisions": 10, "lineWidth": 1,
                "color": "#a0a0a4", "position": [0, 0, 0],
                "rotation": [0, 0, 0], "order": 1,
            }
        pos = props.get("pos")
        offset = None
        if pos is not None:
            node = _parse_eql(str(pos))
            if node is not None:
                offset = _camera_offset(node)
        frame_name = props.get("frame")
        if frame_name == "NED" and offset is not None:
            # NED offsets are (north, east, down); convert to ENU
            n, e, d = offset
            offset = [e, n, -d]
        if offset is not None:
            e, n, u = offset
            distance = math.sqrt(e * e + n * n + u * u)
            phi = math.degrees(math.acos(max(-1.0, min(1.0, u / distance))))
            theta = math.degrees(math.atan2(e, n))
        else:
            # 3/4 view matching the drone example's (2,2,2) vantage
            distance, phi, theta = 6.0, 54.7356, 45.0
        near = float(props.get("near", 0.01))
        far_prop = props.get("far")
        far = (
            max(float(far_prop), distance * 4.0)
            if far_prop is not None else max(distance * 4.0, 5000.0)
        )
        config: dict = {
            "cameraState": {
                "perspective": True,
                "distance": distance,
                "phi": phi,
                "thetaOffset": theta,
                "targetOffset": [0, 0, 0],
                "target": [0, 0, 0],
                "targetOrientation": [0, 0, 0, 1],
                "fovy": float(props.get("fov", 45.0)),
                "near": near,
                "far": far,
            },
        }
        look_at = props.get("look_at")
        entity = (
            (_entity_for_eql(str(look_at), self.comp_names)
             if look_at is not None else None)
            or (_entity_for_eql(str(pos), self.comp_names)
                if pos is not None else None)
            or (self.frame_entities.get(str(frame_name))
                if frame_name is not None else None)
            or self.follow_entity
        )
        if entity is not None:
            config["followTf"] = entity
            config["followMode"] = "follow-position"
        config["layers"] = layers
        config["topics"] = {t: {"visible": True} for t in self.scene_topics}
        # hide parent->child TF connecting lines; Elodin draws none
        config["scene"] = {"transforms": {"lineWidth": 0}}
        if props.get("name"):
            config["title"] = str(props["name"])
        return self.add_panel("3D", config)


def _fold_split(children, direction):
    """n-way split -> nested binary mosaic nodes with split percentages
    (export_mcap.rs:1834 fold_split)."""
    if not children:
        return None
    if len(children) == 1:
        return children[0][0]
    (first, first_share), rest = children[0], children[1:]
    rest_share = sum(s for _, s in rest)
    second = _fold_split(rest, direction)
    if second is None:
        return first
    return {
        "first": first,
        "second": second,
        "direction": direction,
        "splitPercentage": first_share / (first_share + rest_share) * 100.0,
    }


def _build_layout(schs: _Schematics, comps_by_name, follow_entity,
                  scene_topics, warnings):
    """Full Foxglove layout JSON: primary top-level tabs plus each secondary
    window become tabs of a root Tab panel (export_mcap.rs:1879)."""
    if schs.primary is None:
        return None
    comp_names = set(comps_by_name)
    frame_entities: dict[str, str] = {}
    for sch in schs.all():
        for obj in sch.objects:
            frame = obj.props.get("frame")
            if frame is None:
                continue
            entity = _entity_for_eql(obj.eql, comp_names)
            if entity is not None:
                frame_entities.setdefault(str(frame), entity)

    builder = _LayoutBuilder(comps_by_name, follow_entity, frame_entities,
                             scene_topics, warnings)
    tabs: list[tuple[str, object]] = []
    for panel in schs.primary.panels:
        if panel.kind == "tabs":
            for sub in panel.children:
                title = _panel_title(_collapse(sub))
                node = builder.panel_node(sub)
                if node is not None:
                    tabs.append((title, node))
        else:
            title = _panel_title(_collapse(panel))
            node = builder.panel_node(panel)
            if node is not None:
                tabs.append((title, node))
    for key, window in schs.windows:
        for panel in window.panels:
            collapsed = _collapse(panel)
            title = _panel_title(collapsed)
            if title in ("Tabs", "Vertical Split", "Horizontal Split"):
                title = key.rsplit("/", 1)[-1].removesuffix(".kdl")
            node = builder.panel_node(collapsed)
            if node is not None:
                tabs.append((title, node))

    if not tabs:
        return None
    root = builder.add_panel("Tab", {
        "activeTabIdx": 0,
        "tabs": [{"title": t, "layout": n} for t, n in tabs],
    })
    return {
        "configById": builder.config_by_id,
        "globalVariables": {},
        "userNodes": {},
        "playbackConfig": {"speed": 1.0},
        "layout": root,
    }

# ---------------------------------------------------------------------------
# Message log classification
# ---------------------------------------------------------------------------


def _is_annex_b(payload: bytes) -> bool:
    """H.264 Annex-B sniff: start code + plausible NAL header
    (export_mcap.rs:418)."""
    if payload.startswith(b"\x00\x00\x00\x01"):
        nal = payload[4] if len(payload) > 4 else None
    elif payload.startswith(b"\x00\x00\x01"):
        nal = payload[3] if len(payload) > 3 else None
    else:
        return False
    if nal is None:
        return False
    return (nal & 0x80) == 0 and 1 <= (nal & 0x1F) <= 23


def _decode_log_entry(payload: bytes) -> tuple[int, str] | None:
    """LogEntry from a JSON dict ({"level","message"}, the Python client's
    encoding) or postcard bytes (u8 level + varint len + utf8, the C/Rust
    clients)."""
    try:
        obj = json.loads(payload)
        if isinstance(obj, dict) and "message" in obj:
            return int(obj.get("level", 2)), str(obj["message"])
    except (UnicodeDecodeError, ValueError):
        pass
    if len(payload) >= 2 and payload[0] <= 4:
        level = payload[0]
        # postcard varint length
        shift, ln, pos = 0, 0, 1
        while pos < len(payload):
            b = payload[pos]
            ln |= (b & 0x7F) << shift
            pos += 1
            if not b & 0x80:
                break
            shift += 7
        if pos + ln == len(payload):
            try:
                return level, payload[pos:].decode()
            except UnicodeDecodeError:
                pass
    return None


def _classify_msg_log(log, name: str, video_names) -> str:
    """"log" | "video" | "raw" (export_mcap.rs:435 classify_msg_log; the
    repo's MsgMetadata carries no full schema, so LogEntry streams are
    tagged metadata={"schema": "LogEntry"} or detected from the payload)."""
    meta = getattr(log.metadata, "metadata", None) or {}
    if meta.get("schema") == "LogEntry":
        return "log"
    first = log.entries[0][1] if log.entries else b""
    if name in video_names or _is_annex_b(first):
        return "video"
    if _decode_log_entry(first) is not None:
        return "log"
    return "raw"


def _msg_log_json(kind: str, name: str, payload: bytes, ts_ns: int) -> bytes:
    if kind == "video":
        value = {
            "timestamp": _timestamp_json(ts_ns),
            "frame_id": name,
            "data": _B64(payload).decode(),
            "format": "h264",
        }
    elif kind == "log":
        decoded = _decode_log_entry(payload)
        if decoded is None:
            level, message = 2, payload.decode("utf-8", "replace")
        else:
            level, message = decoded
        # parity with export_mcap.rs:484-489: trace/debug -> DEBUG(1),
        # info -> INFO(2), warn -> WARN(3), error+ -> ERROR(4)
        fox_level = {0: 1, 1: 1, 2: 2, 3: 3}.get(level, 4)
        value = {
            "timestamp": _timestamp_json(ts_ns),
            "level": fox_level,
            "message": message,
            "name": name,
            # required by foxglove.Log; LogEntry has no source location
            "file": "",
            "line": 0,
        }
    else:
        value = {"data": _B64(payload).decode()}
    return json.dumps(value, separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# Main export
# ---------------------------------------------------------------------------

_MEDIA_TYPES = {
    "glb": "model/gltf-binary", "kdl": "application/kdl",
    "png": "image/png", "jpg": "image/jpeg", "jpeg": "image/jpeg",
    "json": "application/json",
}


def _scene_inputs(db, pattern=None, include_private: bool = False):
    """Shared snapshot for export_mcap() and the live /api/scene path:
    export components (sorted, pose-entity tagged), loaded schematics,
    follow entity, geo frame map and validated anchors."""
    from .export import _is_private

    comps: list[_ExportComponent] = []
    for store in db.components.values():
        if store.len == 0:
            continue
        if _is_private(store) and not include_private:
            continue
        name = store.name or f"{store.component_id:016x}"
        if pattern is not None and not fnmatch.fnmatch(
            name.lower(), pattern.lower()
        ):
            continue
        pose_entity = None
        if name.endswith(".world_pos") and store.elem_count == 7:
            pose_entity = name[: -len(".world_pos")]
        comps.append(_ExportComponent(
            store=store,
            name=name,
            topic=_topic_for(name),
            element_paths=_element_paths(store),
            metadata={
                **store.metadata,
                "elodin.component_id": str(store.component_id),
            },
            pose_entity=pose_entity,
        ))
    comps.sort(key=lambda c: c.name)
    comps_by_name = {c.name: c for c in comps}
    comp_names = set(comps_by_name)
    schs = _load_schematics(db)

    follow_entity = None
    for sch in schs.all():
        for obj in sch.objects:
            follow_entity = _entity_for_eql(obj.eql, comp_names)
            if follow_entity is not None:
                break
        if follow_entity is not None:
            break

    geo_map: dict[str, str] = {}
    for sch in schs.all():
        for obj in sch.objects:
            frame = obj.props.get("frame")
            if str(frame) in ("NED", "ENU"):
                entity = _entity_for_eql(obj.eql, comp_names)
                if entity is not None:
                    geo_map.setdefault(entity, str(frame))
    coord = schs.primary.coordinate if schs.primary is not None else None
    geo_anchors = (
        _geo_frame_anchors(coord) if (coord is not None and geo_map) else None
    )
    return comps, comps_by_name, schs, follow_entity, geo_map, coord, geo_anchors


def export_mcap(db, path: str, *, pattern: str | None = None,
                include_private: bool = False, all_assets: bool = False,
                epoch_offset_us: int | None = None, max_embed_mb: int = 32,
                layout_path: str | None = None) -> int:
    """Export a Database to a Foxglove-compatible MCAP file at ``path``
    (export_mcap.rs:2276 run), plus ``<path minus .mcap>
    .foxglove-layout.json`` when the active schematic has panels.

    Returns the total message count written.  ``pattern`` is a
    case-insensitive glob over component names; ``epoch_offset_us`` shifts
    all timestamps (auto-rebase keeps pre-1970 data ordered instead of
    clamping it, export_mcap.rs:2610-2641)."""
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    warnings: list[str] = []

    # ---- snapshot components / schematics (shared with /api/scene) ------
    (comps, comps_by_name, schs, follow_entity, geo_map, coord,
     geo_anchors) = _scene_inputs(db, pattern, include_private)
    video_names: set[str] = set()
    for sch in schs.all():
        for panel in sch.all_panels():
            if panel.kind == "video_stream" and panel.props.get("msg_name"):
                video_names.add(str(panel.props["msg_name"]))

    msg_logs = []
    for mid, log in db.msg_logs.items():
        if not log.entries:
            continue
        name = (
            getattr(log.metadata, "name", None)
            or f"msg-{int.from_bytes(mid, 'little')}"
        )
        kind = _classify_msg_log(log, name, video_names)
        topic = {"video": f"/video/{name}", "log": f"/log/{name}"}.get(
            kind, f"/msg/{name}"
        )
        msg_logs.append((log, name, kind, topic))
    msg_logs.sort(key=lambda m: m[1])

    # ---- epoch offset ---------------------------------------------------
    all_starts = [int(c.store.timestamps[0]) for c in comps]
    all_starts += [log.entries[0][0] for log, _, _, _ in msg_logs]
    start_us = min(all_starts) if all_starts else 0
    requested = int(epoch_offset_us or 0)
    if start_us + requested < 0:
        # pre-1970 data: rebase so the earliest sample maps to t=0 and
        # relative ordering survives (clamping would flatten it all to 0)
        offset_us = -start_us
        warnings.append(
            f"earliest timestamp {start_us} us is pre-1970; auto-rebasing "
            f"by +{offset_us} us"
        )
    else:
        offset_us = requested
    start_ns = _us_to_ns(start_us, offset_us)

    max_embed_bytes = int(max_embed_mb) * 1024 * 1024

    tf_parents = {
        c.pose_entity: (
            geo_map.get(c.pose_entity, "world")
            if geo_anchors is not None else "world"
        )
        for c in comps if c.pose_entity is not None
    }

    # ---- scene + dynamic arrows ----------------------------------------
    scene_msgs, referenced_assets = _build_scene(
        schs, comps, comps_by_name, db, start_ns, max_embed_bytes,
        follow_entity, geo_anchors is not None, warnings,
    )
    dynamic_arrows = _build_dynamic_arrows(schs, comps_by_name, offset_us)

    # ---- writer + channels ---------------------------------------------
    message_count = 0
    with open(out, "wb") as fh:
        w = McapWriter(fh)
        comp_channels = []
        for comp in comps:
            sid = w.add_schema(
                comp.name, "jsonschema", _component_json_schema(comp)
            )
            comp_channels.append(
                w.add_channel(comp.topic, sid, "json", comp.metadata)
            )

        tf_channel = None
        if any(c.pose_entity is not None for c in comps):
            sid = w.add_schema(
                "foxglove.FrameTransforms", "jsonschema",
                _schema_bytes("FrameTransforms"),
            )
            tf_channel = w.add_channel("/tf", sid, "json")

        msg_channels = []
        for _, name, kind, topic in msg_logs:
            if kind == "video":
                sid = w.add_schema(
                    "foxglove.CompressedVideo", "jsonschema",
                    _schema_bytes("CompressedVideo"),
                )
            elif kind == "log":
                sid = w.add_schema(
                    "foxglove.Log", "jsonschema", _schema_bytes("Log")
                )
            else:
                sid = w.add_schema(
                    "elodin.RawMessage", "jsonschema", SCHEMA_RAW_BYTES
                )
            msg_channels.append(
                w.add_channel(topic, sid, "json", {"elodin.msg_name": name})
            )

        scene_schema_id = None
        if scene_msgs or dynamic_arrows:
            scene_schema_id = w.add_schema(
                "foxglove.SceneUpdate", "jsonschema",
                _schema_bytes("SceneUpdate"),
            )
        for topic, body in scene_msgs:
            cid = w.add_channel(topic, scene_schema_id, "json")
            w.write_message(cid, start_ns, body)
            message_count += 1
        dyn_channels = [
            w.add_channel(topic, scene_schema_id, "json")
            for topic, _ in dynamic_arrows
        ]

        if geo_anchors is not None and tf_channel is not None:
            w.write_message(
                tf_channel, start_ns,
                _geo_frame_tf_message(geo_anchors, start_ns),
            )
            message_count += 1

        # ---- k-way merge over all cursors (global monotonic log_time) --
        # emit(idx) -> (channel_id, payload); one cursor per component,
        # per pose (tf), per msg log, per dynamic arrow.
        cursors: list[tuple[object, object]] = []
        for comp, cid in zip(comps, comp_channels):
            store = comp.store
            ts = store.timestamps[: store.len]
            cursors.append((
                ts,
                lambda i, comp=comp, cid=cid: (
                    cid, _component_row_json(comp, comp.store.values[i])
                ),
            ))
            if comp.pose_entity is not None and tf_channel is not None:
                parent = tf_parents.get(comp.pose_entity, "world")
                cursors.append((
                    ts,
                    lambda i, comp=comp, parent=parent: (
                        tf_channel,
                        _tf_message(
                            comp.pose_entity, parent,
                            comp.store.values[i],
                            _us_to_ns(
                                int(comp.store.timestamps[i]), offset_us
                            ),
                        ),
                    ),
                ))
        for (log, name, kind, _), cid in zip(msg_logs, msg_channels):
            entries = log.entries
            cursors.append((
                [e[0] for e in entries],
                lambda i, entries=entries, kind=kind, name=name, cid=cid: (
                    cid,
                    _msg_log_json(
                        kind, name, entries[i][1],
                        _us_to_ns(entries[i][0], offset_us),
                    ),
                ),
            ))
        for (topic, entries), cid in zip(dynamic_arrows, dyn_channels):
            cursors.append((
                [e[0] for e in entries],
                lambda i, entries=entries, cid=cid: (cid, entries[i][1]),
            ))

        heap = [
            (int(ts[0]), ci, 0) for ci, (ts, _) in enumerate(cursors)
            if len(ts) > 0
        ]
        heapq.heapify(heap)
        while heap:
            ts_us, ci, idx = heapq.heappop(heap)
            ts_arr, emit = cursors[ci]
            cid, payload = emit(idx)
            w.write_message(cid, _us_to_ns(ts_us, offset_us), payload)
            message_count += 1
            if idx + 1 < len(ts_arr):
                heapq.heappush(heap, (int(ts_arr[idx + 1]), ci, idx + 1))

        # ---- metadata records ------------------------------------------
        db_state = {
            "recording": str(bool(getattr(db, "recording", True))).lower(),
            "default_stream_time_step_ns": str(
                getattr(db, "default_stream_time_step_ns", 16_666_666)
            ),
        }
        if offset_us != 0:
            db_state["elodin.time_offset_us"] = str(offset_us)
        w.write_metadata("elodin.db_state", db_state)
        w.write_metadata("elodin.components", {
            c.name: json.dumps(c.metadata, separators=(",", ":"))
            for c in comps
        })

        # ---- attachments -----------------------------------------------
        attached: set[str] = set()

        def attach(key: str, media_type: str, data: bytes) -> None:
            if key in attached:
                return
            attached.add(key)
            w.attach(key, media_type, data, start_ns)

        for key, raw in schs.raw:
            attach(key, "application/kdl", raw)
        for key in referenced_assets:
            data = db.assets.get(key)
            if data is not None:
                attach(key, "model/gltf-binary", data)
        if all_assets:
            for key in db.assets.keys():
                data = db.assets.get(key)
                if data is None:
                    continue
                ext = key.rsplit(".", 1)[-1].lower()
                attach(
                    key,
                    _MEDIA_TYPES.get(ext, "application/octet-stream"),
                    data,
                )

        w.finish()

    # ---- layout ---------------------------------------------------------
    scene_topics = [t for t, _ in scene_msgs] + [t for t, _ in dynamic_arrows]
    layout = _build_layout(
        schs, comps_by_name, follow_entity, scene_topics, warnings
    )
    if layout is not None:
        lp = Path(layout_path) if layout_path else out.with_name(
            out.name.removesuffix(".mcap") + ".foxglove-layout.json"
        )
        lp.write_text(json.dumps(layout, indent=2))

    for msg in warnings:
        print(f"  Warning: {msg}")
    return message_count


def build_scene_json(db, ts_ns: int | None = None) -> dict:
    """Live scene snapshot: the same SceneUpdate entities the MCAP export
    writes (one per /scene topic), parsed to JSON for the webui's
    ``/api/scene`` endpoint — model primitives from object_3d nodes (GLBs
    referenced by their /assets URL, never embedded), trajectory lines,
    static vector arrows, the follow entity, and DYNAMIC-arrow descriptors
    so a live client can animate them from ``/api/series``."""
    warnings: list[str] = []
    (comps, comps_by_name, schs, follow_entity, _geo_map, _coord,
     geo_anchors) = _scene_inputs(db)
    geo_active = geo_anchors is not None

    if ts_ns is None:
        stops = [int(c.store.timestamps[c.store.len - 1]) for c in comps]
        ts_ns = _us_to_ns(max(stops) if stops else 0, 0)
    scene_msgs, referenced = _build_scene(
        schs, comps, comps_by_name, db, ts_ns, None, follow_entity,
        geo_active, warnings,
    )
    entities = []
    for topic, body in scene_msgs:
        update = json.loads(body.decode())
        for ent in update.get("entities", []):
            ent["topic"] = topic
            entities.append(ent)
    # only DYNAMIC (EQL-backed) arrows: literal-vector arrows are already
    # baked into the static scene entities above
    arrows = [
        {"vector": a.vector, "props": a.props}
        for sch in schs.all()
        for a in sch.arrows
        if _literal_tuple(str(a.vector)) is None
    ]
    # live frame poses at ts: the MCAP export carries these on /tf
    # (frame_locked entities move with their frame); the JSON endpoint
    # must bake them in or a live consumer would render everything at
    # identity.  [qx,qy,qz,qw, x,y,z] rows, last-sample-at-or-before hold.
    transforms: dict[str, dict] = {}
    ts_us = ts_ns // 1000
    for ent in entities:
        fid = ent.get("frame_id", "world")
        if fid in transforms or fid == "world" or fid.startswith("literal-"):
            continue
        store = _pose_store(fid, comps_by_name)
        if store is None:
            continue
        n = store.len
        idx = max(0, int(np.searchsorted(
            store.timestamps[:n], ts_us, side="right")) - 1)
        row = [float(v) for v in store.values[idx][:7]]
        transforms[fid] = {
            "position": {"x": row[4], "y": row[5], "z": row[6]},
            "orientation": {
                "x": row[0], "y": row[1], "z": row[2], "w": row[3],
            },
        }
    return {
        "entities": entities,
        "follow_entity": follow_entity,
        "geo_active": geo_active,
        "referenced_assets": referenced,
        "arrows": arrows,
        "transforms": transforms,
        "warnings": warnings,
    }
