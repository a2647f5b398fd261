"""Impeller2 VTable: zero-copy table layout descriptions
(libs/impeller2/src/vtable.rs).

A VTable = {ops, fields, data} where each field's arg is an op-DAG describing
its component id, schema (dtype + shape), and optional timestamp source.
This module builds, (de)serializes (postcard), and *realizes* vtables against
table payload bytes, mirroring the reference's RealizedField iterator.

A host-only copy of ``elodin_tpu/db/vtable.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from .postcard import Reader, Writer, auto_msg_id

TIMESTAMP_NS_EXT_ID = bytes([0x01, 0x00])

# ext-op id for the windowed-mean stream stage (wkt MeanOp, derived msg id)
MEAN_EXT_ID = auto_msg_id("MeanOp")

PRIM_TYPES = ["u8", "u16", "u32", "u64", "i8", "i16", "i32", "i64", "bool", "f32", "f64"]
PRIM_TO_IDX = {p: i for i, p in enumerate(PRIM_TYPES)}
PRIM_NP = {
    "u8": np.dtype("u1"), "u16": np.dtype("<u2"), "u32": np.dtype("<u4"),
    "u64": np.dtype("<u8"), "i8": np.dtype("i1"), "i16": np.dtype("<i2"),
    "i32": np.dtype("<i4"), "i64": np.dtype("<i8"), "bool": np.dtype("?"),
    "f32": np.dtype("<f4"), "f64": np.dtype("<f8"),
}


def component_id_of(name: str) -> int:
    """64-bit FNV-1a of the dotted component name
    (libs/impeller2/src/types.rs:36)."""
    h = 0xCBF29CE484222325
    for b in name.encode():
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def store_name(meta, comp: str, eid) -> str:
    """The telemetry database's name for the store of one (entity,
    component) of a ``WorldMeta``: 'entity.component', with the entity's
    id where it has no name."""
    m = meta.entity_metadata.get(eid)
    ename = m.name if m is not None else None
    return f"{ename}.{comp}" if ename else f"{eid}.{comp}"


# -- op representation -------------------------------------------------------

OP_DATA, OP_TABLE, OP_NONE, OP_COMPONENT, OP_SCHEMA, OP_TIMESTAMP, OP_EXT = range(7)


@dataclass
class Op:
    kind: int
    # Data/Table
    offset: int = 0
    len: int = 0
    # Component
    component_id: int = 0  # OpRef
    # Schema
    ty: int = 0
    dim: int = 0
    arg: int = 0
    # Timestamp
    source: int = 0
    # Ext
    ext_id: bytes = b"\x00\x00"
    data: int = 0


@dataclass
class Field:
    offset: int
    len: int
    arg: int


@dataclass
class VTable:
    ops: list = dc_field(default_factory=list)
    fields: list = dc_field(default_factory=list)
    data: bytearray = dc_field(default_factory=bytearray)

    # -- serde (postcard layout of vtable.rs VTable struct) ---------------

    def write(self, w: Writer) -> None:
        w.varint(len(self.ops))
        for op in self.ops:
            w.discriminant(op.kind)
            if op.kind in (OP_DATA, OP_TABLE):
                w.varint(op.offset)
                w.varint(op.len)
            elif op.kind == OP_NONE:
                pass
            elif op.kind == OP_COMPONENT:
                w.varint(op.component_id)
            elif op.kind == OP_SCHEMA:
                w.varint(op.ty)
                w.varint(op.dim)
                w.varint(op.arg)
            elif op.kind == OP_TIMESTAMP:
                w.varint(op.source)
                w.varint(op.arg)
            elif op.kind == OP_EXT:
                w.varint(op.arg)
                w.raw(op.ext_id)
                w.varint(op.data)
        w.varint(len(self.fields))
        for f in self.fields:
            w.varint(f.offset)
            w.varint(f.len)
            w.varint(f.arg)
        w.bytes_(bytes(self.data))

    @staticmethod
    def read(r: Reader) -> "VTable":
        vt = VTable()
        n_ops = r.varint()
        for _ in range(n_ops):
            kind = r.discriminant()
            op = Op(kind)
            if kind in (OP_DATA, OP_TABLE):
                op.offset = r.varint()
                op.len = r.varint()
            elif kind == OP_NONE:
                pass
            elif kind == OP_COMPONENT:
                op.component_id = r.varint()
            elif kind == OP_SCHEMA:
                op.ty = r.varint()
                op.dim = r.varint()
                op.arg = r.varint()
            elif kind == OP_TIMESTAMP:
                op.source = r.varint()
                op.arg = r.varint()
            elif kind == OP_EXT:
                op.arg = r.varint()
                op.ext_id = r.raw(2)
                op.data = r.varint()
            else:
                raise ValueError(f"unknown vtable op {kind}")
            vt.ops.append(op)
        n_fields = r.varint()
        for _ in range(n_fields):
            vt.fields.append(Field(r.varint(), r.varint(), r.varint()))
        vt.data = bytearray(r.bytes_())
        return vt

    def static_layout(self) -> list[dict] | None:
        """Fully-static per-field layout for vectorized batch ingest, or
        None when any op depends on table contents in a non-slice way.

        Returns dicts {component_id, ty, shape, offset, len, ts_offset,
        ts_div} — ts_offset is the byte offset of a little-endian i64
        timestamp inside the table body (ts_div 1000 for the nanosecond
        ext op), or None when rows carry no inline timestamp."""
        out = []
        for f in self.fields:
            info = {
                "component_id": None, "ty": None, "shape": (),
                "offset": f.offset, "len": f.len,
                "ts_offset": None, "ts_div": 1,
                "mean_window": None,
            }
            ref = f.arg
            seen: set[int] = set()
            while True:
                # vtables come off the wire: a cyclic op-DAG must not hang
                # the server's ingest loop (remote DoS)
                if ref in seen:
                    raise ValueError("vtable op chain contains a cycle")
                seen.add(ref)
                op = self.ops[ref]
                if op.kind == OP_SCHEMA:
                    ty_op = self.ops[op.ty]
                    dim_op = self.ops[op.dim]
                    if ty_op.kind != OP_DATA or dim_op.kind != OP_DATA:
                        return None  # schema from table bytes: not static
                    ty_slice, _ = self._op_slice(op.ty, b"")
                    dim_slice, _ = self._op_slice(op.dim, b"")
                    info["ty"] = PRIM_TYPES[ty_slice[0]]
                    info["shape"] = tuple(
                        np.frombuffer(dim_slice, dtype="<u8").astype(int)
                    )
                    ref = op.arg
                elif op.kind == OP_COMPONENT:
                    cid_op = self.ops[op.component_id]
                    if cid_op.kind != OP_DATA:
                        return None
                    cid_slice, _ = self._op_slice(op.component_id, b"")
                    info["component_id"] = int.from_bytes(cid_slice, "little")
                    break
                elif op.kind == OP_TIMESTAMP:
                    src = self.ops[op.source]
                    if src.kind == OP_TABLE and src.len == 8:
                        info["ts_offset"] = src.offset
                        info["ts_div"] = 1
                    ref = op.arg
                elif op.kind == OP_EXT:
                    if op.ext_id == TIMESTAMP_NS_EXT_ID:
                        src = self.ops[op.data]
                        if src.kind == OP_TABLE and src.len == 8:
                            info["ts_offset"] = src.offset
                            info["ts_div"] = 1000
                    elif op.ext_id == MEAN_EXT_ID:
                        src, _ = self._op_slice(op.data, b"")
                        if src:
                            info["mean_window"] = Reader(src).varint()
                    ref = op.arg
                elif op.kind == OP_NONE:
                    break
                else:
                    return None
            out.append(info)
        return out

    def validate_alignment(self) -> None:
        """Reject fields whose table offset is not aligned to their
        primitive size (libs/db vtable registration: zero-copy views
        require natural alignment; tests/src/lib.rs
        test_vtable_misaligned_field_rejected)."""
        for f in self.fields:
            probe = {"ty": None, "shape": (), "component_id": None,
                     "timestamp": None, "mean_window": None,
                     "data": b"", "offset": f.offset, "len": f.len}
            self._walk(f.arg, probe, b"")
            ty = probe["ty"]
            if ty is None:
                continue
            align = PRIM_NP[ty].itemsize
            if f.offset % align:
                raise ValueError(
                    f"vtable field at offset {f.offset} misaligned for "
                    f"{ty} (requires {align}-byte alignment)"
                )

    # -- realization ------------------------------------------------------

    def _op_slice(self, ref: int, table: bytes):
        op = self.ops[ref]
        if op.kind == OP_DATA:
            return bytes(self.data[op.offset : op.offset + op.len]), None
        if op.kind == OP_TABLE:
            return table[op.offset : op.offset + op.len], (op.offset, op.len)
        return None, None

    def realize_fields(self, table: bytes):
        """Yield dicts of {component_id, ty, shape, data, timestamp} per
        field (vtable.rs realize loop)."""
        for f in self.fields:
            yield self._realize_field(f, table)

    def _realize_field(self, f: Field, table: bytes) -> dict:
        out = {
            "component_id": None,
            "ty": None,
            "shape": (),
            "data": table[f.offset : f.offset + f.len] if table else b"",
            "offset": f.offset,
            "len": f.len,
            "timestamp": None,
            "mean_window": None,
        }
        self._walk(f.arg, out, table)
        return out

    def _walk(self, ref: int, out: dict, table: bytes,
              _seen: set[int] | None = None) -> None:
        seen = set() if _seen is None else _seen
        if ref in seen:  # wire-supplied DAG: guard cycles (see static_layout)
            raise ValueError("vtable op chain contains a cycle")
        seen.add(ref)
        op = self.ops[ref]
        if op.kind == OP_SCHEMA:
            ty_slice, _ = self._op_slice(op.ty, table)
            dim_slice, _ = self._op_slice(op.dim, table)
            out["ty"] = PRIM_TYPES[ty_slice[0]]
            out["shape"] = tuple(
                np.frombuffer(dim_slice, dtype="<u8").astype(int)
            )
            self._walk(op.arg, out, table, seen)
        elif op.kind == OP_COMPONENT:
            cid_slice, _ = self._op_slice(op.component_id, table)
            out["component_id"] = int.from_bytes(cid_slice, "little")
            # component op terminates the chain
        elif op.kind == OP_TIMESTAMP:
            src, _rng = self._op_slice(op.source, table)
            if src is not None and len(src) == 8 and table:
                out["timestamp"] = int.from_bytes(src, "little", signed=True)
            self._walk(op.arg, out, table, seen)
        elif op.kind == OP_EXT:
            if op.ext_id == TIMESTAMP_NS_EXT_ID:
                src, _ = self._op_slice(op.data, table)
                if src is not None and len(src) == 8 and table:
                    out["timestamp"] = (
                        int.from_bytes(src, "little", signed=True) // 1000
                    )
            elif op.ext_id == MEAN_EXT_ID:
                # windowed-mean stream stage (db/src/vtable_stream.rs:81-83)
                src, _ = self._op_slice(op.data, table)
                if src:
                    out["mean_window"] = Reader(src).varint()
            self._walk(op.arg, out, table, seen)
        elif op.kind == OP_NONE:
            pass


# -- builder (vtable.rs builder module) --------------------------------------


class VTableBuilder:
    def __init__(self):
        self.vt = VTable()

    def _push_op(self, op: Op) -> int:
        self.vt.ops.append(op)
        return len(self.vt.ops) - 1

    def data(self, payload: bytes) -> int:
        off = len(self.vt.data)
        self.vt.data += payload
        return self._push_op(Op(OP_DATA, offset=off, len=len(payload)))

    def table(self, offset: int, length: int) -> int:
        return self._push_op(Op(OP_TABLE, offset=offset, len=length))

    def none(self) -> int:
        return self._push_op(Op(OP_NONE))

    def component(self, name_or_id) -> int:
        cid = (
            component_id_of(name_or_id)
            if isinstance(name_or_id, str)
            else int(name_or_id)
        )
        data_ref = self.data(cid.to_bytes(8, "little"))
        return self._push_op(Op(OP_COMPONENT, component_id=data_ref))

    def schema(self, prim: str, shape, arg: int) -> int:
        ty_ref = self.data(bytes([PRIM_TO_IDX[prim]]))
        dims = np.asarray(list(shape), dtype="<u8").tobytes()
        dim_ref = self.data(dims)
        return self._push_op(Op(OP_SCHEMA, ty=ty_ref, dim=dim_ref, arg=arg))

    def timestamp_table(self, offset: int, arg: int) -> int:
        src = self.table(offset, 8)
        return self._push_op(Op(OP_TIMESTAMP, source=src, arg=arg))

    def ext(self, ext_id: bytes, payload: bytes, arg: int) -> int:
        data_ref = self.data(payload)
        return self._push_op(Op(OP_EXT, ext_id=ext_id, data=data_ref, arg=arg))

    def mean(self, window: int, arg: int) -> int:
        """Attach a windowed-mean stream stage (wkt MeanOp ext op)."""
        w = Writer()
        w.varint(window)
        return self.ext(MEAN_EXT_ID, w.bytes(), arg)

    def field(self, offset: int, length: int, arg: int) -> None:
        self.vt.fields.append(Field(offset, length, arg))

    def build(self) -> VTable:
        return self.vt


def build_table_vtable(fields: list[tuple[str, str, tuple, int, int]],
                       timestamp_offset: int | None = None) -> VTable:
    """Convenience: [(name, prim, shape, offset, nbytes)] -> VTable, with an
    optional shared little-endian i64 microsecond timestamp at
    ``timestamp_offset`` in the table body."""
    b = VTableBuilder()
    for name, prim, shape, offset, nbytes in fields:
        comp = b.component(name)
        if timestamp_offset is not None:
            arg = b.schema(prim, shape, comp)
            ts = b.timestamp_table(timestamp_offset, arg)
            b.field(offset, nbytes, ts)
        else:
            arg = b.schema(prim, shape, comp)
            b.field(offset, nbytes, arg)
    return b.build()
