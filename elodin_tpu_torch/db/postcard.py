"""Postcard wire-format codec (github.com/jamesmunns/postcard spec).

The reference uses Rust postcard for all impeller2 message bodies
(libs/impeller2/src/types.rs:583 Msg trait).  This is a small, allocation-
light Python implementation of the subset the protocol uses: LEB128 varints,
zigzag signed ints, fixed-width floats, byte strings, options, sequences,
maps, and enum discriminants.

A host-only copy of ``elodin_tpu/db/postcard.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import struct


class Writer:
    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def bytes(self) -> bytes:
        return bytes(self.buf)

    # -- primitives -----------------------------------------------------

    def u8(self, v: int) -> "Writer":
        self.buf.append(v & 0xFF)
        return self

    def bool(self, v: bool) -> "Writer":
        return self.u8(1 if v else 0)

    def varint(self, v: int) -> "Writer":
        """Unsigned LEB128 (u16/u32/u64/usize)."""
        if v < 0:
            raise ValueError("varint must be non-negative")
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.buf.append(b | 0x80)
            else:
                self.buf.append(b)
                return self

    def zigzag(self, v: int) -> "Writer":
        """Signed integer (i16/i32/i64) as zigzag varint."""
        return self.varint((v << 1) ^ (v >> 63) if v < 0 else v << 1)

    def i8(self, v: int) -> "Writer":
        self.buf.append(v & 0xFF)
        return self

    def f32(self, v: float) -> "Writer":
        self.buf += struct.pack("<f", v)
        return self

    def f64(self, v: float) -> "Writer":
        self.buf += struct.pack("<d", v)
        return self

    def raw(self, data: bytes) -> "Writer":
        self.buf += data
        return self

    # -- composites -----------------------------------------------------

    def bytes_(self, data: bytes) -> "Writer":
        self.varint(len(data))
        self.buf += data
        return self

    def string(self, s: str) -> "Writer":
        return self.bytes_(s.encode())

    def option(self, v, write_fn) -> "Writer":
        if v is None:
            return self.u8(0)
        self.u8(1)
        write_fn(self, v)
        return self

    def seq(self, items, write_fn) -> "Writer":
        self.varint(len(items))
        for it in items:
            write_fn(self, it)
        return self

    def map(self, d: dict, write_k, write_v) -> "Writer":
        self.varint(len(d))
        for k, v in d.items():
            write_k(self, k)
            write_v(self, v)
        return self

    def discriminant(self, idx: int) -> "Writer":
        return self.varint(idx)


class Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def bool(self) -> bool:
        return self.u8() != 0

    def varint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def i8(self) -> int:
        v = self.u8()
        return v - 256 if v >= 128 else v

    def f32(self) -> float:
        v = struct.unpack_from("<f", self.data, self.pos)[0]
        self.pos += 4
        return v

    def f64(self) -> float:
        v = struct.unpack_from("<d", self.data, self.pos)[0]
        self.pos += 8
        return v

    def raw(self, n: int) -> bytes:
        if n > len(self.data) - self.pos:
            # a truncated/corrupt frame must fail the decode, not hand
            # back a silently-shortened payload (u8/f32 paths already
            # raise on overrun — raw/bytes_/string were the exception)
            raise ValueError(
                f"postcard: {n} bytes declared, "
                f"{len(self.data) - self.pos} remain"
            )
        v = self.data[self.pos : self.pos + n]
        self.pos += n
        return bytes(v)

    def bytes_(self) -> bytes:
        return self.raw(self.varint())

    def string(self) -> str:
        return self.bytes_().decode()

    def option(self, read_fn):
        if self.u8() == 0:
            return None
        return read_fn(self)

    def seq(self, read_fn) -> list:
        return [read_fn(self) for _ in range(self.varint())]

    def map(self, read_k, read_v) -> dict:
        return {read_k(self): read_v(self) for _ in range(self.varint())}

    def discriminant(self) -> int:
        return self.varint()


def fnv1a_32(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def fnv1a_16_xor(s: str) -> int:
    """const_fnv1a_hash::fnv1a_hash_str_16_xor — 32-bit hash XOR-folded."""
    h = fnv1a_32(s.encode())
    return ((h >> 16) ^ (h & 0xFFFF)) & 0xFFFF


def auto_msg_id(type_name: str) -> bytes:
    """Derived Msg::ID (libs/impeller2/src/types.rs:585-588)."""
    return fnv1a_16_xor(type_name).to_bytes(2, "little")


def msg_id(name: str) -> bytes:
    """impeller2::types::msg_id (types.rs:590-597): avoids the reserved
    [224, *] range."""
    b = auto_msg_id(name)
    if b[0] == 224:
        return bytes([223, b[1]])
    return b
