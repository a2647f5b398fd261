"""Transport framing: COBS for serial links, a shared-memory SPSC ring for
local IPC.

Parity targets: libs/impeller2/frame (COBS-framed packets for UART links to
flight hardware) and libs/impeller2/bbq + libs/bbqueue (lock-free
single-producer single-consumer ring used between the editor and decoders).

A host-only copy of ``elodin_tpu/db/framing.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import mmap
import os
import struct


# -- COBS (consistent overhead byte stuffing) -------------------------------


def cobs_encode(data: bytes) -> bytes:
    """Encode so the output contains no 0x00; append the 0x00 delimiter."""
    out = bytearray()
    idx = 0
    n = len(data)
    while True:
        # find next zero within the 254-byte window
        block_end = idx
        while block_end < n and data[block_end] != 0 and block_end - idx < 254:
            block_end += 1
        code = block_end - idx + 1
        out.append(code)
        out += data[idx:block_end]
        if block_end >= n:
            break
        # consume the delimiter zero ONLY if this group ended because of
        # it — a window-capped 0xFF group implies no zero (the decoder
        # inserts none after code 0xFF), so a zero right after a 254-byte
        # run must start its own (empty) group or it is silently dropped
        if code < 0xFF and data[block_end] == 0:
            block_end += 1
        idx = block_end
    out.append(0)
    return bytes(out)


def cobs_decode(data: bytes) -> bytes:
    """Decode a COBS frame (with or without the trailing delimiter)."""
    if data and data[-1] == 0:
        data = data[:-1]
    out = bytearray()
    idx = 0
    n = len(data)
    while idx < n:
        code = data[idx]
        if code == 0:
            raise ValueError("unexpected zero inside COBS frame")
        block = data[idx + 1 : idx + code]
        if len(block) != code - 1:
            raise ValueError("truncated COBS frame")
        out += block
        idx += code
        if code < 0xFF and idx < n:
            out.append(0)
    return bytes(out)


class CobsStream:
    """Incremental decoder: feed bytes, yield complete frames."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, chunk: bytes) -> list[bytes]:
        """Buffer ``chunk`` EAGERLY and return the complete frames.

        Returns a list rather than a generator: a generator body would
        only run on iteration, so ``stream.feed(header)`` without
        iterating silently discarded the chunk."""
        self._buf += chunk
        out = []
        while True:
            try:
                end = self._buf.index(0)
            except ValueError:
                return out
            frame = bytes(self._buf[: end + 1])
            del self._buf[: end + 1]
            if end > 0:
                out.append(cobs_decode(frame))


# -- shared-memory SPSC ring -------------------------------------------------

_RING_HEADER = 64  # [0:8) write_pos, [8:16) read_pos, [16:24) capacity


class ShmRing:
    """Single-producer single-consumer byte-frame ring over a shared mmap
    (bbqueue's contiguous-frame model: each frame is u32 length + payload,
    wrapping via a skip marker)."""

    SKIP = 0xFFFFFFFF

    def __init__(self, path: str, capacity: int = 1 << 20, create: bool = True):
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        self.fd = os.open(path, flags, 0o644)
        if create:
            size = _RING_HEADER + capacity
            if os.fstat(self.fd).st_size < size:
                os.ftruncate(self.fd, size)
            self.map = mmap.mmap(self.fd, size)
            if self._load(16) == 0:
                self._store(16, capacity)
        else:
            # ATTACH side: the creator's stored capacity governs, and the
            # map must cover the whole file — mapping with the (default)
            # constructor capacity would read/write out of bounds when it
            # is smaller than the creator's
            fsize = os.fstat(self.fd).st_size
            if fsize < _RING_HEADER:
                os.close(self.fd)
                raise ValueError(f"{path}: not an initialized ring")
            self.map = mmap.mmap(self.fd, fsize)
        self.capacity = self._load(16)
        if self.capacity <= 0 or _RING_HEADER + self.capacity > len(self.map):
            os.close(self.fd)
            raise ValueError(f"{path}: corrupt ring header")

    def _load(self, off: int) -> int:
        return struct.unpack_from("<Q", self.map, off)[0]

    def _store(self, off: int, value: int) -> None:
        struct.pack_into("<Q", self.map, off, value)

    @property
    def write_pos(self) -> int:
        return self._load(0)

    @property
    def read_pos(self) -> int:
        return self._load(8)

    def _free(self) -> int:
        used = (self.write_pos - self.read_pos) % self.capacity
        return self.capacity - used - 1

    def push(self, frame: bytes) -> bool:
        need = 4 + len(frame)
        if need + 4 > self._free():
            return False
        w = self.write_pos
        # wrap with a skip marker if the frame would straddle the end
        if w + need > self.capacity:
            if self.capacity - w >= 4:
                struct.pack_into(
                    "<I", self.map, _RING_HEADER + w, self.SKIP
                )
            w = 0
            if need + 4 > (self.read_pos - 1) % self.capacity:
                return False
        struct.pack_into("<I", self.map, _RING_HEADER + w, len(frame))
        self.map[_RING_HEADER + w + 4 : _RING_HEADER + w + 4 + len(frame)] = frame
        self._store(0, (w + need) % self.capacity)
        return True

    def pop(self) -> bytes | None:
        r = self.read_pos
        if r == self.write_pos:
            return None
        if self.capacity - r < 4:
            r = 0
        else:
            (length,) = struct.unpack_from("<I", self.map, _RING_HEADER + r)
            if length == self.SKIP:
                r = 0
        if r == self.write_pos:
            return None
        (length,) = struct.unpack_from("<I", self.map, _RING_HEADER + r)
        frame = bytes(
            self.map[_RING_HEADER + r + 4 : _RING_HEADER + r + 4 + length]
        )
        self._store(8, (r + 4 + length) % self.capacity)
        return frame

    def close(self) -> None:
        self.map.close()
        os.close(self.fd)
