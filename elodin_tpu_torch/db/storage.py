"""Time-series component store (parity: libs/db — DB/State, per-component
append-only series, msg logs).

The reference preallocates 8 GB sparse files per component and mmaps them
(libs/db/src/lib.rs:240+).  This store keeps a growable numpy buffer per
component with optional directory persistence in a simple layout:

    <db_path>/
      components/<name>/{schema.json, timestamps.bin, data.bin}
      msgs/<id_hex>/{meta.json, log.bin}
      assets/…

Writes append to memory and (when persisted) to the files; reads slice the
in-memory arrays.  Enough for sim serving, export, and replay; a C++ mmap
engine can replace the hot path behind the same interface.

A host-only copy of ``elodin_tpu/db/storage.py``:
the port imports nothing of the JAX package.  ``Database.close`` (the
port's own) closes every store and message log at once.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import numpy as np

from .vtable import PRIM_NP, component_id_of


def now_timestamp_us() -> int:
    return time.time_ns() // 1000


class ComponentStore:
    def __init__(self, component_id: int, prim: str, shape: tuple,
                 name: str | None = None, path: Path | None = None):
        self.component_id = component_id
        self.prim = prim
        self.shape = tuple(int(s) for s in shape)
        self.name = name
        self.metadata: dict[str, str] = {}
        self.dtype = PRIM_NP[prim]
        self.elem_count = int(np.prod(self.shape)) if self.shape else 1
        self.row_nbytes = self.elem_count * self.dtype.itemsize
        cap = 1024
        self.timestamps = np.zeros(cap, dtype="<i8")
        self.values = np.zeros((cap, self.elem_count), dtype=self.dtype)
        self.len = 0
        self.path = path
        self._ts_file = None
        self._data_file = None
        self._native = None
        if path is not None:
            path.mkdir(parents=True, exist_ok=True)
            # don't clobber an existing schema (load() restores name/metadata
            # after construction; rewriting here would wipe them on reopen)
            if not (path / "schema.json").is_file():
                self._write_schema()
            # prefer the native mmap appender (sparse prealloc + zero-copy,
            # parity with the reference's storage engine); fall back to
            # buffered file appends
            try:
                from ..native import NativeStore, available

                if available():
                    self._native = NativeStore(
                        path / "timestamps.bin", path / "data.bin",
                        self.row_nbytes,
                    )
                    if len(self._native):
                        self._load_from_native()
            except Exception:
                self._native = None
            if self._native is None:
                self._ts_file = open(path / "timestamps.bin", "ab")
                self._data_file = open(path / "data.bin", "ab")

    def _write_schema(self) -> None:
        if self.path is None:
            return
        (self.path / "schema.json").write_text(
            json.dumps(
                {
                    "component_id": self.component_id,
                    "name": self.name,
                    "prim": self.prim,
                    "shape": list(self.shape),
                    "metadata": self.metadata,
                }
            )
        )

    def set_metadata(self, name: str | None = None,
                     metadata: dict | None = None) -> None:
        """Update the display name / metadata and persist them, so names
        survive a reopen (the reference keeps names in its metadata msg log,
        libs/db/src/lib.rs SetComponentMetadata handling)."""
        changed = False
        if name and name != self.name:
            self.name = name
            changed = True
        if metadata:
            before = dict(self.metadata)
            self.metadata.update(metadata)
            changed = changed or self.metadata != before
        if changed:
            self._write_schema()

    def _load_from_native(self) -> None:
        n = len(self._native)
        ts = self._native.timestamps()
        vals = self._native.rows(self.dtype, self.elem_count)
        self.timestamps = ts
        self.values = vals
        self.len = n

    def _grow(self, need: int) -> None:
        cap = len(self.timestamps)
        if self.len + need <= cap:
            return
        new_cap = max(cap * 2, self.len + need)
        self.timestamps = np.resize(self.timestamps, new_cap)
        self.values = np.resize(self.values, (new_cap, self.elem_count))

    def append(self, timestamp: int, data: bytes | np.ndarray) -> None:
        if getattr(self, "_closed", False):
            raise ValueError(f"store {self.name!r} is closed")
        arr = (
            np.frombuffer(data, dtype=self.dtype, count=self.elem_count)
            if isinstance(data, (bytes, bytearray, memoryview))
            else np.asarray(data, dtype=self.dtype).reshape(-1)
        )
        self._grow(1)
        self.timestamps[self.len] = timestamp
        self.values[self.len] = arr
        self.len += 1
        if self._native is not None:
            self._native.append(
                np.asarray([timestamp], dtype="<i8"), arr[None]
            )
        elif self._ts_file is not None:
            self._ts_file.write(np.int64(timestamp).tobytes())
            self._data_file.write(arr.tobytes())

    def append_batch(self, timestamps: np.ndarray, values: np.ndarray) -> None:
        if getattr(self, "_closed", False):
            raise ValueError(f"store {self.name!r} is closed")
        n = len(timestamps)
        self._grow(n)
        self.timestamps[self.len : self.len + n] = timestamps
        self.values[self.len : self.len + n] = values.reshape(n, -1)
        self.len += n
        if self._native is not None:
            self._native.append(
                np.asarray(timestamps, dtype="<i8"),
                np.ascontiguousarray(values, dtype=self.dtype),
            )
        elif self._ts_file is not None:
            self._ts_file.write(np.asarray(timestamps, dtype="<i8").tobytes())
            self._data_file.write(
                np.ascontiguousarray(values, dtype=self.dtype).tobytes()
            )

    def range(self, start: int, stop: int, limit: int | None = None):
        """Rows with start <= t < stop.  ``limit`` DOWNSAMPLES evenly across
        the window, always including the newest in-window row (limit=1 is
        therefore a cheap "latest at-or-before stop").  Contrast
        MsgLog.range, whose limit truncates to the first N entries."""
        ts = self.timestamps[: self.len]
        lo = int(np.searchsorted(ts, start, side="left"))
        hi = int(np.searchsorted(ts, stop, side="left"))
        if limit is not None and hi - lo > limit:
            if limit == 1:
                idx = np.array([hi - 1])
            else:
                idx = np.linspace(lo, hi - 1, limit).astype(int)
            return ts[idx], self.values[idx]
        return ts[lo:hi], self.values[lo:hi]

    def latest(self):
        if self.len == 0:
            return None
        return int(self.timestamps[self.len - 1]), self.values[self.len - 1]

    def flush(self) -> None:
        if self._native is not None:
            self._native.flush()
        elif self._ts_file is not None:
            self._ts_file.flush()
            self._data_file.flush()

    def close(self) -> None:
        """Write out and release the files; the rows stay readable in
        memory, and an append raises.  A native store left to the garbage
        collector instead closes whenever it is collected, cutting the files
        to its own length, which may be behind a later handle's."""
        if self._native is not None:
            self._native.close()
        elif self._ts_file is not None:
            self._ts_file.close()
            self._data_file.close()
        self._native = self._ts_file = self._data_file = None
        self._closed = True

    @staticmethod
    def load(path: Path) -> "ComponentStore":
        schema = json.loads((path / "schema.json").read_text())
        store = ComponentStore(
            schema["component_id"], schema["prim"], tuple(schema["shape"]),
            schema.get("name"), path,
        )
        store.metadata.update(schema.get("metadata") or {})
        if store._native is not None:
            return store  # loaded via the mmap header
        raw_ts = np.fromfile(path / "timestamps.bin", dtype="<i8")
        data = np.fromfile(path / "data.bin", dtype=store.dtype)
        # torn-tail tolerance (crash between the ts and data appends):
        # keep only fully-written rows, like MsgLog._load — a partial final
        # row must not make the whole database unopenable
        n = min(len(raw_ts), len(data) // store.elem_count)
        if n * 8 < len(raw_ts) * 8 or n * store.row_nbytes < data.nbytes:
            # repair on disk too, or subsequent appends would land after
            # the partial row and misalign every later record
            if store._ts_file is not None:
                store._ts_file.truncate(n * 8)
                store._data_file.truncate(n * store.row_nbytes)
        store.timestamps = raw_ts[:n].copy()
        store.values = data[: n * store.elem_count].reshape(
            n, store.elem_count
        ).copy()
        store.len = n
        return store


class MsgLog:
    def __init__(self, msg_id: bytes, path: Path | None = None):
        self.msg_id = msg_id
        self.entries: list[tuple[int, bytes]] = []
        self.metadata: dict | None = None
        self.path = path
        self._file = None
        if path is not None:
            path.mkdir(parents=True, exist_ok=True)
            log_path = path / "log.bin"
            if log_path.is_file():
                self._load(log_path)
            self._file = open(log_path, "ab")
            meta_path = path / "meta.json"
            if meta_path.is_file():
                try:
                    from . import msgs as M

                    d = json.loads(meta_path.read_text())
                    self.metadata = M.MsgMetadata(
                        d.get("msg_id", 0), d.get("name", ""),
                        d.get("metadata") or {},
                    )
                except Exception:
                    pass

    def set_metadata(self, metadata) -> None:
        """Assign (and persist) this log's MsgMetadata so names survive a
        reopen (reference keeps msg metadata in its metadata log,
        libs/db/src/lib.rs SetMsgMetadata handling)."""
        self.metadata = metadata
        if self.path is not None and metadata is not None:
            (self.path / "meta.json").write_text(
                json.dumps(
                    {
                        "msg_id": getattr(metadata, "msg_id", 0),
                        "name": getattr(metadata, "name", ""),
                        "metadata": getattr(metadata, "metadata", {}) or {},
                    }
                )
            )

    def _load(self, log_path: Path) -> None:
        """Replay persisted entries (i64 ts + u32 len + payload records)."""
        raw = log_path.read_bytes()
        pos = 0
        while pos + 12 <= len(raw):
            ts = int.from_bytes(raw[pos : pos + 8], "little", signed=True)
            ln = int.from_bytes(raw[pos + 8 : pos + 12], "little")
            if pos + 12 + ln > len(raw):
                break  # torn tail write; drop it
            self.entries.append((ts, bytes(raw[pos + 12 : pos + 12 + ln])))
            pos += 12 + ln

    def append(self, timestamp: int, data: bytes) -> None:
        self.entries.append((timestamp, bytes(data)))
        if self._file is not None:
            self._file.write(
                np.int64(timestamp).tobytes()
                + np.uint32(len(data)).tobytes()
                + data
            )

    def range(self, start: int, stop: int, limit: int | None = None):
        out = [e for e in self.entries if start <= e[0] < stop]
        if limit is not None:
            out = out[:limit]
        return out

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class Database:
    """In-process DB state shared by server connections and embedded sims."""

    def __init__(self, path: str | None = None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.mkdir(parents=True, exist_ok=True)
        from .assets import AssetStore

        self.assets = AssetStore(self.path)
        self.components: dict[int, ComponentStore] = {}
        self.msg_logs: dict[bytes, MsgLog] = {}
        self.vtables: dict[bytes, object] = {}
        self.lock = threading.RLock()
        self.listeners: list = []  # callables(component_ids, timestamp)
        self.recording = True
        # asset key of the active schematic (reference: db_config
        # schematic.active, libs/db/src/lib.rs set_active_schematic);
        # persisted so exports after a reopen still find the scene
        self.active_schematic: str | None = None
        if self.path and (self.path / "config.json").is_file():
            try:
                cfg = json.loads((self.path / "config.json").read_text())
                if isinstance(cfg, dict):
                    self.active_schematic = cfg.get("active_schematic")
            except (OSError, ValueError):
                pass
        if self.path and (self.path / "components").is_dir():
            for comp_dir in (self.path / "components").iterdir():
                if (comp_dir / "schema.json").is_file():
                    store = ComponentStore.load(comp_dir)
                    self.components[store.component_id] = store
        if self.path and (self.path / "msgs").is_dir():
            for msg_dir in (self.path / "msgs").iterdir():
                if (msg_dir / "log.bin").is_file() and len(msg_dir.name) == 4:
                    mid = bytes.fromhex(msg_dir.name)
                    self.msg_logs[mid] = MsgLog(mid, msg_dir)

    # -- components -----------------------------------------------------

    def get_or_create(self, component_id: int, prim: str, shape,
                      name: str | None = None) -> ComponentStore:
        with self.lock:
            store = self.components.get(component_id)
            if store is None:
                comp_path = None
                if self.path:
                    dir_name = name or f"{component_id:016x}"
                    comp_path = self.path / "components" / dir_name
                store = ComponentStore(component_id, prim, shape, name, comp_path)
                self.components[component_id] = store
            elif name and not store.name:
                store.set_metadata(name=name)
            return store

    def by_name(self, name: str) -> ComponentStore | None:
        return self.components.get(component_id_of(name))

    def msg_log(self, msg_id: bytes) -> MsgLog:
        with self.lock:
            log = self.msg_logs.get(msg_id)
            if log is None:
                p = self.path / "msgs" / msg_id.hex() if self.path else None
                log = MsgLog(msg_id, p)
                self.msg_logs[msg_id] = log
            return log

    def set_active_schematic(self, key: str) -> None:
        """Mark an asset key as the active schematic (reference
        DB::set_active_schematic)."""
        self.active_schematic = key
        if self.path:
            (self.path / "config.json").write_text(
                json.dumps({"active_schematic": key})
            )

    def notify(self, component_ids, timestamp: int) -> None:
        for fn in list(self.listeners):
            try:
                fn(component_ids, timestamp)
            except Exception:
                pass

    def earliest_timestamp(self) -> int:
        ts = [
            int(s.timestamps[0]) for s in self.components.values() if s.len > 0
        ]
        return min(ts) if ts else 0

    def flush(self) -> None:
        for s in self.components.values():
            s.flush()
        for m in self.msg_logs.values():
            m.flush()

    def close(self) -> None:
        """Close every store and message log now (``ComponentStore.close``),
        so that a later handle on the same directory, in this process or
        another, never meets this one's close."""
        for s in self.components.values():
            s.close()
        for m in self.msg_logs.values():
            m.close()
