"""ctypes binding to the native storage/codec library (native/src/impeller.c).

Builds libimpeller.so on first use with the system C compiler, into the
port's git-ignored ``build/native/`` beside the checkout (under a temporary
name, then renamed, so processes that build at once never load a half-written
library); every consumer falls back to pure Python when no toolchain is
available, so the framework stays importable everywhere.

A host-only copy of ``elodin_tpu/native.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parent.parent
_SRC = _REPO_ROOT / "native" / "src" / "impeller.c"
_SO = _REPO_ROOT / "build" / "native" / "libimpeller.so"

_lib = None
_tried = False


def _build_and_load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not _SRC.is_file():
        return None
    try:
        if (
            not _SO.is_file()
            or _SO.stat().st_mtime < _SRC.stat().st_mtime
        ):
            _SO.parent.mkdir(parents=True, exist_ok=True)
            tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(
                    ["cc", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _SO)
            finally:
                tmp.unlink(missing_ok=True)
        lib = ctypes.CDLL(str(_SO))
    except Exception:
        return None

    lib.impeller_component_id.restype = ctypes.c_uint64
    lib.impeller_component_id.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.store_open.restype = ctypes.c_void_p
    lib.store_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
    ]
    lib.store_append.restype = ctypes.c_int
    lib.store_append.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.store_len.restype = ctypes.c_uint64
    lib.store_len.argtypes = [ctypes.c_void_p]
    lib.store_timestamps.restype = ctypes.c_void_p
    lib.store_timestamps.argtypes = [ctypes.c_void_p]
    lib.store_data.restype = ctypes.c_void_p
    lib.store_data.argtypes = [ctypes.c_void_p]
    lib.store_flush.restype = ctypes.c_int
    lib.store_flush.argtypes = [ctypes.c_void_p]
    lib.store_close.restype = None
    lib.store_close.argtypes = [ctypes.c_void_p]
    lib.store_lower_bound.restype = ctypes.c_uint64
    lib.store_lower_bound.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    _lib = lib
    return lib


def available() -> bool:
    return _build_and_load() is not None


def component_id(name: str) -> int:
    lib = _build_and_load()
    if lib is None:
        from .db.vtable import component_id_of

        return component_id_of(name)
    raw = name.encode()
    return int(lib.impeller_component_id(raw, len(raw)))


class NativeStore:
    """mmap-backed append-only (timestamps, rows) column pair."""

    def __init__(self, ts_path: str, data_path: str, row_nbytes: int,
                 initial_cap: int = 1 << 20):
        lib = _build_and_load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.row_nbytes = int(row_nbytes)
        self._ptr = lib.store_open(
            str(ts_path).encode(), str(data_path).encode(),
            self.row_nbytes, initial_cap,
        )
        if not self._ptr:
            raise OSError(f"store_open failed for {ts_path}")

    def append(self, timestamps: np.ndarray, rows: np.ndarray) -> None:
        ts = np.ascontiguousarray(timestamps, dtype="<i8")
        rows = np.ascontiguousarray(rows)
        n = len(ts)
        assert rows.nbytes == n * self.row_nbytes, (
            f"{rows.nbytes} != {n} * {self.row_nbytes}"
        )
        rc = self._lib.store_append(
            self._ptr,
            ts.ctypes.data_as(ctypes.c_void_p),
            rows.ctypes.data_as(ctypes.c_void_p),
            n,
        )
        if rc != 0:
            raise OSError("store_append failed")

    def __len__(self) -> int:
        return int(self._lib.store_len(self._ptr))

    def timestamps(self, copy: bool = True) -> np.ndarray:
        """Timestamp column.  Returns an owned copy by default; pass
        ``copy=False`` for a zero-copy view into the C mmap — such a view
        DANGLES after the next append (mremap can move the mapping) or
        close (munmap): reading it then segfaults or returns garbage with
        no Python-level error."""
        n = len(self)
        ptr = self._lib.store_timestamps(self._ptr)
        if n == 0 or not ptr:
            return np.zeros(0, dtype="<i8")
        buf = (ctypes.c_int64 * n).from_address(ptr)
        view = np.frombuffer(buf, dtype="<i8")
        return view.copy() if copy else view

    def rows(self, dtype, elem_count: int, copy: bool = True) -> np.ndarray:
        """Row data; same copy/view semantics as :meth:`timestamps`."""
        n = len(self)
        ptr = self._lib.store_data(self._ptr)
        if n == 0 or not ptr:
            return np.zeros((0, elem_count), dtype=dtype)
        nbytes = n * self.row_nbytes
        buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
        view = np.frombuffer(buf, dtype=dtype).reshape(n, elem_count)
        return view.copy() if copy else view

    def lower_bound(self, key: int) -> int:
        return int(self._lib.store_lower_bound(self._ptr, int(key)))

    def flush(self) -> None:
        self._lib.store_flush(self._ptr)

    def close(self) -> None:
        if self._ptr:
            self._lib.store_close(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
