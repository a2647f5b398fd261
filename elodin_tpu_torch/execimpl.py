"""World execution on one torch device (counterpart of
``elodin_tpu/execimpl.py``).

The JAX package compiles ``n`` telemetry batches of ``stride`` ticks into
one program.  Here the same ``build_step`` runs eagerly, tick by tick, in a
Python loop; the tick count stays a runtime value.  At each telemetry
boundary the state is copied to the host and appended to ``History``
synchronously.  The history is the checkpoint: ``state_at`` reads a
recorded row, ``restore`` rewinds the device state to it and cuts the
history after it; ``save_checkpoint`` / ``load_checkpoint`` write and read
the live state as an npz file.  Not ported yet: the telemetry pump,
lockstep sessions and ``restore_from_db`` (it needs the telemetry
database).
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import numpy as np
import torch

from . import _config
from .dataframe import DataFrame
from .interop import columns_from_numpy, columns_to_numpy
from .system import build_step
from .world import WorldMeta


class Profiler:
    """Rolling per-phase timings -> real_time_factor."""

    def __init__(self, sim_time_step: float):
        self.sim_time_step = sim_time_step
        self.build_s = 0.0
        self.kernel_s = 0.0
        self.copy_s = 0.0
        self.ticks = 0

    def profile(self) -> dict[str, float]:
        per_tick = self.kernel_s / self.ticks if self.ticks else 0.0
        copy_per_tick = self.copy_s / self.ticks if self.ticks else 0.0
        rtf = self.sim_time_step / per_tick if per_tick > 0 else 0.0
        return {
            "build": self.build_s * 1e3,
            "kernel": per_tick * 1e3,
            "copy": copy_per_tick * 1e3,
            "tick": per_tick * 1e3,
            "real_time_factor": rtf,
        }


class History:
    """Per-tick telemetry snapshots kept on host (numpy).

    RAM is bounded: past ``ELODIN_HISTORY_MAX_BYTES`` (default 512 MiB) the
    oldest chunks spill to ``.npy`` files and are memory-mapped back on
    read."""

    def __init__(self, meta: WorldMeta, spool_dir: str | None = None,
                 max_bytes: int | None = None):
        self.meta = meta
        self.times: list[float] = []  # seconds since start
        self.chunks: dict[str, list[np.ndarray]] = {c: [] for c in meta.components}
        self.start_timestamp = datetime.datetime.now(datetime.timezone.utc)
        self.max_bytes = (
            max_bytes
            if max_bytes is not None
            else int(os.environ.get("ELODIN_HISTORY_MAX_BYTES", str(512 << 20)))
        )
        self._spool_dir = spool_dir
        self._live_bytes = 0
        self._spills: dict[str, list[np.ndarray]] = {c: [] for c in meta.components}
        self._spill_count = 0

    def append_state(self, t: float, cols: dict[str, np.ndarray]) -> None:
        self.times.append(t)
        for name, value in cols.items():
            self._append_chunk(name, np.asarray(value)[None])

    def _append_chunk(self, name: str, value: np.ndarray) -> None:
        self.chunks[name].append(value)
        self._live_bytes += value.nbytes
        if self._live_bytes > self.max_bytes:
            self._spill()

    def _spill(self) -> None:
        if self._spool_dir is None:
            self._spool_dir = tempfile.mkdtemp(prefix="elodin-history-")
        os.makedirs(self._spool_dir, exist_ok=True)
        idx = self._spill_count
        self._spill_count += 1
        for name, chunk_list in self.chunks.items():
            if not chunk_list:
                continue
            arr = np.concatenate(chunk_list, axis=0)
            path = os.path.join(
                self._spool_dir, f"{idx:06d}_{name.replace('/', '_')}.npy"
            )
            np.save(path, arr)
            self._spills[name].append(np.load(path, mmap_mode="r"))
            chunk_list.clear()
        self._live_bytes = 0

    def series(self, name: str) -> np.ndarray:
        """(n_rows, n_entities, *shape) array for one component."""
        parts = list(self._spills[name]) + self.chunks[name]
        return np.concatenate(parts, axis=0)

    def truncate(self, keep_rows: int) -> None:
        """Drop every row past the first ``keep_rows`` (the restore path),
        from the spilled chunks as from the live ones: a spilled chunk
        that straddles the cut is kept as a view of its first rows."""
        self.times = self.times[:keep_rows]
        for name in self.chunks:
            rows = 0
            for parts in (self._spills[name], self.chunks[name]):
                kept = []
                for part in parts:
                    if rows < keep_rows:
                        kept.append(part[:keep_rows - rows])
                    rows += len(part)
                parts[:] = kept
        self._live_bytes = sum(c.nbytes for chunks in self.chunks.values() for c in chunks)

    def column_names(self) -> list[str]:
        """Every 'entity.component' of a named entity."""
        out = []
        id_to_name = {eid: m.name for eid, m in self.meta.entity_metadata.items()}
        for comp, ids in self.meta.comp_entities.items():
            for eid in ids:
                ename = id_to_name.get(eid)
                if ename is not None:
                    out.append(f"{ename}.{comp}")
        return out

    def resolve(self, qualified: str) -> tuple[str, int]:
        """'entity.component' -> (component name, row index)."""
        entity_name, _, comp = qualified.partition(".")
        if not comp:
            raise KeyError(f"expected 'entity.component', got {qualified!r}")
        eid = self.meta.entity_names.get(entity_name)
        if eid is None:
            raise KeyError(f"unknown entity {entity_name!r}")
        index = self.meta.comp_index.get(comp)
        if index is None or eid not in index:
            raise KeyError(f"entity {entity_name!r} has no component {comp!r}")
        return comp, index[eid]


def _call_canceled(is_canceled) -> bool:
    try:
        return bool(is_canceled())
    except TypeError:
        return bool(is_canceled)


class Exec:
    """World executor on one device.

    ``cols`` are numpy columns (``WorldBuilder.snapshot()``); they are
    checked against ``meta`` and moved to ``device`` once."""

    def __init__(
        self,
        meta: WorldMeta,
        cols: dict[str, np.ndarray],
        system,
        sim_time_step: float,
        max_ticks: int | None = None,
        telemetry_rate: float | None = None,
        record_history: bool = True,
        device: str | torch.device = "cuda",
    ):
        self.meta = meta
        self.sim_time_step = sim_time_step
        self.max_ticks = max_ticks
        self.profiler = Profiler(sim_time_step)
        self.record_history = record_history
        self.device = torch.device(device)
        # ticks between telemetry commits (>=1)
        if telemetry_rate is not None and telemetry_rate > 0:
            self.ticks_per_telemetry = max(
                1, round((1.0 / sim_time_step) / telemetry_rate)
            )
        else:
            self.ticks_per_telemetry = 1

        self._step = build_step(meta, system)

        t0 = time.perf_counter()
        self.cols = columns_from_numpy(cols, meta, self.device)
        self.profiler.build_s = time.perf_counter() - t0

        self._history = History(meta)
        self._tick = 0
        if self.record_history:
            self._history.append_state(0.0, columns_to_numpy(self.cols, meta))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- running -------------------------------------------------------------

    def run(self, ticks: int = 1, show_progress: bool = True, is_canceled=None):
        """``ticks`` ticks, committed to the history every telemetry
        stride.  ``show_progress`` is accepted as the JAX package accepts
        it, and shows nothing."""
        remaining = int(ticks)
        if self.max_ticks is not None:
            remaining = min(remaining, max(0, self.max_ticks - self._tick))
        stride = self.ticks_per_telemetry
        while remaining > 0:
            if remaining >= stride:
                n = remaining // stride
                self._run_batch(n, stride)
                remaining -= n * stride
            else:
                # an incomplete trailing batch still commits
                self._run_batch(1, remaining)
                remaining = 0
            if is_canceled is not None and _call_canceled(is_canceled):
                return

    def _run_batch(self, n: int, stride: int) -> None:
        """``n`` telemetry batches of ``stride`` ticks, each followed by a
        synchronous host copy into the history when recording."""
        cols = self.cols
        for _ in range(n):
            t0 = time.perf_counter()
            for _ in range(stride):
                cols = self._step(cols)
            self._sync()
            self.profiler.kernel_s += time.perf_counter() - t0
            self.cols = cols
            self._tick += stride
            self.profiler.ticks += stride
            if self.record_history:
                t0 = time.perf_counter()
                self._history.append_state(
                    self._tick * self.sim_time_step,
                    columns_to_numpy(cols, self.meta))
                self.profiler.copy_s += time.perf_counter() - t0

    # -- host-side control -------------------------------------------------

    def write_component(self, qualified: str, value) -> None:
        """Write one entity's value of a component ('entity.component'); the
        next tick reads it.  The column is rebound, never written in
        place."""
        comp, row = self._history.resolve(qualified)
        col = self.cols[comp]
        v = np.asarray(value)
        if v.dtype == np.uint64:
            v = v.astype(np.int64)
        col = col.clone()
        col[row] = torch.as_tensor(v, device=col.device).to(col.dtype).reshape(col.shape[1:])
        self.cols[comp] = col

    def read_component(self, qualified: str) -> np.ndarray:
        """One entity's current value of a component, as numpy (at least
        1-d)."""
        comp, row = self._history.resolve(qualified)
        value = columns_to_numpy({comp: self.cols[comp][row:row + 1]}, self.meta)[comp]
        return np.atleast_1d(value[0])

    # -- checkpoint and resume -------------------------------------------

    def state_at(self, tick: int) -> dict[str, np.ndarray]:
        """Every component's recorded value at history row ``tick`` (0 is
        the initial state), as numpy."""
        if not self.record_history:
            raise RuntimeError("history recording is disabled")
        out = {}
        for name in self.meta.components:
            series = self._history.series(name)
            if tick >= len(series):
                raise IndexError(f"tick {tick} not recorded")
            out[name] = series[tick]
        return out

    def restore(self, tick: int) -> None:
        """Rewind the device state to history row ``tick`` and cut the
        history after it.  The tick counter comes from the row's recorded
        time, not from the tick column."""
        self.cols = columns_from_numpy(self.state_at(tick), self.meta, self.device)
        restored_time = self._history.times[tick]
        self._history.truncate(tick + 1)
        self._tick = int(round(restored_time / self.sim_time_step))

    def save_checkpoint(self, path) -> None:
        """Write the live state as an npz file, one array per component at
        its host dtype (u64 and u32 columns as unsigned)."""
        np.savez(path, **columns_to_numpy(self.cols, self.meta))

    def load_checkpoint(self, path) -> None:
        """Read the live state back from ``save_checkpoint``'s file (or
        the JAX package's), each array cast to its column's dtype."""
        with np.load(path) as data:
            cols = {k: np.asarray(data[k]).astype(
                        _config.numpy_column_dtype(k, self.meta.components[k]), copy=False)
                    for k in self.meta.components}
        self.cols = columns_from_numpy(cols, self.meta, self.device)

    # -- outputs ---------------------------------------------------------

    def profile(self) -> dict[str, float]:
        return self.profiler.profile()

    def tick(self) -> int:
        return self._tick

    def column_array(self, name: str) -> np.ndarray:
        """Latest values of a component column, as numpy."""
        return columns_to_numpy({name: self.cols[name]}, self.meta)[name]

    def history_frame(self, components) -> DataFrame:
        if isinstance(components, str):
            components = [components]
        times = np.asarray(self._history.times, dtype=np.float64)
        start = np.datetime64(
            self._history.start_timestamp.replace(tzinfo=None), "us"
        )
        data: dict[str, np.ndarray] = {
            "time": start + (times * 1e6).astype("timedelta64[us]")
        }
        for q in components:
            comp, row = self._history.resolve(q)
            data[q] = self._history.series(comp)[:, row]
        return DataFrame(data)

    def history(self, components) -> DataFrame:
        df = self.history_frame(components)
        try:  # upgrade to real polars when available
            import polars  # noqa: F401
        except ImportError:
            return df
        return df.to_polars()

    def save_archive(self, path, format: str = "parquet") -> None:
        """Write every 'entity.component' series to ``path/<name>.<ext>``:
        Parquet (``"parquet"``/``"pq"``) or Arrow IPC (``"arrow"``/
        ``"arrow_ipc"``), both through pyarrow, imported here, or CSV
        (``DataFrame.write_csv``: a time column, vector cells as lists)."""
        import pathlib

        if format not in ("parquet", "pq", "arrow", "arrow_ipc", "csv"):
            raise ValueError(f"unknown archive format {format!r}")
        out = pathlib.Path(path)
        out.mkdir(parents=True, exist_ok=True)
        for name in self._history.column_names():
            df = self.history_frame([name])
            if format in ("parquet", "pq"):
                df.write_parquet(out / f"{name}.parquet")
            elif format in ("arrow", "arrow_ipc"):
                import pyarrow.ipc as ipc

                table = df._to_arrow_table()
                with ipc.new_file(str(out / f"{name}.arrow"), table.schema) as w:
                    w.write_table(table)
            else:
                df.write_csv(out / f"{name}.csv")
