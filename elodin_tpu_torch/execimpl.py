"""World execution on one torch device (counterpart of
``elodin_tpu/execimpl.py``).

The JAX package compiles ``n`` telemetry batches of ``stride`` ticks into
one program.  Here the same ``build_step`` runs eagerly, tick by tick, in a
Python loop; the tick count stays a runtime value.  At each telemetry
boundary the step loop hands the committed device tensors to the telemetry
pump, a writer thread that copies them to the host and appends them to
``History``; every read of the history flushes the pump first.
``lockstep_session`` is the fast path of an external lockstep bridge
(``lockstep.UdpLockstep``): command columns bound from host buffers, one
host copy of the sent values per exchange.  The history is the checkpoint:
``state_at`` reads a recorded row, ``restore`` rewinds the device state to
it and cuts the history after it; ``save_checkpoint`` / ``load_checkpoint``
write and read the live state as an npz file.  With ``db_path`` the
history spools under that directory, and ``db.server.serve_exec`` sets
``on_commit_batch``, the tap through which the writer thread hands every
commit to the telemetry database; ``restore_from_db`` resumes from that
database.  ``write_component`` from another thread than the step loop's
(the database server's, for an ``external_control`` component) is held as
host numpy and applied before the next tick.

``device`` may be a mesh across processes (``parallel.make_mesh()`` after
``init_multihost``, one device a process): the columns are placed as
``jax.device_put`` places them on a sharding, each rank keeps the rows of
its ``ep`` block, and every tick runs under its row window.  The history,
``column_array`` and ``read_component`` see whole columns, gathered from
every rank (so every rank calls them).
"""

from __future__ import annotations

import datetime
import os
import queue as _queue
import tempfile
import threading
import time
import weakref

import numpy as np
import torch

from . import _config
from .dataframe import DataFrame
from .interop import columns_from_numpy, columns_to_numpy
from .parallel import distributed
from .parallel.mesh import Mesh, row_windows, shard_cols
from .system import build_step
from .tick_metrics import span
from .world import WorldMeta

# Exec's spans (tick_metrics.span)
RUN, SYNC = "exec.run", "exec.sync"


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

    def append_batch(self, ts: np.ndarray, stacked: dict[str, np.ndarray]) -> None:
        self.times.extend(ts.tolist())
        for name, value in stacked.items():
            self._append_chunk(name, np.asarray(value))

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


# telemetry batches a run hands the database's tap at most at once (the
# JAX package's cap on one compiled program)
_MAX_BATCHES = 4096

# seconds an idle writer thread waits before it checks whether its pump is
# still alive
_PUMP_IDLE_S = 1.0


class _TelemetryPump:
    """Bounded-queue writer thread between the step loop and the history.

    The step loop only enqueues the committed device tensors; the
    device-to-host copy and the history append run here, off the loop.
    Backpressure: the queue holds ``ELODIN_COMMIT_QUEUE`` batches (default
    64); when it is full the producer blocks, so nothing is lost, and the
    stall is counted.  An error on the writer thread is raised again at
    the next ``submit`` or ``flush``.

    The writer takes every commit queued when it wakes and appends them to
    the history as one stacked batch: the rows and timestamps are those of
    one commit at a time, in fewer calls.  ``tap()`` returns the telemetry
    database's tap (``(ts_us, stacked numpy columns)``) or None.  Commits
    are held for it until ``end_batch``: the step loop marks the end of
    each ``run`` batch, so the tap is called once a batch, with every row
    of it stacked, as the JAX package calls it once a compiled program.

    The thread holds the queue and a weak reference to the pump, never the
    pump itself: once its ``Exec`` is gone the history is freed and the
    thread ends."""

    def __init__(self, history: History, meta: WorldMeta, profiler: Profiler,
                 tap=lambda: None):
        depth = int(os.environ.get("ELODIN_COMMIT_QUEUE", "64"))
        self.q: _queue.Queue = _queue.Queue(maxsize=depth)
        self.history = history
        self.meta = meta
        self.profiler = profiler
        self.tap = tap
        self._tapped: list = []  # (ts, host columns) held until end_batch
        # optional Log2Histogram: the run loop's tick metrics "commit" phase
        # (recorded here because the commit runs off the step loop), one
        # sample a batch: the writer's seconds for its commits and its tap,
        # as the JAX package records one a compiled program
        self.commit_hist = None
        self._batch_s = 0.0
        self._batch_n = 0
        self.stalls = 0
        self.error: BaseException | None = None
        self._thread = threading.Thread(
            target=_pump_loop, args=(self.q, weakref.ref(self)), daemon=True,
            name="elodin-telemetry")
        self._thread.start()

    def submit(self, ts: np.ndarray, stacked: dict) -> None:
        self._put((ts, stacked))
        self._raise_error()

    def end_batch(self) -> None:
        """Mark the end of a batch: the commits submitted since the last
        mark go to the tap as one call.  A writer's error is raised at the
        next ``submit`` or ``flush``, not here."""
        self._put((None, _END_BATCH))

    def _put(self, item: tuple) -> None:
        try:
            self.q.put_nowait(item)
        except _queue.Full:
            self.stalls += 1
            self.q.put(item)

    def flush(self) -> None:
        self.q.join()
        self._raise_error()

    def _raise_error(self) -> None:
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def _commit(self, items: list) -> None:
        """Copy the queued commits ``items`` (``(ts, stacked device
        columns)`` each, or an end-of-batch mark) to the host, record them
        in the history as one stack, and hand each finished batch to the
        tap.  The copy and the append are shared evenly among the commits
        for ``commit_hist``."""
        try:
            t0 = time.perf_counter()
            host = [(ts, stacked if stacked is _END_BATCH else columns_to_numpy(stacked, self.meta))
                    for ts, stacked in items]
            commits = [h for h in host if h[1] is not _END_BATCH]
            if commits:
                self.history.append_batch(*_stack(commits))
            share = (time.perf_counter() - t0) / max(len(commits), 1)
            tap = self.tap()
            for ts, cols in host:
                if cols is not _END_BATCH:
                    self._batch_s += share
                    self._batch_n += 1
                    if tap is not None:
                        self._tapped.append((ts, cols))
                    continue
                if self._tapped:
                    t1 = time.perf_counter()
                    ts, cols = _stack(self._tapped)
                    self._tapped = []
                    start = self.history.start_timestamp.timestamp()
                    tap(((start + ts) * 1e6).astype(np.int64), cols)
                    self._batch_s += time.perf_counter() - t1
                if self.commit_hist is not None and self._batch_n:
                    self.commit_hist.observe_us(self._batch_s * 1e6)
                self._batch_s, self._batch_n = 0.0, 0
            self.profiler.copy_s += time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001  (raised again on the step loop)
            self.error = e


# the queued item that ends a batch (``_TelemetryPump.end_batch``)
_END_BATCH = object()


def _stack(commits: list) -> tuple[np.ndarray, dict]:
    """``(ts, host columns)`` commits as one: times and columns stacked."""
    return (np.concatenate([ts for ts, _ in commits]),
            {k: np.concatenate([cols[k] for _, cols in commits]) for k in commits[0][1]})


def _pump_loop(q: _queue.Queue, pump_ref) -> None:
    """The writer thread: commits the queued batches while its pump lives,
    every batch queued when it wakes at once, and ends once the pump is gone
    and the queue has stayed empty for ``_PUMP_IDLE_S``."""
    while True:
        try:
            items = [q.get(timeout=_PUMP_IDLE_S)]
        except _queue.Empty:
            if pump_ref() is None:
                return
            continue
        while True:
            try:
                items.append(q.get_nowait())
            except _queue.Empty:
                break
        pump = pump_ref()
        try:
            if pump is not None:
                pump._commit(items)
        finally:
            for _ in items:
                q.task_done()
            pump = items = None


def _to_device(buf: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of a host column on ``device`` (unsigned values as int64,
    the dtype they have there)."""
    if buf.dtype.kind == "u":
        buf = buf.astype(np.int64)
    return torch.tensor(buf, device=device)


class _LockstepSession:
    """The step of an external lockstep bridge (SITL co-simulation).

    The caller owns the command buffers (``cmd_bufs``: numpy, one whole
    column of each received component, written in place between
    exchanges).  One exchange binds each command column with one
    host-to-device copy, steps ``hold_ticks`` ticks eagerly, gathers the
    sent values of every tick into one flat f64 tensor (stacked
    ``(hold_ticks, len)`` when ``hold_ticks > 1``) and brings it to the host
    in one copy.  Host writes queued from other threads are applied first.
    ``hold_ticks > 1`` is the batched mode: the commands are held over the
    window, so the external controller runs at sim_rate / hold_ticks.

    ``emit`` is ``Exec.record_history`` when the session is built; with it
    every tick of an exchange goes to the telemetry pump.  A bridge that
    sees ``emit`` differ from the exec's setting builds a new session.
    ``Exec.write_component`` from the bridge's own thread rebinds its
    column at once."""

    def __init__(self, exec_: "Exec", send: list[str], recv: list[str],
                 hold_ticks: int = 1):
        if hold_ticks < 1:
            raise ValueError(f"hold_ticks must be >= 1, got {hold_ticks}")
        self.exec = exec_
        self.hold_ticks = hold_ticks
        self.send_specs = [exec_._history.resolve(q) for q in send]
        self.recv_comps = tuple(sorted({exec_._history.resolve(q)[0] for q in recv}))
        self.cmd_bufs: dict[str, np.ndarray] = {
            c: exec_.column_array(c).copy() for c in self.recv_comps}
        self.emit = exec_.record_history

    def _gather(self, cols: dict) -> torch.Tensor:
        return torch.cat([cols[c][row].reshape(-1).to(torch.float64)
                          for c, row in self.send_specs])

    def peek(self) -> np.ndarray:
        """Current (pre-step) values of the send components, packed."""
        return self._gather(self.exec.cols).cpu().numpy()

    def tick(self) -> np.ndarray:
        """Advance with the current command buffers; returns the packed
        post-step send vector: (len,) at hold_ticks=1, (hold_ticks, len) in
        batched mode (one row per tick of the window)."""
        ex = self.exec
        ex._apply_host_writes()
        dt = ex.sim_time_step
        cols = dict(ex.cols)
        for c in self.recv_comps:
            cols[c] = _to_device(self.cmd_bufs[c], ex.device)
        base = (ex._tick + 1) * dt
        outs = []
        try:
            # timed as _run_batch times its strides, so Exec.profile() counts
            # these ticks beside them: the steps, up to the copy of what the
            # session sends back, which waits for them, less the commits,
            # which stay between the steps so the card works while they run
            t0 = time.perf_counter()
            commit_s = 0.0
            for i in range(self.hold_ticks):
                cols = ex._step(cols)
                outs.append(self._gather(cols))
                if self.emit:
                    c0 = time.perf_counter()
                    ex._commit(base + i * dt, cols)
                    commit_s += time.perf_counter() - c0
        finally:
            ex._end_batch()
        ex.cols = cols
        ex._tick += self.hold_ticks
        ex.profiler.ticks += self.hold_ticks
        out = outs[0] if self.hold_ticks == 1 else torch.stack(outs)
        out = out.cpu().numpy()
        ex.profiler.kernel_s += time.perf_counter() - t0 - commit_s
        return out


class Exec:
    """World executor on one device.

    ``cols`` are numpy columns (``WorldBuilder.snapshot()``); they are
    checked against ``meta`` and moved to ``device`` once.  The parameters
    before ``device`` are the JAX package's, in its order.  ``db_path`` is
    the telemetry database's directory: the history spools under it, and
    ``db.server.serve_exec`` serves it.  An ``Exec`` on a mesh across
    processes takes no ``db_path``."""

    # True copies each commit to the history on the step loop, without the
    # pump: the reference that the pump's history is held to in the tests
    _sync_history = False

    def __init__(
        self,
        meta: WorldMeta,
        cols: dict[str, np.ndarray],
        system,
        sim_time_step: float,
        max_ticks: int | None = None,
        telemetry_rate: float | None = None,
        record_history: bool = True,
        db_path: str | None = None,
        device: str | torch.device = "cuda",
    ):
        self.mesh = device if isinstance(device, Mesh) else None
        if db_path is not None and self.mesh is not None:
            raise NotImplementedError(
                "Exec(db_path=...) on a mesh across processes: one database "
                "fed by every rank is not ported (ROADMAP.md §3)")
        self.meta = meta
        self.sim_time_step = sim_time_step
        self.max_ticks = max_ticks
        self.db_path = db_path
        # the telemetry database's tap, set by db.server.serve_exec: called
        # on the writer thread with (timestamps_us, stacked numpy columns)
        self.on_commit_batch = None
        self.profiler = Profiler(sim_time_step)
        self.record_history = record_history
        self._window: distributed.RowWindow | None = None  # this rank's rows on a mesh
        self.device = self._mesh_device() if self.mesh is not None else torch.device(device)
        # ticks between telemetry commits (>=1)
        if telemetry_rate is not None and telemetry_rate > 0:
            self.ticks_per_telemetry = max(
                1, round((1.0 / sim_time_step) / telemetry_rate)
            )
        else:
            self.ticks_per_telemetry = 1

        self._step = build_step(meta, system)
        if self.mesh is not None:
            self._step = self._windowed(self._step)

        t0 = time.perf_counter()
        self.cols = self._place(cols)
        self.profiler.build_s = time.perf_counter() - t0

        spool = os.path.join(db_path, "history_spool") if db_path else None
        self._history = History(meta, spool_dir=spool)
        self._tick = 0
        if self.record_history:
            self._history.append_state(0.0, columns_to_numpy(self._whole(self.cols), meta))
        self._pump: _TelemetryPump | None = None
        # write_component from another thread than the step loop's: one
        # host value a (component, row), applied before the next tick
        self._loop_thread = threading.get_ident()
        self._host_writes: dict[tuple[str, int], np.ndarray] = {}
        self._host_writes_lock = threading.Lock()

    # -- placement on a mesh ---------------------------------------------------

    def _mesh_device(self) -> torch.device:
        """This rank's device of the mesh, which must span processes with
        one device a process."""
        positions = self.mesh.local_positions()
        if not self.mesh.distributed or len(positions) != 1:
            raise ValueError("Exec on a mesh needs a mesh across processes with one device a "
                             "process (init_multihost, then make_mesh())")
        return self.mesh.devices[positions[0]]

    def _windowed(self, step):
        def run(cols):
            with distributed.row_window(self._window):
                return step(cols)

        return run

    def _place(self, cols: dict) -> dict:
        """Whole numpy columns as this executor's device columns.  On a mesh
        each column is placed by ``shard_cols`` and this rank keeps its
        shard; the row window is read from the placement."""
        if self.mesh is None:
            return columns_from_numpy(cols, self.meta, self.device)
        placed = shard_cols(self.mesh, columns_from_numpy(cols, self.meta, "cpu"))
        self._window = row_windows(self.mesh, placed, 0)[0]
        return {k: v.addressable_shards[0].data for k, v in placed.items()}

    def _whole(self, cols: dict) -> dict:
        """``cols`` with every cut column gathered from every rank (a
        collective: every rank calls it)."""
        w = self._window
        if w is None:
            return cols
        return {k: w.comm.all_gather_rows(v, w.sizes(k)) if k in w.cut else v
                for k, v in cols.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- running -------------------------------------------------------------

    def run(self, ticks: int = 1, show_progress: bool = True, is_canceled=None):
        """``ticks`` ticks, committed to the history every telemetry
        stride.  ``show_progress`` is accepted as the JAX package accepts
        it, and shows nothing.  The calling thread becomes the step loop's
        (``write_component``)."""
        with span(RUN):
            self._loop_thread = threading.get_ident()
            remaining = int(ticks)
            if self.max_ticks is not None:
                remaining = min(remaining, max(0, self.max_ticks - self._tick))
            stride = self.ticks_per_telemetry
            while remaining > 0:
                if remaining >= stride:
                    n = min(remaining // stride, _MAX_BATCHES)
                    self._run_batch(n, stride)
                    remaining -= n * stride
                else:
                    # an incomplete trailing batch still commits
                    self._run_batch(1, remaining)
                    remaining = 0
                if is_canceled is not None and _call_canceled(is_canceled):
                    return

    def _run_batch(self, n: int, stride: int) -> None:
        """``n`` telemetry batches of ``stride`` ticks, each committed to
        the history when recording, and all ``n`` handed to the database's
        tap as one batch; writes queued from other threads are applied
        before each batch."""
        try:
            for _ in range(n):
                self._apply_host_writes()
                cols = self.cols
                t0 = time.perf_counter()
                for _ in range(stride):
                    cols = self._step(cols)
                with span(SYNC):
                    self._sync()
                self.profiler.kernel_s += time.perf_counter() - t0
                self.cols = cols
                self._tick += stride
                self.profiler.ticks += stride
                if self.record_history:
                    self._commit(self._tick * self.sim_time_step, cols)
        finally:
            self._end_batch()

    def _commit(self, t: float, cols: dict) -> None:
        """Record the state ``cols`` at sim time ``t``: its device tensors
        go to the telemetry pump, which copies them to the host off the
        step loop.  The step never writes a column in place, so the
        tensors hold this state until the copy is made."""
        cols = self._whole(cols)
        if self._sync_history:
            t0 = time.perf_counter()
            self._history.append_state(t, columns_to_numpy(cols, self.meta))
            self.profiler.copy_s += time.perf_counter() - t0
            return
        self._ensure_pump().submit(np.asarray([t]), {k: v.unsqueeze(0) for k, v in cols.items()})

    def _end_batch(self) -> None:
        """The commits since the last call go to the database's tap as one
        batch."""
        if self._pump is not None:
            self._pump.end_batch()

    def _ensure_pump(self) -> _TelemetryPump:
        if self._pump is None:
            ref = weakref.ref(self)  # the pump must not keep its Exec alive

            def tap():
                ex = ref()
                return None if ex is None else ex.on_commit_batch

            self._pump = _TelemetryPump(self._history, self.meta, self.profiler, tap)
            self._pump.commit_hist = getattr(self, "commit_hist", None)
        return self._pump

    def flush_telemetry(self) -> None:
        """Block until every submitted telemetry batch has been copied to
        the host and recorded in the history; raises a writer's error."""
        if self._pump is not None:
            self._pump.flush()

    def lockstep_session(self, send: list[str], recv: list[str],
                         hold_ticks: int = 1) -> _LockstepSession:
        """The fast path of an external lockstep bridge: ``send`` and
        ``recv`` are 'entity.component' names; each exchange binds the
        received command columns from the session's ``cmd_bufs``, steps
        ``hold_ticks`` ticks and returns the sent values (see
        ``_LockstepSession``).  ``record_history`` is read once, when the
        session is built (``session.emit``)."""
        if self.mesh is not None:
            raise NotImplementedError("a lockstep session of an Exec on a mesh")
        return _LockstepSession(self, send, recv, hold_ticks)

    # -- host-side control -------------------------------------------------

    def write_component(self, qualified: str, value) -> None:
        """Write one entity's value of a component ('entity.component'); the
        next tick reads it.  From the step loop's thread the column is
        rebound at once, never written in place.  From another thread (the
        database server's, for an ``external_control`` component) the value
        is held as host numpy, touching no device tensor, and the step loop
        applies it before its next tick."""
        comp, row = self._history.resolve(qualified)
        if threading.get_ident() != self._loop_thread:
            c = self.meta.components[comp]
            v = np.asarray(value).astype(
                _config.numpy_column_dtype(comp, c)).reshape(c.ty.shape)
            with self._host_writes_lock:
                self._host_writes[(comp, row)] = v
            return
        self._write_now(comp, row, value)

    def _apply_host_writes(self) -> None:
        """Apply the writes other threads queued, on the step loop (a write
        queued while this reads an empty queue applies before the next
        batch)."""
        if not self._host_writes:
            return
        with self._host_writes_lock:
            writes, self._host_writes = self._host_writes, {}
        for (comp, row), v in writes.items():
            self._write_now(comp, row, v)

    def _write_now(self, comp: str, row: int, value) -> None:
        w = self._window
        if w is not None and comp in w.cut:
            r0, r1 = w.block(comp)
            if not r0 <= row < r1:
                return  # another rank holds the row
            row -= r0
        col = self.cols[comp]
        v = np.asarray(value)
        if v.dtype == np.uint64:
            v = v.astype(np.int64)
        col = col.clone()
        col[row] = torch.as_tensor(v, device=col.device).to(col.dtype).reshape(col.shape[1:])
        self.cols[comp] = col

    def read_component(self, qualified: str) -> np.ndarray:
        """One entity's current value of a component, as numpy (at least
        1-d); a write queued from another thread and not yet applied is
        what the next tick reads, so it is returned."""
        comp, row = self._history.resolve(qualified)
        with self._host_writes_lock:
            pending = self._host_writes.get((comp, row))
        if pending is not None:
            return np.atleast_1d(pending.copy())
        col = self._whole({comp: self.cols[comp]})[comp]
        value = columns_to_numpy({comp: col[row:row + 1]}, self.meta)[comp]
        return np.atleast_1d(value[0])

    # -- checkpoint and resume -------------------------------------------

    def state_at(self, tick: int) -> dict[str, np.ndarray]:
        """Every component's recorded value at history row ``tick`` (0 is
        the initial state), as numpy."""
        if not self.record_history:
            raise RuntimeError("history recording is disabled")
        self.flush_telemetry()
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
        self.cols = self._place(self.state_at(tick))
        restored_time = self._history.times[tick]
        self._history.truncate(tick + 1)
        self._tick = int(round(restored_time / self.sim_time_step))
        with self._host_writes_lock:
            self._host_writes.clear()

    def restore_from_db(self, db) -> int:
        """Resume from a telemetry database (``db.storage.Database``): each
        (entity, component) with stored rows takes its latest row back into
        the device state, each column at its own dtype and device (u64
        rows as int64).  The tick counter comes from the restored ``tick``
        column: the stored timestamps are anchored to a wall clock, so
        they cannot give it across processes.  Returns the number of
        components restored."""
        from .db.vtable import component_id_of, store_name

        host = columns_to_numpy(self._whole(self.cols), self.meta)
        restored = 0
        for comp_name, ids in self.meta.comp_entities.items():
            col = host[comp_name].copy()
            hit = False
            for i, eid in enumerate(ids):
                store = db.components.get(component_id_of(store_name(self.meta, comp_name, eid)))
                if store is None or store.len == 0:
                    continue
                _ts, row = store.latest()
                col[i] = np.asarray(row).reshape(col.shape[1:])
                hit = True
            if hit:
                host[comp_name] = col
                restored += 1
        self.cols = self._place(host)
        if "tick" in host and restored:
            # every entity's tick advances together; max only matters when
            # some stores lack their newest rows
            self._tick = int(host["tick"].max())
        return restored

    def save_checkpoint(self, path) -> None:
        """Write the live state as an npz file, one array per component at
        its host dtype (u64 and u32 columns as unsigned)."""
        np.savez(path, **columns_to_numpy(self._whole(self.cols), self.meta))

    def load_checkpoint(self, path) -> None:
        """Read the live state back from ``save_checkpoint``'s file (or
        the JAX package's), each array cast to its column's dtype."""
        with np.load(path) as data:
            cols = {k: np.asarray(data[k]).astype(
                        _config.numpy_column_dtype(k, self.meta.components[k]), copy=False)
                    for k in self.meta.components}
        self.cols = self._place(cols)

    # -- outputs ---------------------------------------------------------

    def profile(self) -> dict[str, float]:
        return self.profiler.profile()

    def tick(self) -> int:
        return self._tick

    def column_array(self, name: str) -> np.ndarray:
        """Latest values of a component column, as numpy."""
        return columns_to_numpy(self._whole({name: self.cols[name]}), self.meta)[name]

    def history_frame(self, components) -> DataFrame:
        if isinstance(components, str):
            components = [components]
        self.flush_telemetry()
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
