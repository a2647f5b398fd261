"""Editor-side ECS sync: a live component mirror over the DB wire protocol.

This is the analog of the reference's Bevy sync layer
(libs/impeller2/bevy/src/lib.rs) — the piece of the editor
that keeps a local entity/component world consistent with the database:

* ``TelemetryCache`` mirrors the reference's cache of per-component
  time-indexed series with *coverage* tracking — which time ranges have
  been fetched — so a scrub to any timeline position can tell "no data"
  apart from "not fetched yet" (``TelemetryCache`` + ``mark_covered`` /
  ``is_covered``, lib.rs:119-289).
* ``MirrorWorld`` is the sink + backfill loop: a subscription thread
  drains the real-time stream into the cache (``sink``, lib.rs:734),
  uncovered ranges are filled on demand from the DB's time-series store
  (``backfill_cache``, lib.rs:411), and editor-originated edits write back
  through the normal ingest path so every other subscriber sees them
  (``PacketTx::send_msg``, lib.rs:74).

Headless by design: the render loop is whoever calls ``value_at`` — the
web viewer, a test, or a plotting script — so the sync layer is testable
without a 3D engine.

A host-only copy of ``elodin_tpu/db/mirror.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["SeriesCache", "TelemetryCache", "MirrorWorld"]


class SeriesCache:
    """One component's time-indexed samples plus fetched-range coverage.

    Timestamps are microseconds (int).  Samples arrive mostly in order
    (live stream) but inserts tolerate out-of-order and duplicate
    timestamps (backfill racing the live sink); a duplicate timestamp
    keeps the latest write.
    """

    def __init__(self) -> None:
        self._ts: List[int] = []
        self._values: List[np.ndarray] = []
        # merged, sorted, non-overlapping [start, end] closed intervals
        self._covered: List[Tuple[int, int]] = []
        # one lock per series: the live sink thread and caller-thread
        # backfills insert CONCURRENTLY (the documented contract); an
        # unguarded bisect+insert pair can interleave and permanently
        # desynchronize _ts from _values
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._ts)

    def insert(self, ts: int, value: np.ndarray) -> None:
        ts = int(ts)
        value = np.asarray(value)
        with self._lock:
            if not self._ts or ts > self._ts[-1]:
                self._ts.append(ts)
                self._values.append(value)
                return
            i = bisect.bisect_left(self._ts, ts)
            if i < len(self._ts) and self._ts[i] == ts:
                self._values[i] = value
            else:
                self._ts.insert(i, ts)
                self._values.insert(i, value)

    def get_at_or_before(self, ts: int) -> Optional[Tuple[int, np.ndarray]]:
        """Latest sample with timestamp <= ts (timeline scrubbing;
        reference `get_at_or_before`, lib.rs:158)."""
        with self._lock:
            i = bisect.bisect_right(self._ts, int(ts))
            if i == 0:
                return None
            return self._ts[i - 1], self._values[i - 1]

    def range(self, start: int, end: int) -> Tuple[np.ndarray, np.ndarray]:
        """All samples with start <= ts <= end, as (ts[n], values[n,...])."""
        with self._lock:
            lo = bisect.bisect_left(self._ts, int(start))
            hi = bisect.bisect_right(self._ts, int(end))
            ts = np.asarray(self._ts[lo:hi], dtype=np.int64)
            if lo == hi:
                return ts, np.empty((0,))
            return ts, np.stack(self._values[lo:hi])

    def latest(self) -> Optional[Tuple[int, np.ndarray]]:
        with self._lock:
            if not self._ts:
                return None
            return self._ts[-1], self._values[-1]

    # -- coverage ------------------------------------------------------------

    def mark_covered(self, start: int, end: int) -> None:
        """Record [start, end] as fetched, merging adjacent intervals
        (reference `mark_covered`, lib.rs:193).  The live sink marks in
        ascending order, so extend-the-tail is O(1); the general rebuild
        only runs for out-of-order backfill marks."""
        start, end = int(start), int(end)
        if end < start:
            return
        with self._lock:
            if self._covered:
                s_last, e_last = self._covered[-1]
                if start > e_last + 1:
                    self._covered.append((start, end))
                    return
                if start >= s_last and end >= e_last:
                    self._covered[-1] = (s_last, max(end, e_last))
                    return
                if s_last <= start and end <= e_last:
                    return  # already covered
            merged: List[Tuple[int, int]] = []
            placed = False
            for s, e in self._covered:
                if e < start - 1 and not placed:
                    merged.append((s, e))
                elif s > end + 1:
                    if not placed:
                        merged.append((start, end))
                        placed = True
                    merged.append((s, e))
                else:  # overlaps or touches — absorb
                    start, end = min(start, s), max(end, e)
            if not placed:
                merged.append((start, end))
            self._covered = merged

    def is_covered(self, start: int, end: int) -> bool:
        """True iff every instant of [start, end] has been fetched
        (reference `is_covered`, lib.rs:213)."""
        start, end = int(start), int(end)
        with self._lock:
            for s, e in self._covered:
                if s <= start <= e:
                    if end <= e:
                        return True
                    start = e + 1
                elif s > start:
                    return False
            return start > end

    def uncovered(self, start: int, end: int) -> List[Tuple[int, int]]:
        """The sub-ranges of [start, end] not yet fetched — what a
        backfill must request (reference `series_store_backfill_candidates`,
        lib.rs:395)."""
        start, end = int(start), int(end)
        gaps: List[Tuple[int, int]] = []
        cur = start
        with self._lock:
            covered = list(self._covered)
        for s, e in covered:
            if e < cur:
                continue
            if s > end:
                break
            if s > cur:
                gaps.append((cur, min(s - 1, end)))
            cur = max(cur, e + 1)
            if cur > end:
                return gaps
        if cur <= end:
            gaps.append((cur, end))
        return gaps


class TelemetryCache:
    """Per-component ``SeriesCache`` map with a generation counter
    (reference `TelemetryCache`, lib.rs:119-143: bump on every insert so a
    render loop can skip repaints when nothing changed)."""

    def __init__(self) -> None:
        self._series: Dict[str, SeriesCache] = {}
        self._generation = 0
        self._lock = threading.Lock()

    @property
    def generation(self) -> int:
        return self._generation

    def bump(self) -> None:
        # += on an attribute is a read-modify-write; an unlocked bump racing
        # the sink thread can lose an increment and a generation-keyed
        # render loop would skip the frame carrying the new data
        with self._lock:
            self._generation += 1

    def series(self, name: str) -> SeriesCache:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = SeriesCache()
            return s

    def peek(self, name: str) -> Optional[SeriesCache]:
        """The series if it exists — read paths use this so probing a
        nonexistent (e.g. typo'd) name cannot pollute component_names()
        with a phantom empty series."""
        with self._lock:
            return self._series.get(name)

    def has_series(self, name: str) -> bool:
        return name in self._series

    def component_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def insert(self, name: str, ts: int, value: np.ndarray) -> None:
        self.series(name).insert(ts, value)
        self.bump()

    def get_at_or_before(self, name: str, ts: int):
        s = self.peek(name)
        return s.get_at_or_before(ts) if s is not None else None


class MirrorWorld:
    """A live, queryable mirror of the DB's component world.

    Composes the cache with the wire protocol: a sink thread drains a
    real-time subscription into the cache; ``backfill`` fills uncovered
    history from the DB's time-series store; ``set`` pushes editor edits
    back through the normal ingest path.  Entities are the dotted-name
    prefixes, as in the editor's entity tree.

    Usage::

        with MirrorWorld.connect(addr) as m:
            m.wait_for("ball.world_pos")
            ts, pos = m.latest("ball.world_pos")
            older = m.value_at("ball.world_pos", ts - 1_000_000)
            m.set("ball.gain", 2.0)          # editor edit -> DB
    """

    def __init__(self, client, components: Optional[Iterable[str]] = None,
                 live_contiguous: bool = True):
        self._client = client
        self.cache = TelemetryCache()
        self._components = list(components) if components else None
        self._stream = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._callbacks: List[Callable[[str, int, np.ndarray], None]] = []
        self._meta: Dict[str, object] = {}
        # The default subscription is the real-time stream, which delivers
        # EVERY ingested row of a subscribed component, so the span between
        # two consecutive live samples of one component holds no other data
        # and can be marked covered as one growing interval (O(1) memory).
        # Pass False when subscribing to a decimated fixed-rate stream,
        # where skipped samples make per-point coverage the honest record.
        self._live_contiguous = bool(live_contiguous)
        self._live_prev: Dict[str, int] = {}
        self._unresolved: Dict[str, int] = {}
        self.sink_errors = 0  # malformed rows skipped (diagnosable, nonfatal)

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def connect(cls, addr: str,
                components: Optional[Iterable[str]] = None) -> "MirrorWorld":
        from .client import Client

        m = cls(Client.connect(addr), components)
        m.start()
        return m

    def start(self) -> None:
        if self._thread is not None:
            return
        self.refresh_metadata()
        self._stream = self._client.stream(self._components)
        self._thread = threading.Thread(target=self._sink, daemon=True)
        self._thread.start()

    def _sink(self) -> None:
        # the reference's `sink` system (lib.rs:734): drain packets into
        # the cache; never let a malformed row kill the mirror — each row
        # is individually guarded (a decode error is counted and skipped,
        # not propagated into killing the daemon thread while the API
        # keeps serving an ever-staler cache)
        try:
            for row in self._stream:
                if self._closed:
                    break
                try:
                    self._sink_row(row)
                except Exception:  # noqa: BLE001
                    self.sink_errors += 1
        except Exception:  # noqa: BLE001
            if not self._closed:
                raise

    def _sink_row(self, row) -> None:
        for name in list(row.keys()):
            ts, val = row.timestamp_us, row[name]
            name = self._resolve(name)
            self.cache.insert(name, ts, val)
            s = self.cache.series(name)
            if self._live_contiguous:
                prev = self._live_prev.get(name, ts)
                s.mark_covered(min(prev, ts), ts)
                self._live_prev[name] = max(
                    ts, self._live_prev.get(name, ts)
                )
            else:
                s.mark_covered(ts, ts)
            for fn in self._callbacks:
                try:
                    fn(name, ts, val)
                except Exception:  # noqa: BLE001
                    pass

    def _resolve(self, name: str) -> str:
        """Map a bare hex component id (a component registered AFTER the
        subscription learned its id->name table) back to its dotted name by
        refreshing metadata, and teach the stream so later rows arrive
        already named.  Unresolvable ids are remembered with a retry
        backoff: without it a never-registered component would cost one
        synchronous metadata RPC per streamed row, stalling the sink."""
        if len(name) != 16 or not all(c in "0123456789abcdef" for c in name):
            return name
        misses = self._unresolved.get(name, 0)
        if misses and misses % 500 != 0:  # retry every 500th sighting
            self._unresolved[name] = misses + 1
            return name
        try:
            cid = int(name, 16)
            self.refresh_metadata()
            from .vtable import component_id_of

            for known in self._meta:
                if component_id_of(known) == cid:
                    if self._stream is not None:
                        self._stream._id_to_name[cid] = known
                    self._unresolved.pop(name, None)
                    return known
        except Exception:  # noqa: BLE001
            pass
        self._unresolved[name] = misses + 1
        return name

    def close(self) -> None:
        self._closed = True
        if self._stream is not None:
            self._stream.close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._client.close()

    def __enter__(self) -> "MirrorWorld":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- metadata / entity tree ----------------------------------------------

    def refresh_metadata(self) -> None:
        self._meta = self._client.components()

    def component_names(self) -> List[str]:
        return sorted(set(self._meta) | set(self.cache.component_names()))

    def entities(self) -> Dict[str, List[str]]:
        """Entity tree from dotted names: {"ball": ["world_pos", ...]}."""
        out: Dict[str, List[str]] = {}
        for name in self.component_names():
            ent, _, comp = name.rpartition(".")
            out.setdefault(ent or name, []).append(comp or name)
        return {k: sorted(v) for k, v in out.items()}

    # -- queries ---------------------------------------------------------------

    def latest(self, name: str) -> Optional[Tuple[int, np.ndarray]]:
        s = self.cache.peek(name)  # peek: a miss must not create a series
        got = s.latest() if s is not None else None
        if got is not None:
            return got
        sample = self._client.latest(name)
        if sample is None:
            return None
        arr = np.asarray(sample.values)
        self.cache.insert(name, sample.timestamp_us, arr)
        self.cache.series(name).mark_covered(
            sample.timestamp_us, sample.timestamp_us
        )
        return sample.timestamp_us, arr

    def value_at(self, name: str, ts: int,
                 backfill_window_us: int = 1_000_000):
        """Sample at-or-before ``ts`` — the timeline scrub.  If [ts-window,
        ts] has not been fetched, backfill it first so a scrub into cold
        history returns data instead of the nearest live sample
        (reference `apply_cached_data` + backfill, lib.rs:331,411)."""
        s = self.cache.peek(name)
        if s is None or not s.is_covered(max(ts - backfill_window_us, 0), ts):
            self.backfill(name, ts - backfill_window_us, ts)
            s = self.cache.peek(name)
        got = s.get_at_or_before(ts) if s is not None else None
        return got[1] if got is not None else None

    def wait_for(self, name: str, timeout: float = 5.0) -> bool:
        """Block until at least one live sample of ``name`` has arrived."""
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            s = self.cache.peek(name)
            if s is not None and len(s):
                return True
            _time.sleep(0.01)
        return False

    # -- backfill ---------------------------------------------------------------

    def backfill(self, name: str, start: int, end: int) -> int:
        """Fetch the uncovered sub-ranges of [start, end] from the DB's
        time-series store into the cache; returns samples fetched.  When
        the window is riddled with tiny gaps (point-coverage mode over a
        live region), one whole-window fetch replaces the per-gap RPC
        storm — duplicate timestamps re-insert harmlessly (latest write
        wins)."""
        start = max(int(start), 0)
        end = int(end)
        existing = self.cache.peek(name)
        gaps = (existing.uncovered(start, end) if existing is not None
                else [(start, end)])
        if not gaps:
            return 0
        if len(gaps) > 4:
            gaps = [(start, end)]
        n = 0
        s = None
        for lo, hi in gaps:
            try:
                ts, values = self._client.time_series(name, lo, hi + 1)
            except Exception:  # noqa: BLE001
                continue
            if s is None:
                # create the series only for real data or a known
                # component — a typo'd name must not become a phantom
                # covered-but-empty series (empty fetches of KNOWN
                # components do record coverage, so "no data here" is
                # remembered and not re-fetched every scrub)
                if len(ts) == 0 and existing is None and name not in self._meta:
                    continue
                s = existing if existing is not None else (
                    self.cache.series(name))
            for t, v in zip(ts, values):
                s.insert(int(t), np.asarray(v))
                n += 1
            s.mark_covered(lo, hi)
        if n:
            self.cache.bump()
        return n

    # -- edits -------------------------------------------------------------------

    def set(self, name: str, value, timestamp_us: Optional[int] = None) -> None:
        """Editor edit: write a component value back through the normal
        ingest path so the DB and every other subscriber converge on it."""
        from .storage import now_timestamp_us

        ts = timestamp_us if timestamp_us is not None else now_timestamp_us()
        self._client.send(name, value, ts)

    def on_update(self, fn: Callable[[str, int, np.ndarray], None]) -> None:
        """Register a live-update callback (the Bevy system analog)."""
        self._callbacks.append(fn)
