"""Always-on, zero-alloc per-phase tick metrics
(parity: libs/nox-py/src/tick_metrics.rs — log2-bucketed latency histograms
with a summary printed on exit, plus the ELODIN_SIM_SUMMARY_JSON per-run
summary at world_builder.rs:596-598).

A host-only copy of ``elodin_tpu/tick_metrics.py``: importing anything
under ``elodin_tpu`` first runs its ``__init__``, which imports JAX, so
the port keeps its own.  Beside the copy, the port's spans: ``span(name)``
records where the host was while a ``torch.profiler`` records, on the
clock that stamps the profiler's host events, and does nothing otherwise;
``spans()`` and ``self_ns`` read them."""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import os
import threading
import time

import torch.autograd.profiler as _profiler


class Log2Histogram:
    """Power-of-two latency buckets over microseconds."""

    N_BUCKETS = 40

    def __init__(self):
        self.buckets = [0] * self.N_BUCKETS
        self.count = 0
        self.sum_us = 0.0
        self.max_us = 0.0

    def observe_us(self, us: float) -> None:
        self.count += 1
        self.sum_us += us
        if us > self.max_us:
            self.max_us = us
        b = 0 if us < 1 else min(int(math.log2(us)) + 1, self.N_BUCKETS - 1)
        self.buckets[b] += 1

    @property
    def mean_us(self) -> float:
        return self.sum_us / self.count if self.count else 0.0

    def percentile_us(self, p: float) -> float:
        """Upper bucket bound at percentile p (0..1)."""
        if not self.count:
            return 0.0
        target = p * self.count
        acc = 0
        for i, c in enumerate(self.buckets):
            acc += c
            if acc >= target:
                return float(2**i)
        return self.max_us

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean_us": round(self.mean_us, 2),
            "p50_us": self.percentile_us(0.5),
            "p99_us": self.percentile_us(0.99),
            "max_us": round(self.max_us, 2),
        }


class TickMetrics:
    """Per-phase histograms for the serve loop (tick_metrics.rs:1-60):
    pre_step / run / commit / post_step / pacing.  ``commit`` is the
    telemetry writer thread's, one sample a run batch."""

    PHASES = ("pre_step", "run", "commit", "post_step", "pacing")

    def __init__(self):
        self.hist = {p: Log2Histogram() for p in self.PHASES}
        self._t0 = None
        self.started = time.perf_counter()

    def phase(self, name: str):
        return _PhaseTimer(self.hist[name])

    def summary(self) -> dict:
        wall = time.perf_counter() - self.started
        ticks = self.hist["run"].count
        return {
            "ticks": ticks,
            "wall_s": round(wall, 3),
            "phases": {p: h.summary() for p, h in self.hist.items() if h.count},
        }

    def print_summary(self) -> None:
        s = self.summary()
        print(f"tick metrics: {s['ticks']} ticks over {s['wall_s']}s")
        for phase, h in s["phases"].items():
            print(
                f"  {phase:>14}: mean {h['mean_us']:>9.1f}us  "
                f"p50 {h['p50_us']:>9.0f}us  p99 {h['p99_us']:>9.0f}us  "
                f"max {h['max_us']:>9.1f}us  (n={h['count']})"
            )

    def write_summary_json(self, extra: dict | None = None) -> None:
        """Honor ELODIN_SIM_SUMMARY_JSON (world_builder.rs:596-598)."""
        path = os.environ.get("ELODIN_SIM_SUMMARY_JSON")
        if not path:
            return
        data = self.summary()
        if extra:
            data.update(extra)
        with open(path, "w") as f:
            json.dump(data, f, indent=2)


class _PhaseTimer:
    __slots__ = ("hist", "t0")

    def __init__(self, hist: Log2Histogram):
        self.hist = hist

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe_us((time.perf_counter() - self.t0) * 1e6)
        return False


# -- spans --------------------------------------------------------------------

SPAN_CAP = 1 << 18  # spans kept; past it the oldest are dropped


class Span:
    """One span of the host's time: ``name``; ``start_ns`` and ``end_ns``
    by ``time.time_ns()``, the clock torch's profiler stamps its host events
    with (``end_ns`` is 0 while the span is open); ``index``, its number
    among every span opened since import; ``parent``, the index of the span
    that enclosed it on its thread (-1 at the top); ``root``, the index of
    the outermost one (its own at the top), which the spans of one call
    share."""

    __slots__ = ("name", "start_ns", "end_ns", "index", "parent", "root", "child_ns")

    def __init__(self, name: str, index: int, parent: "Span | None"):
        self.name = name
        self.index = index
        self.parent = -1 if parent is None else parent.index
        self.root = index if parent is None else parent.root
        self.end_ns = 0
        self.child_ns = 0  # the time its children cover: they nest on one thread
        self.start_ns = time.time_ns()


class _SpanBuffer:
    """The spans in the order they opened, at most ``cap``; each thread's
    open spans."""

    def __init__(self, cap: int = SPAN_CAP):
        self.spans = collections.deque(maxlen=cap)
        self.count = itertools.count()
        self.local = threading.local()

    def open(self, name: str) -> Span:
        stack = self.local.__dict__.setdefault("stack", [])
        s = Span(name, next(self.count), stack[-1] if stack else None)
        stack.append(s)
        self.spans.append(s)
        return s

    def close(self, s: Span) -> None:
        stack = self.local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += s.end_ns - s.start_ns

    def dropped(self) -> int:
        return self.spans[-1].index + 1 - len(self.spans) if self.spans else 0


_BUFFER = _SpanBuffer()
_OFF = contextlib.nullcontext()


class _Recorded:
    """A span while a profiler records: in the buffer, and as a
    ``record_function`` of the same name inside it."""

    __slots__ = ("name", "span", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.span = _BUFFER.open(self.name)
        self.annotation = _profiler.record_function(self.name)
        self.annotation.__enter__()
        return self.span

    def __exit__(self, *exc):
        try:
            self.annotation.__exit__(*exc)
        finally:
            self.span.end_ns = time.time_ns()
            _BUFFER.close(self.span)
        return False


def span(name: str):
    """A context manager over the host's work named ``name``.  While no
    ``torch.profiler`` records, one shared context that records nothing;
    while one records, a ``Span`` appended to the buffer (``spans()``) and a
    ``record_function(name)``, so the profile's table and trace show it too."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recorded(name)


def spans() -> list:
    """The ``Span``s kept, in the order they opened (``dropped_spans()``
    older ones were dropped past ``SPAN_CAP``)."""
    return list(_BUFFER.spans)


def dropped_spans() -> int:
    return _BUFFER.dropped()


def self_ns(s: Span) -> int:
    """``s``'s duration less what its children cover."""
    return s.end_ns - s.start_ns - s.child_ns


class Liveness:
    """Sim liveness heartbeat (parity: libs/s10/src/liveness.rs — a UDP
    beacon the supervisor uses to kill hung sims)."""

    def __init__(self, port: int | None = None, interval: float = 1.0):
        import socket

        self.port = port
        self.interval = interval
        self._beat = time.monotonic()
        self._stop = threading.Event()
        self._sock = None
        self._thread = None
        if port:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._thread = threading.Thread(target=self._pump, daemon=True)
            self._thread.start()

    def beat(self) -> None:
        self._beat = time.monotonic()

    def age(self) -> float:
        return time.monotonic() - self._beat

    def _pump(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                payload = json.dumps({"age_s": round(self.age(), 3)}).encode()
                self._sock.sendto(payload, ("127.0.0.1", self.port))
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)
            self._thread = None
        if self._sock is not None:  # don't leak the fd across many runs
            self._sock.close()
            self._sock = None
