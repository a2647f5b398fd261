"""Always-on, zero-alloc per-phase tick metrics
(parity: libs/nox-py/src/tick_metrics.rs — log2-bucketed latency histograms
with a summary printed on exit, plus the ELODIN_SIM_SUMMARY_JSON per-run
summary at world_builder.rs:596-598).

A host-only copy of ``elodin_tpu/tick_metrics.py``: importing anything
under ``elodin_tpu`` first runs its ``__init__``, which imports JAX, so
the port keeps its own."""

from __future__ import annotations

import json
import math
import os
import time


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
    pre_step / copy_db_to_world / run / commit / post_step / pacing.
    ``commit`` is the telemetry writer thread's, one sample a run batch."""

    PHASES = ("pre_step", "copy_to_world", "run", "commit", "post_step", "pacing")

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


class Liveness:
    """Sim liveness heartbeat (parity: libs/s10/src/liveness.rs — a UDP
    beacon the supervisor uses to kill hung sims)."""

    def __init__(self, port: int | None = None, interval: float = 1.0):
        import socket
        import threading

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
