"""One run of one cell: set-up, the measured window, the reading of the
trace, the comparison that decides ``correct``, and the result line.

The window is a closed loop with one caller: each call is issued, then
waited for (``torch.cuda.synchronize``), then the next is issued, until
``seconds`` have passed; the call that is running then ends the window.
Each call is timed on the card by a CUDA event before and after it.  The
calls to compare are drawn from the seed, as points in the window: a call
is compared when it is the first to start after its point; the state it is
judged on is copied outside its timing.
"""

from __future__ import annotations

import gc
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.harness import nojax, spec
from benchmark.harness import trace as tr

SAMPLE_KEY = 0x5A3B1E  # the seed's stream of compared calls
TRACE_ATTEMPTS = 2  # traced windows at most, where the profiler recorded no device op


class NoCard(RuntimeError):
    """The cell's cards are not there: the run prints no result."""


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded: the run prints no result."""


@dataclass
class Window:
    """What the end-to-end metrics read."""

    calls: int
    call_ms: list
    wall_s: float
    entity_steps: int
    setup_s: float


class _CallClock:
    """Each call's ms: CUDA events on a card, the host's clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.marks = []

    def start(self):
        if self.cuda:
            self._first = torch.cuda.Event(enable_timing=True)
            self._first.record()
        else:
            self._first = time.perf_counter()

    def stop(self):
        if self.cuda:
            last = torch.cuda.Event(enable_timing=True)
            last.record()
            torch.cuda.synchronize(self.device)
            self.marks.append((self._first, last))
        else:
            self.marks.append((time.perf_counter() - self._first) * 1e3)

    def ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.marks] if self.cuda else self.marks


def _window(driver, seconds: float, points: list, traced: bool, device):
    clock, kept, calls, due = _CallClock(device), [], 0, list(points)
    with tr.span(tr.WINDOW, traced):
        t0 = time.perf_counter()
        while (elapsed := time.perf_counter() - t0) < seconds:
            compared = bool(due) and elapsed >= due[0]
            if compared:
                due.pop(0)
                with tr.span(tr.KEEP, traced):
                    before = driver.before(calls)
            with tr.span(tr.CALL, traced):
                clock.start()
                with tr.span(tr.ISSUE, traced):
                    out = driver.call(calls)
                with tr.span(tr.SYNC, traced):
                    clock.stop()
            if compared:
                with tr.span(tr.KEEP, traced):
                    kept.append(driver.keep(calls, before, out))
            calls += 1
        wall_s = time.perf_counter() - t0
    return calls, clock.ms(), wall_s, kept


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not read ({e})"


def _finite(x):
    return x if not isinstance(x, float) or math.isfinite(x) else str(x)


def run(name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        overrides: dict | None = None, t0: float | None = None, control: bool = False) -> dict:
    """The result of one run of the cell ``name``.  ``device`` "cuda" looks
    for the cell's cards first and raises ``NoCard`` without them; the CPU
    tests drive the rest of a run on "cpu", with ``overrides`` of the
    cell's traffic to shrink it.  ``control`` judges the reference computed
    one precision lower in the program's place (``limits.py``)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.cell(name)
    cell.traffic.update(overrides or {})
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false: the benchmark runs on a card")
        if torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{name} asks for {cell.chips} cards, {torch.cuda.device_count()} seen")
    seed %= 2**64
    marks = {"imports": time.perf_counter()}
    driver = cell.entry().Driver(cell, seed, device)
    marks["inputs"] = time.perf_counter()
    kept = driver.warm_up()
    marks["warm-up"] = time.perf_counter()
    if traced:
        with tr.profiler():  # the profiler's own first start, outside the window
            driver.call(-1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = cell.traffic
    rng = np.random.default_rng(np.random.SeedSequence([seed, SAMPLE_KEY]))
    points = sorted(rng.uniform(0.05, 0.95, t["compared_calls"]) * seconds)
    setup_s = time.perf_counter() - t0
    steps, last = [], t0
    for step, at in marks.items():
        steps.append(f"{step} {at - last:.3f} s")
        last = at
    print(f"{name}: set-up {setup_s:.3f} s: " + ", ".join(steps), file=sys.stderr)

    ops, spans = [], []
    for attempt in range(1, (TRACE_ATTEMPTS if traced else 1) + 1):
        if traced:
            with tr.profiler() as prof:
                calls, call_ms, wall_s, kept_now = _window(driver, seconds, points, True, dev)
            ops, spans = tr.read(prof)
        else:
            calls, call_ms, wall_s, kept_now = _window(driver, seconds, points, False, dev)
        kept += kept_now
        if ops or not traced:
            break
        print(f"traced window {attempt}: the profiler recorded no device op", file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    metrics, breakdown = {}, None
    if traced:
        trace = tr.Trace(ops, spans, t["ticks_per_call"], t["bodies"], cell.config["dtype"],
                         torch.cuda.get_device_properties(dev).multi_processor_count
                         if dev.type == "cuda" else 0, call_ms=call_ms)
        device_info.update(busy_s=trace.busy_s(), window_s=trace.window_s())
        breakdown = tr.breakdown(trace)
        print(f"{name}: traced {trace.calls} calls, {len(trace.call_ops)} of {len(ops)} device "
              f"ops inside them, busy {trace.busy_s():.6g} s of {trace.window_s():.6g}", file=sys.stderr)
        chosen, reading = cell.per_layer, trace
    else:
        chosen = cell.end_to_end
        reading = Window(calls, call_ms, wall_s, calls * t["bodies"] * t["ticks_per_call"],
                         setup_s)
    for m in chosen:
        value = spec.metric_reader(m["name"])(reading)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if call_ms:
        print(f"{name}: {calls} calls in {wall_s:.4f} s, call ms median "
              f"{statistics.median(call_ms):.6g}, p95 {np.percentile(call_ms, 95):.6g}, "
              f"max {max(call_ms):.6g}; setup {setup_s:.4f} s; {len(kept)} calls compared",
              file=sys.stderr)
    if dev.type == "cuda":
        print(f"card: {_card_line()}", file=sys.stderr)

    driver.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers, by_group = driver.judge(kept, control=control)
    judge_s = time.perf_counter() - t_judge
    limits = t["limits"]
    compared = {k: {"value": _finite(v), "limit": limits[k]} for k, v in numbers.items()}
    failed = sum(not v <= limits[k] for k, v in numbers.items())
    found = nojax.forbidden_modules()
    if found:
        raise ForbiddenModules(f"modules loaded that the port must not load: {found}")
    print(f"{name}: worst gap by group " + ", ".join(f"{g} {v:.6g}" for g, v in by_group.items())
          + f"; the reference took {judge_s:.4f} s" + (" (control)" if control else ""), file=sys.stderr)
    for k, v in numbers.items():
        print(f"compared {k} {v!r} limit {limits[k]!r}", file=sys.stderr)
    result = {"correct": failed == 0, "attempted": calls, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["gaps_by_group"] = {g: _finite(v) for g, v in by_group.items()}
    result["compared"] = compared
    return result
