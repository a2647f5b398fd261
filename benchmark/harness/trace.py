"""The device trace of a run's window, and what the per-layer metrics read.

The window runs under ``torch.profiler`` (CPU and CUDA activities).  The
device ops are read from the profiler's raw results, the same ones and the
same names left out that ``prof.events()`` keeps as device events, without
the tree of Python events that ``events()`` builds (a copy of
``chip_smoke.py::_trace_events``'s reading).  The benchmark's own spans
(``record_function`` around each call, its synchronize and the window) are
read from the same results, on the same clock, so each device op can be
placed in the call that issued it (by the host op that launched it) and
each idle gap beside what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

# the benchmark's spans (record_function names)
WINDOW, CALL, ISSUE, SYNC, KEEP = ("bench.window", "bench.call", "bench.issue",
                                   "bench.sync", "bench.keep")
# innermost first: what the host was doing in a gap
_SPAN_ORDER = (ISSUE, SYNC, KEEP, CALL, WINDOW)
BREAKDOWN_ENTRIES = 10


@dataclass
class Op:
    name: str
    start_ns: int
    dur_ns: int
    device: int
    host_ns: int  # when the host op that launched it started (its start if unknown)


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class Trace:
    """Device ops and benchmark spans of one traced window, with what the
    cell states about its work, for the per-layer metrics' readers."""

    ops: list  # [Op], every device op of the window
    spans: list  # [Span], the benchmark's spans
    ticks_per_call: int
    bodies: int
    dtype: str
    sm_count: int
    call_ms: list = field(default_factory=list)  # each call's ms by its CUDA events
    call_ops: list = field(default_factory=list)  # the ops issued inside a call

    def __post_init__(self):
        calls = sorted((s.start_ns, s.end_ns) for s in self.spans if s.name == CALL)
        starts = [a for a, _ in calls]
        self.call_ops = []
        for op in self.ops:
            k = bisect.bisect_right(starts, op.host_ns) - 1
            if k >= 0 and op.host_ns <= calls[k][1]:
                self.call_ops.append(op)
        self.calls = len(calls)

    @property
    def ticks(self) -> int:
        return self.calls * self.ticks_per_call

    def kernel(self, name: str) -> list:
        """The ops of a call whose name holds ``name``."""
        return [op for op in self.call_ops if name in op.name]

    def window(self) -> tuple[int, int]:
        (w,) = [s for s in self.spans if s.name == WINDOW]
        return w.start_ns, w.end_ns

    def window_s(self) -> float:
        a, b = self.window()
        return (b - a) / 1e9

    def busy_s(self) -> float:
        """Seconds in which an op ran on a device, inside the window,
        averaged over the devices that ran any."""
        a, b = self.window()
        per_device = {}
        for op in self.ops:
            per_device.setdefault(op.device, []).append(
                (max(op.start_ns, a), min(op.start_ns + op.dur_ns, b)))
        if not per_device:
            return 0.0
        return sum(_union_ns(iv) for iv in per_device.values()) / len(per_device) / 1e9


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _union_ns(intervals) -> int:
    return sum(e - s for s, e in _merged(intervals))


def breakdown(trace: Trace) -> dict:
    """The device ops that took most time, by name, and the longest idle
    gaps inside the window, each named by the innermost benchmark span the
    host was in at the gap's middle; at most ``BREAKDOWN_ENTRIES`` each, in
    seconds."""
    by_name = {}
    for op in trace.ops:
        by_name[op.name] = by_name.get(op.name, 0) + op.dur_ns
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    a, b = trace.window()
    busy = _merged((max(op.start_ns, a), min(op.start_ns + op.dur_ns, b)) for op in trace.ops)
    edges = [a] + [x for iv in busy for x in iv] + [b]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:BREAKDOWN_ENTRIES]
    return {"device_ops": [[name[:160], ns / 1e9] for name, ns in device_ops],
            "idle_gaps": [[_host_doing(trace.spans, (s + e) // 2), (e - s) / 1e9]
                          for s, e in gaps]}


def _host_doing(spans, t_ns: int) -> str:
    inside = {s.name for s in spans if s.start_ns <= t_ns <= s.end_ns}
    for name in _SPAN_ORDER:
        if name in inside:
            return name.split(".", 1)[1]
    return "outside"


def span(name: str, on: bool):
    """``record_function(name)`` when the window is traced, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def profiler():
    """A profiler of CPU and CUDA activity, as ``chip_smoke.py`` traces."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def read(prof) -> tuple[list, list]:
    """([Op], [Span]) from a finished profiler's raw results: the device
    ops (CUDA device events, the names ``prof.events()`` leaves out and the
    user annotations left out) and the benchmark's own spans."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name

    events = list(prof.profiler.kineto_results.events())
    # a device op links to the host op that launched it; the host's start is
    # on the spans' clock exactly, where the device's is aligned to it only
    # to some µs
    host_start = {e.correlation_id(): e.start_ns() for e in events
                  if e.device_type() != DeviceType.CUDA and e.correlation_id() > 0}
    ops, spans = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            # a record_function span also shows on the device's timeline, as
            # a user annotation: it is no op
            if not (_filter_name(e.name()) or e.is_hidden_event() or e.is_user_annotation()
                    or e.name().startswith("bench.")):
                ops.append(Op(e.name(), e.start_ns(), e.duration_ns(), e.device_index(),
                              host_start.get(e.linked_correlation_id(), e.start_ns())))
        elif e.name().startswith("bench."):
            spans.append(Span(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return ops, spans
