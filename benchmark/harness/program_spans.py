"""The program's own spans (``elodin_tpu_torch.tick_metrics.span``), for the
per-layer metrics that read them beside the device trace.

The port records them on ``time.time_ns()``, the clock the profiler stamps
its host events with, so they are placed against the window and the device
ops as the benchmark's own spans are.  A program that records no span (an
older one) gives none, and its readers read nothing.
"""

from __future__ import annotations

import bisect
import sys

from .trace import Trace, _merged


def in_window(trace: Trace, spans=None) -> list:
    """The program's spans that start inside the window (``spans``, or the
    port's recorder's); none where the port records none, or where its
    recorder dropped the window's first spans past its cap."""
    a, b = trace.window()
    if spans is None:
        from elodin_tpu_torch import tick_metrics

        if not hasattr(tick_metrics, "spans"):
            return []
        spans = tick_metrics.spans()
        if tick_metrics.dropped_spans() and spans and spans[0].start_ns > a:
            print(f"program spans: {tick_metrics.dropped_spans()} dropped past the recorder's "
                  "cap, the window's first among them: nothing read", file=sys.stderr)
            return []
    return [s for s in spans if a <= s.start_ns <= b]


def inside(times: list, spans: list) -> int:
    """How many of ``times`` lie inside one of ``spans`` (which do not
    overlap)."""
    ivs = sorted((s.start_ns, s.end_ns) for s in spans)
    starts = [a for a, _ in ivs]
    n = 0
    for t in times:
        k = bisect.bisect_right(starts, t) - 1
        n += k >= 0 and t <= ivs[k][1]
    return n


def share(times: list, spans: list, what: str) -> str:
    """"k of n <what> (p %)": how many of ``times`` lie inside ``spans``."""
    held = inside(times, spans)
    return f"{held} of {len(times)} {what}" + (
        f" ({100.0 * held / len(times):.3f} %)" if times else "")


def idle_gaps(trace: Trace) -> list:
    """[(start, end)] of the window's device idle: the gaps between the
    union of the device ops, as the harness's ``breakdown`` finds them."""
    a, b = trace.window()
    busy = _merged((max(op.start_ns, a), min(op.start_ns + op.dur_ns, b)) for op in trace.ops)
    edges = [a] + [x for iv in busy for x in iv] + [b]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
