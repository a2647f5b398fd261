"""``wrapper_host_ms_per_call``: the host's ms a call inside
``sixdof_rollout``: the program's ``rollout`` spans (``tick_metrics.span``,
on the profiler's clock) that start inside the traced window, summed, over
the window's calls.  Nothing where the program records no such span.

Standard error also shows the ms a call of the wrapper's inner spans
(``rollout.pack``, ``rollout.launch``, ``rollout.unpack``), and how many of
the calls' ops lie inside the spans that issued them: the wrapper's own ops
(torch's, placed by the host call that launched them) inside a ``rollout``
span, the check that the spans and the device trace share a clock; and K1's
inside ``rollout.launch``.  K1's device op links to no host op (it is
launched through ctypes, with no torch op around it), so the harness places
it by its device start: inside ``rollout.launch`` only where the card
started it before the span closed."""

import sys

from benchmark.harness.program_spans import in_window, share

KERNEL = "sixdof_rk4"
INNER = ("rollout.pack", "rollout.launch", "rollout.unpack")


def read(trace, spans=None):
    mine = in_window(trace, spans)
    calls = [s for s in mine if s.name == "rollout"]
    if not calls or not trace.calls:
        return None
    ms = {name: sum(s.end_ns - s.start_ns for s in mine if s.name == name) / 1e6 / trace.calls
          for name in ("rollout",) + INNER}
    k1 = [op.host_ns for op in trace.call_ops if KERNEL in op.name]
    own = [op.host_ns for op in trace.call_ops if KERNEL not in op.name]
    print(f"wrapper_host_ms_per_call: {len(calls)} rollout spans in {trace.calls} calls; ms a "
          "call " + ", ".join(f"{k} {v:.6g}" for k, v in ms.items())
          + "; " + share(own, calls, "of the wrapper's ops inside a rollout span") + ", "
          + share(k1, [s for s in mine if s.name == "rollout.launch"],
                   f"{KERNEL} ops (by device start) inside rollout.launch"), file=sys.stderr)
    return ms["rollout"]

