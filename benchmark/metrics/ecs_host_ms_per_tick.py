"""``ecs_host_ms_per_tick``: the host's ms a tick of the ECS step: the
program's ``tick`` spans (``tick_metrics.span``, on the profiler's clock)
that start inside the traced window, summed, over their number.  Nothing
where the program records no such span.

Standard error also shows that number against the window's ticks, the ms
a tick of each span inside a tick (each system, the dense fold) and of the
tick's own time, the ``fold.probe`` spans a tick (0 once the verdict is
kept), and the share of the calls' device ops whose host launch lies
inside a ``tick`` span: the check that the spans and the device trace share
a clock."""

import sys

from benchmark.harness.program_spans import in_window, share


def read(trace, spans=None):
    mine = in_window(trace, spans)
    ticks = [s for s in mine if s.name == "tick"]
    if not ticks:
        return None
    from elodin_tpu_torch.tick_metrics import self_ns

    n = len(ticks)
    tick_ns = sum(s.end_ns - s.start_ns for s in ticks)
    own = sum(self_ns(s) for s in ticks)
    under = {}
    for s in mine:
        if s.name.startswith(("system.", "fold.")):
            under[s.name] = under.get(s.name, 0) + s.end_ns - s.start_ns
    probes = sum(s.name == "fold.probe" for s in mine)
    print(f"ecs_host_ms_per_tick: {n} tick spans, {trace.ticks} ticks in the window's calls; "
          "ms a tick " + ", ".join(f"{k} {v / 1e6 / n:.6g}" for k, v in sorted(under.items()))
          + f", the tick's own {own / 1e6 / n:.6g}; fold.probe {probes / n:.6g} a tick; "
          + share([op.host_ns for op in trace.call_ops], ticks,
                           "of the calls' device ops inside a tick span"), file=sys.stderr)
    return tick_ns / 1e6 / n
