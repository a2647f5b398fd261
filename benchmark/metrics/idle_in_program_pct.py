"""``idle_in_program_pct``: of the traced window's device-idle time (the
gaps between the union of the device ops), the share, in %, in which the
host's innermost program span (``tick_metrics.span``, on the profiler's
clock, started inside the window) was one other than ``exec.sync``: idle
that the program's own host work left, not its waiting for the card.
Nothing where the program records no span, or the card never idled.

Standard error shows the window's idle ms by innermost program span, and
outside the program (the benchmark's own work, its synchronize and the
profiler's); the rows add up to the idle time."""

import sys

from benchmark.harness.program_spans import idle_gaps, in_window

WAITING = "exec.sync"
OUTSIDE = "outside the program"


def innermost(spans) -> list:
    """[(start, end, name)] in time order: where the host was in each span
    and in none of its children (the spans nest, as on one thread)."""
    out, stack, t = [], [], 0
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1][0] <= s.start_ns:
            end, name = stack.pop()
            out.append((t, end, name))
            t = end
        if stack:
            out.append((t, s.start_ns, stack[-1][1]))
        stack.append((s.end_ns, s.name))
        t = s.start_ns
    while stack:
        end, name = stack.pop()
        out.append((t, end, name))
        t = end
    return [seg for seg in out if seg[1] > seg[0]]


def idle_by_span(trace, spans=None) -> dict:
    """{innermost span, or OUTSIDE: ns of device idle}, over the window."""
    segs = innermost(in_window(trace, spans))
    rows, k = {}, 0
    for g0, g1 in idle_gaps(trace):
        covered = 0
        while k < len(segs) and segs[k][1] <= g0:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < g1:
            s0, s1, name = segs[j]
            ns = min(g1, s1) - max(g0, s0)
            rows[name] = rows.get(name, 0) + ns
            covered += ns
            j += 1
        rows[OUTSIDE] = rows.get(OUTSIDE, 0) + (g1 - g0) - covered
    return rows


def read(trace, spans=None):
    mine = in_window(trace, spans)
    if not mine:
        return None
    rows = idle_by_span(trace, mine)
    idle = sum(rows.values())
    if idle <= 0:
        return None
    print(f"idle_in_program_pct: {idle / 1e6:.6g} ms idle in the window: "
          + ", ".join(f"{name} {ns / 1e6:.6g} ms" for name, ns in
                      sorted(rows.items(), key=lambda kv: -kv[1])), file=sys.stderr)
    return 100.0 * (idle - rows.get(OUTSIDE, 0) - rows.get(WAITING, 0)) / idle
