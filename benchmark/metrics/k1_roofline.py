"""``k1_roofline``: K1's share of its roofline, in %: the frozen bound of
each launch (``harness.peaks.sixdof_rollout_bound_s``: the function's 607
f64 operations and 13 SFU results a body-tick, the state's bytes) over the
device time of the launches of ``sixdof_rk4`` inside the calls.  Nothing
when the window launched no K1."""

from benchmark.harness import peaks

KERNEL = "sixdof_rk4"


def read(trace):
    ops = trace.kernel(KERNEL)
    if not ops:
        return None
    bound, _ = peaks.sixdof_rollout_bound_s(trace.bodies, trace.ticks_per_call, trace.dtype,
                                            trace.sm_count)
    return 100.0 * bound * len(ops) / (sum(op.dur_ns for op in ops) / 1e9)
