"""``wrapper_device_ms_per_call``: device ms a call in ops other than K1
(``sixdof_rollout``'s packing and unpacking), over the calls of the
window.  Nothing when no call ran K1."""

KERNEL = "sixdof_rk4"


def read(trace):
    if not trace.calls or not trace.kernel(KERNEL):
        return None
    ns = sum(op.dur_ns for op in trace.call_ops if KERNEL not in op.name)
    return ns / 1e6 / trace.calls
