"""``device_ops_per_tick``: device ops the calls issued, a tick (a count:
kernels and copies)."""


def read(trace):
    if not trace.ticks or not trace.call_ops:
        return None
    return len(trace.call_ops) / trace.ticks
