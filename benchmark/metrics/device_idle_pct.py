"""``device_idle_pct``: the share of the traced window, in %, in which no
op ran on the card: 1 - busy / wall."""


def read(trace):
    wall = trace.window_s()
    if not trace.ops or wall <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / wall)
