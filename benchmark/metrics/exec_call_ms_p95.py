"""``exec_call_ms_p95``: ``call_ms_p95`` read in the traced window, for a
cell whose call's tail swings with the host's load too widely to hold a
bound end to end: the 95th percentile (linear between order statistics)
of every traced call's time by its CUDA events, the profiler's own cost on
the host included."""

import numpy as np


def read(trace):
    return float(np.percentile(trace.call_ms, 95)) if trace.call_ms else None
