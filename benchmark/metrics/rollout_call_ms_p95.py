"""``rollout_call_ms_p95``: the 95th percentile (linear between order
statistics) of every traced call's time by its CUDA events, in a cell
whose calls are sent ahead of the host's wait: from the card reaching the
call to the end of its work (the wrapper's ops and K1, and any wait for
the host inside the call).  The tail of a call's device time, which the
window's rate averages."""

import numpy as np


def read(trace):
    return float(np.percentile(trace.call_ms, 95)) if trace.call_ms else None
