"""``call_ms_p95``: the 95th percentile (linear between order statistics)
of every call's time in the window, each from its issue to the end of its
work, read from CUDA events recorded on the card before and after the call
(the host's clock is too coarse for a call of a few ms)."""

import numpy as np


def read(window):
    return float(np.percentile(window.call_ms, 95)) if window.call_ms else None
