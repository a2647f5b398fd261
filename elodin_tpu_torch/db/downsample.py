"""Largest-Triangle-Three-Buckets downsampling for plot/sparkline queries.

The reference runs LTTB server-side so the editor never pulls full-rate
telemetry for overview plots (SparklineQuery/PlotOverviewQuery,
libs/impeller2/wkt/src/msgs.rs:549-590).  Vectorized numpy implementation
of Steinarsson's algorithm: first/last points kept, interior points chosen
to maximize the triangle area against the previous pick and the next
bucket's centroid.

A host-only copy of ``elodin_tpu/db/downsample.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def lttb(t: np.ndarray, v: np.ndarray, max_points: int) -> np.ndarray:
    """Indices of the selected points (sorted ascending)."""
    n = len(t)
    if max_points >= n or max_points < 3:
        if max_points >= n:
            return np.arange(n)
        if max_points <= 0:
            return np.zeros(0, dtype=np.int64)
        # honor budgets of 1 (the LATEST point — the most informative
        # single sample for a live sparkline; plotline's samplers keep the
        # FIRST instead) and 2 (endpoints), rather than returning extras
        if max_points == 1:
            return np.array([n - 1], dtype=np.int64)
        return np.unique(
            np.linspace(0, n - 1, max_points).astype(np.int64)
        )
    t = np.asarray(t, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    # bucket edges over the interior points [1, n-1)
    edges = np.linspace(1, n - 1, max_points - 1).astype(np.int64)
    out = np.empty(max_points, dtype=np.int64)
    out[0] = 0
    prev = 0
    for i in range(max_points - 2):
        lo, hi = edges[i], max(edges[i + 1], edges[i] + 1)
        nlo, nhi = hi, (n if i == max_points - 3 else max(edges[i + 2], hi + 1))
        cx = t[nlo:nhi].mean() if nhi > nlo else t[-1]
        cy = v[nlo:nhi].mean() if nhi > nlo else v[-1]
        ts, vs = t[lo:hi], v[lo:hi]
        area = np.abs(
            (t[prev] - cx) * (vs - v[prev]) - (t[prev] - ts) * (cy - v[prev])
        )
        prev = lo + int(np.argmax(area))
        out[i + 1] = prev
    out[-1] = n - 1
    return out
