"""Curvature-weighted polyline downsampling for plots and 3D trails
(parity: libs/hamann-chen-line/src/lib.rs — select_polyline2_indices,
select_time_value_indices, select_polyline3_indices,
select_trajectory_time_norm_indices).

Implements the Hamann–Chen data-reduction scheme: estimate a discrete
curvature at every interior vertex, integrate it along the polyline, and pick
the vertex nearest each uniform level of the cumulative curvature measure.
High-curvature regions therefore receive proportionally more of the vertex
budget; straight runs collapse to their endpoints.  When the curve is
(numerically) straight everywhere the selection degenerates, so we fall back
to uniform index spacing — matching the reference's documented fallback
(lib.rs:303-311).

Vectorized numpy throughout; no JAX dependency (this is host-side plotting
support, the editor/plot consumer of the reference).

A host-only copy of ``elodin_tpu/plotline.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


def _vertex_curvature_2d(pts: np.ndarray) -> np.ndarray:
    """Discrete curvature per vertex of an (n, 2) polyline.

    Interior vertices use the circumcircle curvature of the local triangle
    (p_{i-1}, p_i, p_{i+1}): k = 4 * area / (|a| |b| |c|); endpoints get 0
    (the reference's planar-triangle sampler, lib.rs:51-110).
    """
    n = len(pts)
    k = np.zeros(n)
    if n < 3:
        return k
    p0, p1, p2 = pts[:-2], pts[1:-1], pts[2:]
    a = p1 - p0
    b = p2 - p1
    c = p2 - p0
    cross = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    la = np.linalg.norm(a, axis=1)
    lb = np.linalg.norm(b, axis=1)
    lc = np.linalg.norm(c, axis=1)
    denom = la * lb * lc
    k[1:-1] = np.where(denom > _EPS, 2.0 * np.abs(cross) / np.maximum(denom, _EPS), 0.0)
    return k


def _vertex_curvature_3d(pts: np.ndarray) -> np.ndarray:
    """Per-vertex curvature of an (n, 3) polyline via the local planar
    triangle at each interior vertex (lib.rs:112)."""
    n = len(pts)
    k = np.zeros(n)
    if n < 3:
        return k
    p0, p1, p2 = pts[:-2], pts[1:-1], pts[2:]
    a = p1 - p0
    b = p2 - p1
    c = p2 - p0
    cross = np.cross(a, b)
    area2 = np.linalg.norm(cross, axis=1)  # = 2 * triangle area
    la = np.linalg.norm(a, axis=1)
    lb = np.linalg.norm(b, axis=1)
    lc = np.linalg.norm(c, axis=1)
    denom = la * lb * lc
    k[1:-1] = np.where(denom > _EPS, 2.0 * area2 / np.maximum(denom, _EPS), 0.0)
    return k


def _dedup(pts: np.ndarray) -> np.ndarray:
    """Indices of vertices that differ from their predecessor (the reference
    dedups coincident points before sampling)."""
    if len(pts) == 0:
        return np.zeros(0, dtype=np.int64)
    keep = np.ones(len(pts), dtype=bool)
    keep[1:] = np.any(np.abs(np.diff(pts, axis=0)) > _EPS, axis=1)
    return np.nonzero(keep)[0]


def _uniform_indices(n: int, m: int) -> np.ndarray:
    if m >= n:
        return np.arange(n, dtype=np.int64)
    return np.unique(np.round(np.linspace(0, n - 1, m)).astype(np.int64))


def _select_by_curvature(pts: np.ndarray, curv: np.ndarray, m: int) -> np.ndarray:
    """Core sampler: pick vertices at uniform levels of the cumulative
    curvature-arc measure; endpoints always kept."""
    n = len(pts)
    if m >= n:
        return np.arange(n, dtype=np.int64)
    if m <= 2:
        return np.array([0, n - 1][: max(m, 1)], dtype=np.int64)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    # measure per segment: average endpoint curvature times length, with a
    # small arc-length floor so the sampler is defined on straight spans too
    seg_curv = 0.5 * (curv[:-1] + curv[1:])
    total_curv = float(np.sum(seg_curv * seg))
    total_len = float(np.sum(seg))
    if total_curv <= _EPS or total_len <= _EPS:
        return _uniform_indices(n, m)
    # equal blend of curvature measure and arc length: curvature alone
    # starves near-straight spans (zero crossings of a sine) while pure arc
    # length ignores corners; the 50/50 mix keeps both reconstruction error
    # and feature retention below uniform sampling
    w = 0.5 * (seg_curv * seg / total_curv) + 0.5 * (seg / total_len)
    cum = np.concatenate([[0.0], np.cumsum(w)])
    cum /= cum[-1]
    levels = np.linspace(0.0, 1.0, m)
    idx = np.searchsorted(cum, levels, side="left")
    idx = np.clip(idx, 0, n - 1)
    idx[0] = 0
    idx[-1] = n - 1
    return np.unique(idx.astype(np.int64))


def select_polyline2_indices(points, m: int) -> np.ndarray:
    """Downsample a planar polyline to ~``m`` vertices; returns sorted
    original indices with endpoints kept (lib.rs:311)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    if len(pts) == 0 or m <= 0:
        return np.zeros(0, dtype=np.int64)
    live = _dedup(pts)
    sub = pts[live]
    curv = _vertex_curvature_2d(sub)
    sel = _select_by_curvature(sub, curv, m)
    return live[sel]


def select_time_value_indices(times, values, m: int) -> np.ndarray:
    """Telemetry-graph variant: polyline is ``(t_i, y_i)`` (lib.rs:323).
    Axes are normalized to comparable scale before curvature is measured so
    the result is invariant to units."""
    t = np.asarray(times, dtype=np.float64).reshape(-1)
    y = np.asarray(values, dtype=np.float64).reshape(-1)
    n = min(len(t), len(y))
    t, y = t[:n], y[:n]
    if n == 0 or m <= 0:
        return np.zeros(0, dtype=np.int64)

    def _norm(a):
        # nan-aware: one NaN sample made span NaN, flattening the whole
        # axis to zeros and silently discarding every curve feature
        lo, hi = np.nanmin(a), np.nanmax(a)
        span = hi - lo
        if not np.isfinite(span) or span <= _EPS:
            return np.zeros_like(a)
        return np.nan_to_num((a - lo) / span, nan=0.0)

    return select_polyline2_indices(np.stack([_norm(t), _norm(y)], axis=1), m)


def select_polyline3_indices(points, m: int) -> np.ndarray:
    """3D flight-path variant: local planar curvature at each vertex, same
    integrated-curvature sampler (lib.rs:339)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    if len(pts) == 0 or m <= 0:
        return np.zeros(0, dtype=np.int64)
    live = _dedup(pts)
    sub = pts[live]
    curv = _vertex_curvature_3d(sub)
    sel = _select_by_curvature(sub, curv, m)
    return live[sel]


def select_trajectory_time_norm_indices(times, pos, m: int) -> np.ndarray:
    """Joint x/y/z reduction via the reduced curve ``(t_i, |p_i|)`` — one
    shared index list for three synchronized streams (lib.rs:351)."""
    p = np.asarray(pos, dtype=np.float64).reshape(-1, 3)
    return select_time_value_indices(times, np.linalg.norm(p, axis=1), m)


# legacy alias (lib.rs:364)
select_point_indices = select_polyline2_indices
