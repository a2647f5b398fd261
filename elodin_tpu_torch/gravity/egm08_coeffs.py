"""Vendored EGM2008 normalized spherical-harmonic coefficients (low degree).

A copy of ``elodin_tpu/gravity/egm08_coeffs.py``: that module needs no JAX,
but importing anything under ``elodin_tpu`` imports JAX, so the port keeps
its own.

Provenance: transcribed from the published EGM2008 tide-free coefficient
table (NGA, Pavlis et al. 2012) — the complete field through degree/order 4
plus the zonal terms to degree 8.  These carry the field's dominant
structure: C20 (oblateness) is ~200x the next-largest term, and C22/S22
(the equatorial ellipticity, principal axis at -14.93 deg E) are the
largest tesserals in the entire model.  The golden tests anchor them to
independently-published derived quantities (J2, J3, the equatorial-axis
longitude).

Nothing is downloaded, so the full degree-2190 file is not used unless it
is already at hand; `EGM08` loads `C_normal.npy`/`S_normal.npy` when present
(the reference's cache format, libs/nox-py/python/elodin/egm08.py:16-50).
For high-degree numerics and benchmarking without the file, `kaula_extend`
fills degrees above the vendored set with *synthetic* coefficients following
Kaula's rule (rms ~ 1e-5 / l^2) from a seeded RNG — realistic magnitude
spectrum, explicitly NOT the real field, and off by default.
"""

from __future__ import annotations

import numpy as np

VENDORED_MAX_DEGREE = 8

# (l, m, C_bar, S_bar) — EGM2008 tide-free, fully normalized.
_LOW_DEGREE = [
    (2, 0, -4.84165143790815e-4, 0.0),
    (2, 1, -2.06615509074176e-10, 1.38441389137979e-9),
    (2, 2, 2.43938357328313e-6, -1.40027370385934e-6),
    (3, 0, 9.57161207093473e-7, 0.0),
    (3, 1, 2.03046201047864e-6, 2.48200415856872e-7),
    (3, 2, 9.04787894809528e-7, -6.19005475177618e-7),
    (3, 3, 7.21321757121568e-7, 1.41434926192941e-6),
    (4, 0, 5.39965866638991e-7, 0.0),
    (4, 1, -5.36157389388867e-7, -4.73567346518086e-7),
    (4, 2, 3.50501623962649e-7, 6.62480026275829e-7),
    (4, 3, 9.90856766672321e-7, -2.00928369177143e-7),
    (4, 4, -1.88519633023033e-7, 3.08803882149194e-7),
    # zonals 5..8
    (5, 0, 6.86702913736681e-8, 0.0),
    (6, 0, -1.49953927978527e-7, 0.0),
    (7, 0, 9.05120844521618e-8, 0.0),
    (8, 0, 4.94756003005199e-8, 0.0),
]


def vendored(max_degree: int) -> tuple[np.ndarray, np.ndarray]:
    """(C_bar, S_bar) of shape (L+1, L+1) holding the vendored real terms."""
    n = max_degree + 1
    c = np.zeros((n, n))
    s = np.zeros((n, n))
    c[0, 0] = 1.0
    for l, m, cv, sv in _LOW_DEGREE:
        if l <= max_degree:
            c[l, m] = cv
            s[l, m] = sv
    return c, s


def kaula_extend(
    c: np.ndarray, s: np.ndarray, seed: int = 20080101
) -> tuple[np.ndarray, np.ndarray]:
    """Fill empty degrees above the vendored set with SYNTHETIC coefficients
    following Kaula's rule: per-coefficient rms ~ 1e-5 / l^2.

    Deterministic under `seed`; intended for high-degree recursion numerics
    and benchmarking, never for accuracy claims."""
    rng = np.random.default_rng(seed)
    c, s = c.copy(), s.copy()
    for l in range(VENDORED_MAX_DEGREE + 1, c.shape[0]):
        sigma = 1e-5 / l**2
        c[l, : l + 1] = rng.normal(0.0, sigma, l + 1)
        s[l, 1 : l + 1] = rng.normal(0.0, sigma, l)
    # degrees 5..8: real zonals kept, synthetic tesserals filled in
    for l in range(5, min(VENDORED_MAX_DEGREE, c.shape[0] - 1) + 1):
        sigma = 1e-5 / l**2
        c[l, 1 : l + 1] = rng.normal(0.0, sigma, l)
        s[l, 1 : l + 1] = rng.normal(0.0, sigma, l)
    return c, s
