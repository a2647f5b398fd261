"""World Magnetic Model (WMM2020) geomagnetic field in torch (counterpart
of ``elodin_tpu/wmm.py``): the spherical-harmonic synthesis to degree 12,
batched over leading axes, so the field can be evaluated over a grid or a
constellation in one call on the card.

Inputs follow ``frames``: numpy arrays, Python numbers or tensors, made f64
tensors on the device of a tensor argument.  The coefficient tables are
host numpy, built at import as the JAX package builds them, and moved to a
device once, the first time it is used (``_tables``), never per call.  One
call issues about a thousand eager ops whatever its width, most of them in
the Legendre recursion's double loop.

Coefficient data: the published NOAA WMM2020 main-field and secular-variation
Gauss coefficients (epoch 2020.0, degree 12), public-domain geophysical
constants from the official WMM2020.COF distribution.
"""

from __future__ import annotations

import math
from math import factorial
from typing import NamedTuple

import numpy as np
import torch

from .frames import _device, _f64, ecef_to_geodetic, geodetic_to_ecef  # noqa: F401 (re-export convenience)

WMM_EPOCH = 2020.0
N_MAX = 12

# (n, m, g, h, dg/dt, dh/dt) in nT, nT/year — NOAA WMM2020
_WMM2020 = np.array([
    [1, 0, -29404.5, 0.0, 6.7, 0.0],
    [1, 1, -1450.7, 4652.9, 7.7, -25.1],
    [2, 0, -2500.0, 0.0, -11.5, 0.0],
    [2, 1, 2982.0, -2991.6, -7.1, -30.2],
    [2, 2, 1676.8, -734.8, -2.2, -23.9],
    [3, 0, 1363.9, 0.0, 2.8, 0.0],
    [3, 1, -2381.0, -82.2, -6.2, 5.7],
    [3, 2, 1236.2, 241.8, 3.4, -1.0],
    [3, 3, 525.7, -542.9, -12.2, 1.1],
    [4, 0, 903.1, 0.0, -1.1, 0.0],
    [4, 1, 809.4, 282.0, -1.6, 0.2],
    [4, 2, 86.2, -158.4, -6.0, 6.9],
    [4, 3, -309.4, 199.8, 5.4, 3.7],
    [4, 4, 47.9, -350.1, -5.5, -5.6],
    [5, 0, -234.4, 0.0, -0.3, 0.0],
    [5, 1, 363.1, 47.7, 0.6, 0.1],
    [5, 2, 187.8, 208.4, -0.7, 2.5],
    [5, 3, -140.7, -121.3, 0.1, -0.9],
    [5, 4, -151.2, 32.2, 1.2, 3.0],
    [5, 5, 13.7, 99.1, 1.0, 0.5],
    [6, 0, 65.9, 0.0, -0.6, 0.0],
    [6, 1, 65.6, -19.1, -0.4, 0.1],
    [6, 2, 73.0, 25.0, 0.5, -1.8],
    [6, 3, -121.5, 52.7, 1.4, -1.4],
    [6, 4, -36.2, -64.4, -1.4, 0.9],
    [6, 5, 13.5, 9.0, 0.0, 0.1],
    [6, 6, -64.7, 68.1, 0.8, 1.0],
    [7, 0, 80.6, 0.0, -0.1, 0.0],
    [7, 1, -76.8, -51.4, -0.3, 0.5],
    [7, 2, -8.3, -16.8, -0.1, 0.6],
    [7, 3, 56.5, 2.3, 0.7, -0.7],
    [7, 4, 15.8, 23.5, 0.2, -0.2],
    [7, 5, 6.4, -2.2, -0.5, -1.2],
    [7, 6, -7.2, -27.2, -0.8, 0.2],
    [7, 7, 9.8, -1.9, 1.0, 0.3],
    [8, 0, 23.6, 0.0, -0.1, 0.0],
    [8, 1, 9.8, 8.4, 0.1, -0.3],
    [8, 2, -17.5, -15.3, -0.1, 0.7],
    [8, 3, -0.4, 12.8, 0.5, -0.2],
    [8, 4, -21.1, -11.8, -0.1, 0.5],
    [8, 5, 15.3, 14.9, 0.4, -0.3],
    [8, 6, 13.7, 3.6, 0.5, -0.5],
    [8, 7, -16.5, -6.9, 0.0, 0.4],
    [8, 8, -0.3, 2.8, 0.4, 0.1],
    [9, 0, 5.0, 0.0, -0.1, 0.0],
    [9, 1, 8.2, -23.3, -0.2, -0.3],
    [9, 2, 2.9, 11.1, 0.0, 0.2],
    [9, 3, -1.4, 9.8, 0.4, -0.4],
    [9, 4, -1.1, -5.1, -0.3, 0.4],
    [9, 5, -13.3, -6.2, 0.0, 0.1],
    [9, 6, 1.1, 7.8, 0.3, 0.0],
    [9, 7, 8.9, 0.4, 0.0, -0.2],
    [9, 8, -9.3, -1.5, 0.0, 0.5],
    [9, 9, -11.9, 9.7, -0.4, 0.2],
    [10, 0, -1.9, 0.0, 0.0, 0.0],
    [10, 1, -6.2, 3.4, 0.0, 0.0],
    [10, 2, -0.1, -0.2, 0.0, 0.1],
    [10, 3, 1.7, 3.5, 0.2, -0.3],
    [10, 4, -0.9, 4.8, -0.1, 0.1],
    [10, 5, 0.6, -8.6, -0.2, -0.2],
    [10, 6, -0.9, -0.1, 0.0, 0.1],
    [10, 7, 1.9, -4.2, -0.1, 0.0],
    [10, 8, 1.4, -3.4, -0.2, -0.1],
    [10, 9, -2.4, -0.1, -0.1, 0.2],
    [10, 10, -3.9, -8.8, 0.0, 0.0],
    [11, 0, 3.0, 0.0, 0.0, 0.0],
    [11, 1, -1.4, 0.0, -0.1, 0.0],
    [11, 2, -2.5, 2.6, 0.0, 0.1],
    [11, 3, 2.4, -0.5, 0.0, 0.0],
    [11, 4, -0.9, -0.4, 0.0, 0.2],
    [11, 5, 0.3, 0.6, -0.1, 0.0],
    [11, 6, -0.7, -0.2, 0.0, 0.0],
    [11, 7, -0.1, -1.7, 0.0, 0.1],
    [11, 8, 1.4, -1.6, -0.1, 0.0],
    [11, 9, -0.6, -3.0, -0.1, -0.1],
    [11, 10, 0.2, -2.0, -0.1, 0.0],
    [11, 11, 3.1, -2.6, -0.1, 0.0],
    [12, 0, -2.0, 0.0, 0.0, 0.0],
    [12, 1, -0.1, -1.2, 0.0, 0.0],
    [12, 2, 0.5, 0.5, 0.0, 0.0],
    [12, 3, 1.3, 1.3, 0.0, -0.1],
    [12, 4, -1.2, -1.8, 0.0, 0.1],
    [12, 5, 0.7, 0.1, 0.0, 0.0],
    [12, 6, 0.3, 0.7, 0.0, 0.0],
    [12, 7, 0.5, -0.1, 0.0, 0.0],
    [12, 8, -0.2, 0.6, 0.0, 0.1],
    [12, 9, -0.5, 0.2, 0.0, 0.0],
    [12, 10, 0.1, -0.9, 0.0, 0.0],
    [12, 11, -1.1, 0.0, 0.0, 0.0],
    [12, 12, -0.3, 0.5, -0.1, -0.1],
])

_RE_GEOMAG = 6371200.0  # geomagnetic reference radius, m


def _build_tables():
    n = N_MAX
    g = np.zeros((n + 1, n + 1))
    h = np.zeros((n + 1, n + 1))
    dg = np.zeros((n + 1, n + 1))
    dh = np.zeros((n + 1, n + 1))
    for row in _WMM2020:
        ni, mi = int(row[0]), int(row[1])
        g[ni, mi], h[ni, mi], dg[ni, mi], dh[ni, mi] = row[2], row[3], row[4], row[5]
    # Schmidt semi-normalization factors S(n,m)
    s = np.zeros((n + 1, n + 1))
    for ni in range(n + 1):
        for mi in range(ni + 1):
            num = 1.0
            if mi > 0:
                num = np.sqrt(2.0 * factorial(ni - mi) / factorial(ni + mi))
            s[ni, mi] = num
    return g, h, dg, dh, s


_G, _H, _DG, _DH, _SCHMIDT = _build_tables()


class _Tables(NamedTuple):
    g: torch.Tensor
    h: torch.Tensor
    dg: torch.Tensor
    dh: torch.Tensor
    schmidt: torch.Tensor
    idx: torch.Tensor  # 0..N_MAX, the degree n and the order m
    n_plus_1: torch.Tensor  # (N_MAX + 1, 1)
    n_plus_2: torch.Tensor


_ON_DEVICE: dict[torch.device, _Tables] = {}


def _tables(device: torch.device) -> _Tables:
    """The tables as f64 tensors on ``device``, copied there once."""
    hit = _ON_DEVICE.get(device)
    if hit is None:
        idx = np.arange(N_MAX + 1, dtype=np.float64)
        hit = _ON_DEVICE[device] = _Tables(*(
            torch.as_tensor(a, dtype=torch.float64, device=device)
            for a in (_G, _H, _DG, _DH, _SCHMIDT, idx, (idx + 1)[:, None], idx + 2)))
    return hit


def _legendre_schmidt(x: torch.Tensor, n_max: int):
    """Schmidt semi-normalized associated Legendre P(n,m)(x) and
    dP/dtheta, batched over x; returns (..., n+1, n+1) each."""
    # Ferrers (unnormalized, no Condon-Shortley) associated Legendre with
    # d/dtheta recursions; Schmidt semi-normalization applied at the end.
    # Degree 12 stays well inside f64 range.
    s = torch.sqrt(torch.clamp(1.0 - x * x, 1e-30, 1.0))  # sin(theta)
    zero = torch.zeros_like(x)
    P = [[None] * (n_max + 1) for _ in range(n_max + 1)]
    dP = [[None] * (n_max + 1) for _ in range(n_max + 1)]
    P[0][0] = torch.ones_like(x)
    dP[0][0] = zero
    for n in range(1, n_max + 1):
        # sectorial: P_nn = (2n-1)!! s^n ; dP_nn/dtheta = n x/s * P_nn
        P[n][n] = (2 * n - 1) * s * P[n - 1][n - 1]
        dP[n][n] = (2 * n - 1) * (s * dP[n - 1][n - 1] + x * P[n - 1][n - 1])
        for m in range(n):
            pm1 = P[n - 1][m]
            dpm1 = dP[n - 1][m]
            pm2 = P[n - 2][m] if m <= n - 2 else zero
            dpm2 = dP[n - 2][m] if m <= n - 2 else zero
            P[n][m] = ((2 * n - 1) * x * pm1 - (n + m - 1) * pm2) / (n - m)
            dP[n][m] = (
                (2 * n - 1) * (x * dpm1 - s * pm1) - (n + m - 1) * dpm2
            ) / (n - m)
    Pm = torch.stack(
        [torch.stack([P[n][m] if m <= n else zero for m in range(n_max + 1)], dim=-1)
         for n in range(n_max + 1)],
        dim=-2,
    )
    dPm = torch.stack(
        [torch.stack([dP[n][m] if m <= n else zero for m in range(n_max + 1)], dim=-1)
         for n in range(n_max + 1)],
        dim=-2,
    )
    schmidt = _tables(x.device).schmidt
    return Pm * schmidt, dPm * schmidt


def field_spherical(r, theta, phi, year: float = WMM_EPOCH):
    """Geocentric-spherical field components (B_r, B_theta, B_phi) in nT.

    r in meters, theta = colatitude, phi = longitude (radians)."""
    device = _device(r, theta, phi)
    r, theta, phi = _f64(r, device), _f64(theta, device), _f64(phi, device)
    tb = _tables(r.device)
    dt = year - WMM_EPOCH
    g = tb.g + tb.dg * dt
    h = tb.h + tb.dh * dt

    ct = torch.cos(theta)
    st = torch.sin(theta)
    P, dP = _legendre_schmidt(ct, N_MAX)

    # JAX's _RE_GEOMAG / r: a tensor numerator divides as JAX does
    ar = torch.full_like(r, _RE_GEOMAG) / r
    ar_n = ar[..., None] ** tb.n_plus_2  # (..., n+1)

    cos_m = torch.cos(phi[..., None] * tb.idx)
    sin_m = torch.sin(phi[..., None] * tb.idx)

    gc = g * cos_m[..., None, :] + h * sin_m[..., None, :]
    gs = g * sin_m[..., None, :] - h * cos_m[..., None, :]

    br = torch.sum(ar_n[..., :, None] * tb.n_plus_1 * gc * P, dim=(-2, -1))
    bt = -torch.sum(ar_n[..., :, None] * gc * dP, dim=(-2, -1))
    st_safe = torch.where(torch.abs(st) > 1e-12, st, 1e-12)
    bp = torch.sum(ar_n[..., :, None] * tb.idx * gs * P, dim=(-2, -1)) / st_safe
    return br, bt, bp


def field_ned(lat, long, alt, year: float = WMM_EPOCH) -> torch.Tensor:
    """NED geomagnetic field (nT) at geodetic lat/long (radians), alt (m)
    — the reference's MAG_Geomag equivalent."""
    device = _device(lat, long, alt)
    lat, long = _f64(lat, device), _f64(long, device)
    ecef = geodetic_to_ecef(lat, long, alt)
    r = torch.linalg.vector_norm(ecef, dim=-1)
    theta = torch.arccos(ecef[..., 2] / r)  # geocentric colatitude
    br, bt, bp = field_spherical(r, theta, long, year)
    # spherical -> NED at geocentric latitude, then rotate by (geodetic -
    # geocentric) latitude difference
    lat_gc = math.pi / 2 - theta
    x_gc = -bt  # north (geocentric)
    y = bp  # east
    z_gc = -br  # down (geocentric)
    # rotate from geocentric-vertical to geodetic-vertical NED
    # (GeomagnetismLibrary.c MAG_RotateMagneticVector: psi = gc - gd)
    d = lat_gc - lat
    cd, sd = torch.cos(d), torch.sin(d)
    x = x_gc * cd - z_gc * sd
    z = x_gc * sd + z_gc * cd
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def declination_inclination(lat, long, alt, year: float = WMM_EPOCH):
    """Declination and inclination (degrees) of ``field_ned``."""
    b = field_ned(lat, long, alt, year)
    x, y, z = b.unbind(-1)
    h = torch.sqrt(x * x + y * y)
    # jnp.degrees multiplies by the constant 180 / pi
    dec = torch.atan2(y, x) * (180 / np.pi)
    inc = torch.atan2(z, h) * (180 / np.pi)
    return dec, inc
