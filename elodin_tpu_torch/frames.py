"""Earth frames in the port (counterpart of ``elodin_tpu/frames.py``).

The NED rotations and WGS-84 geodetic <-> ECEF are torch: each accepts
numpy arrays, Python numbers or tensors (batched over leading axes) and
returns f64 tensors, on the device of a tensor argument.

Time and the celestial frames are host numpy, copied from the JAX package,
where they are host numpy too: ``Epoch`` (a UTC Julian date split in two),
``IERS`` (dUT1, polar motion and celestial-pole offsets read from a
user-supplied ``finals2000A.data``, ``ELODIN_IERS_PATH``; all zero without
one), the Earth rotation angle, the truncated IAU 2006/2000A CIO series,
``eci_to_ecef`` / ``ecef_to_eci`` (GCRF <-> ITRF as a 3x3 ``np.ndarray``
for one epoch) and ``sun_vec``.  They return what the JAX package's functions
return, bit for bit.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

_WGS84_A = 6378137.0
_WGS84_E2 = 6.69437999014e-3


def _f64(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _prime_vertical(lat: torch.Tensor) -> torch.Tensor:
    """The prime vertical radius N(lat).  ``A / t`` of a Python number
    ``A`` is ``t.reciprocal() * A`` in torch, one rounding more than JAX's
    division: the numerator is a tensor here."""
    return torch.full_like(lat, _WGS84_A) / torch.sqrt(1.0 - _WGS84_E2 * torch.sin(lat) ** 2)


def _device(*xs):
    return next((x.device for x in xs if isinstance(x, torch.Tensor)), None)


def ecef_to_ned(lat, long) -> torch.Tensor:
    """ECEF -> NED direction cosine matrix at geodetic ``lat``, ``long``
    (radians); batched over leading axes."""
    device = _device(lat, long)
    lat, long = _f64(lat, device), _f64(long, device)
    sl, cl = torch.sin(lat), torch.cos(lat)
    so, co = torch.sin(long), torch.cos(long)
    row0 = torch.stack([-sl * co, -sl * so, cl], dim=-1)
    row1 = torch.stack([-so, co, torch.zeros_like(so)], dim=-1)
    row2 = torch.stack([-cl * co, -cl * so, -sl], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def ned_to_ecef(lat, long) -> torch.Tensor:
    return ecef_to_ned(lat, long).transpose(-1, -2)


def geodetic_to_ecef(lat, long, alt) -> torch.Tensor:
    device = _device(lat, long, alt)
    lat, long, alt = _f64(lat, device), _f64(long, device), _f64(alt, device)
    n = _prime_vertical(lat)
    x = (n + alt) * torch.cos(lat) * torch.cos(long)
    y = (n + alt) * torch.cos(lat) * torch.sin(long)
    z = (n * (1.0 - _WGS84_E2) + alt) * torch.sin(lat)
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def ecef_to_geodetic(r, iterations: int = 5):
    """(lat, long, alt) by Bowring's iteration, a fixed number of times."""
    r = _f64(r)
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    long = torch.atan2(y, x)
    p = torch.sqrt(x * x + y * y)
    lat = torch.atan2(z, p * (1.0 - _WGS84_E2))
    for _ in range(iterations):
        n = _prime_vertical(lat)
        alt = p / torch.cos(lat) - n
        lat = torch.atan2(z, p * (1.0 - _WGS84_E2 * n / (n + alt)))
    n = _prime_vertical(lat)
    alt = p / torch.cos(lat) - n
    return lat, long, alt



ARCSEC = np.pi / (180.0 * 3600.0)
MJD_OFFSET = 2400000.5
_LEAP_SECONDS = 37.0  # TAI-UTC since 2017-01-01 (valid through the 2020s)
TT_MINUS_UTC = _LEAP_SECONDS + 32.184


# ---------------------------------------------------------------------------
# Time
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Epoch:
    """UTC epoch as a Julian date split for precision (hifitime-Epoch-like)."""

    jd1: float  # integer-ish part
    jd2: float  # fraction

    @staticmethod
    def from_gregorian_utc(year, month, day, hour=0, minute=0, second=0,
                           nanos=0) -> "Epoch":
        # Fliegel-Van Flandern day number
        a = (14 - month) // 12
        y = year + 4800 - a
        m = month + 12 * a - 3
        jdn = day + (153 * m + 2) // 5 + 365 * y + y // 4 - y // 100 + y // 400 - 32045
        frac = (hour - 12) / 24.0 + minute / 1440.0 + (second + nanos * 1e-9) / 86400.0
        return Epoch(float(jdn), frac)

    @staticmethod
    def from_unix_seconds(ts: float) -> "Epoch":
        return Epoch(2440587.5, ts / 86400.0)

    def to_jd_utc(self) -> float:
        return self.jd1 + self.jd2

    def to_mjd_utc_days(self) -> float:
        return (self.jd1 - MJD_OFFSET) + self.jd2

    def to_mjd_tt_days(self) -> float:
        return self.to_mjd_utc_days() + TT_MINUS_UTC / 86400.0

    def to_tt_centuries_since_j2000(self) -> float:
        return ((self.jd1 - 2451545.0) + self.jd2 + TT_MINUS_UTC / 86400.0) / 36525.0

    # TDB ~= TT for frame purposes (difference < 2 ms)
    to_tdb_centuries_since_j2000 = to_tt_centuries_since_j2000

    def __add__(self, seconds: float) -> "Epoch":
        return Epoch(self.jd1, self.jd2 + seconds / 86400.0)


# ---------------------------------------------------------------------------
# IERS Earth-orientation data (finals2000A format)
# ---------------------------------------------------------------------------


class IERS:
    """dUT1/polar-motion table (parity: libs/nox-frames/src/iers.rs).

    Reads the standard IERS ``finals2000A.data`` fixed-width format from a
    user-provided path; without data all corrections are zero."""

    _global = None

    def __init__(self, path: str | None = None):
        self.mjd = np.zeros(0)
        self.pm_x = np.zeros(0)
        self.pm_y = np.zeros(0)
        self.dut1 = np.zeros(0)
        self.dx = np.zeros(0)
        self.dy = np.zeros(0)
        if path and os.path.isfile(path):
            self._load(path)

    def _load(self, path: str) -> None:
        mjd, pmx, pmy, dut1, dx, dy = [], [], [], [], [], []
        with open(path) as f:
            for line in f:
                try:
                    m = float(line[7:15])
                    x = float(line[18:27])
                    y = float(line[37:46])
                    u = float(line[58:68])
                except (ValueError, IndexError):
                    continue
                try:
                    ddx = float(line[97:106]) * 1e-3  # mas -> arcsec
                    ddy = float(line[116:125]) * 1e-3
                except (ValueError, IndexError):
                    ddx = ddy = 0.0
                mjd.append(m)
                pmx.append(x)
                pmy.append(y)
                dut1.append(u)
                dx.append(ddx)
                dy.append(ddy)
        self.mjd = np.asarray(mjd)
        self.pm_x = np.asarray(pmx)
        self.pm_y = np.asarray(pmy)
        self.dut1 = np.asarray(dut1)
        self.dx = np.asarray(dx)
        self.dy = np.asarray(dy)

    @classmethod
    def global_(cls) -> "IERS":
        if cls._global is None:
            cls._global = IERS(os.environ.get("ELODIN_IERS_PATH"))
        return cls._global

    def _interp(self, table: np.ndarray, mjd: float) -> float:
        if len(self.mjd) == 0:
            return 0.0
        return float(np.interp(mjd, self.mjd, table))

    def get_ut1_utc(self, mjd_utc: float) -> float:
        return self._interp(self.dut1, mjd_utc)

    def get_pm(self, mjd_utc: float) -> tuple[float, float]:
        return (
            self._interp(self.pm_x, mjd_utc) * ARCSEC,
            self._interp(self.pm_y, mjd_utc) * ARCSEC,
        )

    def get_nutation(self, mjd_utc: float) -> tuple[float, float]:
        return (
            self._interp(self.dx, mjd_utc) * ARCSEC,
            self._interp(self.dy, mjd_utc) * ARCSEC,
        )


# ---------------------------------------------------------------------------
# Rotation pieces
# ---------------------------------------------------------------------------


def _rz(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])


def earth_rotation_angle(jd_ut1: float) -> float:
    """IAU 2000 ERA (exact expression; same as SOFA iauEra00)."""
    t = jd_ut1 - 2451545.0
    f = jd_ut1 % 1.0
    era = 2.0 * np.pi * (f + 0.7790572732640 + 0.00273781191135448 * t)
    return era % (2.0 * np.pi)


# Delaunay fundamental arguments (IERS 2010, arcsec polynomials in TT
# centuries) -> radians
def _fundamental_args(t: float):
    def poly(c0, c1, c2=0.0, c3=0.0, c4=0.0):
        return ((c0 + c1 * t + c2 * t**2 + c3 * t**3 + c4 * t**4) * ARCSEC) % (
            2 * np.pi
        )

    l = poly(485868.249036, 1717915923.2178, 31.8792, 0.051635, -0.00024470)
    lp = poly(1287104.79305, 129596581.0481, -0.5532, 0.000136, -0.00001149)
    f = poly(335779.526232, 1739527262.8478, -12.7512, -0.001037, 0.00000417)
    d = poly(1072260.70369, 1602961601.2090, -6.3706, 0.006593, -0.00003169)
    om = poly(450160.398036, -6962890.5431, 7.4722, 0.007702, -0.00005939)
    return l, lp, f, d, om


# Dominant periodic terms of the IAU 2006/2000A X/Y series.
#
# TRUNCATION, quantified: the full series (IERS Conventions 2010 tables
# 5.2a/5.2b) has 1306/962 terms; the 10 largest per axis are kept.  The
# summed amplitude of omitted terms is ~10 mas in X and ~7 mas in Y, of
# which the IERS dX/dY celestial-pole offsets (applied on top, see
# bias_precession_nutation) absorb the slowly-varying part; the residual
# short-period error is a few mas, i.e. ~0.1-0.5 m of Earth-fixed position
# for LEO — asserted by the <1 m ECI->ECEF golden in
# tests/test_frames_wmm.py.  Upgrading to cm-level means ingesting the
# full tab5.2a/b term files; the evaluation loop below already handles
# arbitrary term counts.
#
# Columns: (l, l', F, D, Om) multipliers, sin coeff, cos coeff  [microarcsec]
_X_TERMS = [
    ((0, 0, 0, 0, 1), -6844318.44, 1328.67),
    ((0, 0, 2, -2, 2), -523908.04, -544.76),
    ((0, 0, 2, 0, 2), -90552.22, 111.23),
    ((0, 0, 0, 0, 2), 82168.76, -27.64),
    ((0, 1, 0, 0, 0), 58707.02, 470.05),
    ((0, 1, 2, -2, 2), -20558.16, -20.84),
    ((1, 0, 0, 0, 0), 28288.28, -34.69),
    ((0, 0, 2, 0, 1), -15407.43, 11.01),
    ((1, 0, 2, 0, 2), -11727.41, 8.61),
    ((0, 1, -2, 2, -2), -4774.69, -0.21),
]
_Y_TERMS = [
    ((0, 0, 0, 0, 1), 1538.18, 9205236.26),
    ((0, 0, 2, -2, 2), -458.66, 573033.42),
    ((0, 0, 2, 0, 2), 137.41, 97846.69),
    ((0, 0, 0, 0, 2), -29.05, -89618.24),
    ((0, 1, 0, 0, 0), -17.40, 22438.42),
    ((0, 1, 2, -2, 2), 31.80, -22647.72),
    ((1, 0, 0, 0, 0), 32.61, 1727.95),
    ((0, 0, 2, 0, 1), -1.30, 20069.50),
    ((1, 0, 2, 0, 2), -0.88, 12902.66),
    ((0, 1, -2, 2, -2), 0.64, -8585.15),
]


def cio_xys(t: float) -> tuple[float, float, float]:
    """CIP coordinates X, Y and CIO locator s (radians), truncated
    IAU 2006/2000A series (SOFA iauXys06a equivalent to ~mas)."""
    uas = 1e-6 * ARCSEC
    x = (
        -16617.0 + 2004191898.0 * t - 429782.9 * t**2 - 198618.34 * t**3
        + 7.578 * t**4 + 5.9285 * t**5
    )
    y = (
        -6951.0 - 25896.0 * t - 22407274.7 * t**2 + 1900.59 * t**3
        + 1112.526 * t**4 + 0.1358 * t**5
    )
    args = _fundamental_args(t)

    def arg(mult):
        return sum(m * a for m, a in zip(mult, args))

    for mult, s_c, c_c in _X_TERMS:
        a = arg(mult)
        x += s_c * np.sin(a) + c_c * np.cos(a)
    for mult, s_c, c_c in _Y_TERMS:
        a = arg(mult)
        y += s_c * np.sin(a) + c_c * np.cos(a)
    x *= uas
    y *= uas
    # s + XY/2 polynomial + dominant Om term
    _, _, _, _, om = args
    s = (
        (94.0 + 3808.65 * t - 122.68 * t**2 - 72574.11 * t**3) * uas
        + (-2640.73 * np.sin(om)) * uas
        - x * y / 2.0
    )
    return x, y, s


def c2i_from_xys(x: float, y: float, s: float) -> np.ndarray:
    """Celestial-to-intermediate matrix from CIP + s (SOFA iauC2ixys)."""
    r2 = x * x + y * y
    e = np.arctan2(y, x) if r2 > 0 else 0.0
    d = np.arctan(np.sqrt(r2 / (1.0 - r2)))
    return _rz(-(e + s)) @ _ry(d) @ _rz(e)


def _ry(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]])


def _rx(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, s], [0.0, -s, c]])


def bias_precession_nutation(epoch: Epoch, iers: IERS | None = None) -> np.ndarray:
    """GCRF -> CIRS (earth.rs:56-71)."""
    iers = iers or IERS.global_()
    t = epoch.to_tt_centuries_since_j2000()
    x, y, s = cio_xys(t)
    dx, dy = iers.get_nutation(epoch.to_mjd_utc_days())
    return c2i_from_xys(x + dx, y + dy, s)


def earth_rotation(epoch: Epoch, iers: IERS | None = None) -> np.ndarray:
    """CIRS -> TIRS: R_z(ERA) (earth.rs:35-41)."""
    iers = iers or IERS.global_()
    dut1 = iers.get_ut1_utc(epoch.to_mjd_utc_days())
    jd_ut1 = epoch.to_jd_utc() + dut1 / 86400.0
    return _rz(earth_rotation_angle(jd_ut1))


def polar_motion(epoch: Epoch, iers: IERS | None = None) -> np.ndarray:
    """TIRS -> ITRF (earth.rs:43-53)."""
    iers = iers or IERS.global_()
    pm_x, pm_y = iers.get_pm(epoch.to_mjd_utc_days())
    t = epoch.to_tt_centuries_since_j2000()
    s_prime = -47e-6 * t * ARCSEC
    return _rx(-pm_y) @ _ry(-pm_x) @ _rz(s_prime)


def eci_to_ecef(epoch: Epoch, iers: IERS | None = None) -> np.ndarray:
    """GCRF -> ITRF DCM (earth.rs:73-87)."""
    return (
        polar_motion(epoch, iers)
        @ earth_rotation(epoch, iers)
        @ bias_precession_nutation(epoch, iers)
    )


def ecef_to_eci(epoch: Epoch, iers: IERS | None = None) -> np.ndarray:
    return eci_to_ecef(epoch, iers).T


def sun_vec(epoch: Epoch) -> np.ndarray:
    """Unit vector to the sun in ECI (earth.rs:118-137, Vallado)."""
    t = epoch.to_tdb_centuries_since_j2000()
    mean_long = 280.4606184 + 36000.77005361 * t
    mean_anom = np.radians(357.5277233 + 35999.05034 * t)
    ecl_long = np.radians(
        # equation of center, Vallado low-precision sun: the sin(2M)
        # coefficient is 0.019994643 deg (a 0.9 here inflates the term
        # ~46x -> ~1 deg pointing error away from perihelion/aphelion)
        mean_long + 1.914666471 * np.sin(mean_anom) + 0.019994643 * np.sin(2 * mean_anom)
    )
    obliquity = np.radians(23.43929 - (46.8093 / 3600.0) * t)
    x = np.cos(ecl_long)
    y = np.cos(obliquity) * np.sin(ecl_long)
    z = np.sin(obliquity) * np.sin(ecl_long)
    v = np.array([x, y, z])
    return v / np.linalg.norm(v)
