"""Barrowman aerodynamic prediction (a copy of
``examples/rocket-barrowman/barrowman.py``, pure ``math``; it implements the
published Barrowman (1966/67) equations directly).

All normal-force-coefficient slopes ``CNa`` are per radian, referenced to the
body base area; positions are measured from the nose tip in meters.  The
composite center of pressure is the CNa-weighted mean — valid for small
angles of attack, which is exactly the regime a passively-stable rocket
flies in.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class NoseCone:
    length: float
    shape: str = "ogive"  # ogive | conical | parabolic

    # Barrowman (1966): every slender nose has CNa = 2 (eq. 12); only the
    # center of pressure depends on the profile.
    def cna(self) -> float:
        return 2.0

    def xcp(self) -> float:
        frac = {"conical": 2.0 / 3.0, "ogive": 0.466, "parabolic": 0.5}[self.shape]
        return frac * self.length


@dataclass
class Transition:
    """Conical diameter change (boattail when d2 < d1)."""

    position: float  # nose-tip distance to transition start
    length: float
    d1: float  # fore diameter
    d2: float  # aft diameter
    d_ref: float  # reference (base) diameter

    def cna(self) -> float:
        return 2.0 * ((self.d2 / self.d_ref) ** 2 - (self.d1 / self.d_ref) ** 2)

    def xcp(self) -> float:
        r = self.d1 / self.d2
        return self.position + (self.length / 3.0) * (
            1.0 + (1.0 - r) / (1.0 - r * r)
        )


@dataclass
class FinSet:
    """N trapezoidal fins on a body of radius ``body_radius``."""

    position: float  # nose-tip distance to fin root leading edge
    n: int
    root_chord: float
    tip_chord: float
    span: float  # semi-span (one fin, root to tip)
    sweep: float  # root LE -> tip LE axial distance
    body_radius: float
    d_ref: float

    def cna(self) -> float:
        cr, ct, s = self.root_chord, self.tip_chord, self.span
        # mid-chord line length (Barrowman 1967)
        l_mid = math.hypot(s, self.sweep + ct / 2.0 - cr / 2.0)
        bare = (4.0 * self.n * (s / self.d_ref) ** 2) / (
            1.0 + math.sqrt(1.0 + (2.0 * l_mid / (cr + ct)) ** 2)
        )
        # body-interference factor
        kfb = 1.0 + self.body_radius / (s + self.body_radius)
        return kfb * bare

    def xcp(self) -> float:
        cr, ct = self.root_chord, self.tip_chord
        xr = self.sweep
        return (
            self.position
            + (xr / 3.0) * (cr + 2.0 * ct) / (cr + ct)
            + (1.0 / 6.0) * (cr + ct - cr * ct / (cr + ct))
        )


@dataclass
class Aero:
    cna: float  # total normal-force slope (per rad, base-area ref)
    xcp: float  # composite center of pressure from nose tip (m)
    parts: dict


def solve(components) -> Aero:
    """CNa-weighted composite center of pressure (Barrowman 1966 eq. 2)."""
    total = 0.0
    moment = 0.0
    parts = {}
    for c in components:
        cna = c.cna()
        xcp = c.xcp()
        total += cna
        moment += cna * xcp
        parts[type(c).__name__.lower() + f"@{c.xcp():.3f}"] = cna
    if total <= 0.0:
        raise ValueError("unstable configuration: non-positive total CNa")
    return Aero(cna=total, xcp=moment / total, parts=parts)


def static_margin(aero: Aero, xcg: float, d_ref: float) -> float:
    """Stability margin in calibers: (Xcp - Xcg) / d."""
    return (aero.xcp - xcg) / d_ref


def calisto() -> tuple[list, float, float]:
    """Calisto-class test rocket (127 mm body, 0.559 m ogive nose, ~2.1 m
    long, 4 trapezoidal fins at the aft end, small boattail).
    Returns (components, d_ref, xcg)."""
    d = 0.127
    nose = NoseCone(length=0.559, shape="ogive")
    fins = FinSet(
        position=1.850, n=4, root_chord=0.120, tip_chord=0.060,
        span=0.110, sweep=0.060, body_radius=d / 2.0, d_ref=d,
    )
    tail = Transition(position=1.970, length=0.060, d1=d, d2=0.0435 * 2, d_ref=d)
    xcg = 1.10  # loaded CG forward of the fins
    return [nose, fins, tail], d, xcg
