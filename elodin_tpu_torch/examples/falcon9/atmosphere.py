"""U.S. Standard Atmosphere 1976 in torch (counterpart of
``examples/falcon9/atmosphere.py``): the US76 table to 86 km, isothermal
above.  The layer lookup counts the layer bases at or below the altitude
(``searchsorted`` with ``side='right'``), then gathers the layer's row, so
it runs under ``torch.func.vmap``."""

from __future__ import annotations

import numpy as np
import torch

from .._consts import const, f64

G0 = 9.80665
R_UNIV = 8.31432  # J / (mol K)
M_AIR_KG_MOL = 28.9644e-3
R_AIR = R_UNIV / M_AIR_KG_MOL  # 287.053 J/(kg K)
GAMMA_AIR = 1.4
_BETA = G0 * M_AIR_KG_MOL / R_UNIV  # hydrostatic exponent scale, K/m
EARTH_RADIUS_GP_M = 6_356_766.0
P_SL_PA = 101_325.0

# US76 layer table: geopotential base altitude (m), base temp (K), lapse (K/m).
_LAYERS = np.array(
    [
        [0.0, 288.15, -6.5e-3],
        [11_000.0, 216.65, 0.0],
        [20_000.0, 216.65, 1.0e-3],
        [32_000.0, 228.65, 2.8e-3],
        [47_000.0, 270.65, 0.0],
        [51_000.0, 270.65, -2.8e-3],
        [71_000.0, 214.65, -2.0e-3],
        [84_852.0, 186.946, 0.0],
    ]
)


def _derive_base_pressures(layers: np.ndarray) -> np.ndarray:
    out = [P_SL_PA]
    for k in range(1, len(layers)):
        h0, t0, lam = layers[k - 1]
        span = layers[k, 0] - h0
        if lam == 0.0:
            out.append(out[-1] * float(np.exp(-_BETA * span / t0)))
        else:
            out.append(out[-1] * (t0 / (t0 + lam * span)) ** (_BETA / lam))
    return np.asarray(out)


_BASE_P = _derive_base_pressures(_LAYERS)
_H0 = np.ascontiguousarray(_LAYERS[:, 0])
_T0 = np.ascontiguousarray(_LAYERS[:, 1])
_LAM = np.ascontiguousarray(_LAYERS[:, 2])


def geopotential_altitude(h_m):
    """Geometric -> geopotential altitude."""
    return EARTH_RADIUS_GP_M * h_m / (EARTH_RADIUS_GP_M + h_m)


def pressure_temperature_at_geopotential(h_gp_m):
    """(p [Pa], T [K]) at geopotential altitude; any tensor shape."""
    h = torch.clamp(f64(h_gp_m), 0.0, 250_000.0)
    h0 = const(_H0, h)
    k = torch.clamp((h0 <= h[..., None]).sum(-1) - 1, 0, len(_BASE_P) - 1)
    dh = h - h0[k]
    t0, lam, p0 = const(_T0, h)[k], const(_LAM, h)[k], const(_BASE_P, h)[k]
    temp = t0 + lam * dh
    iso = lam == 0.0
    # both branches evaluate: keep the gradient branch's pow defined where
    # lam == 0 before the isothermal closed form is selected
    lam_nz = torch.where(iso, 1.0, lam)
    p_grad = p0 * (t0 / temp) ** (_BETA / lam_nz)
    p_iso = p0 * torch.exp(-_BETA * dh / t0)
    return torch.where(iso, p_iso, p_grad), temp


def pressure_temperature(h_m):
    return pressure_temperature_at_geopotential(geopotential_altitude(f64(h_m)))


def pressure(h_m):
    return pressure_temperature(h_m)[0]


def temperature(h_m):
    return pressure_temperature(h_m)[1]


def density(h_m):
    p, t = pressure_temperature(h_m)
    return p / (R_AIR * t)


def speed_of_sound(h_m):
    return torch.sqrt(GAMMA_AIR * R_AIR * pressure_temperature(h_m)[1])
