"""Earth frames: the subset of ``elodin_tpu/frames.py`` that the falcon9
mission uses (NED rotations and WGS-84 geodetic <-> ECEF), in torch.

Each function accepts numpy arrays, Python numbers or tensors (batched over
leading axes) and returns f64 tensors, on the device of a tensor argument.
Epochs, IERS data and the ECI frames are not ported yet.
"""

from __future__ import annotations

import torch

_WGS84_A = 6378137.0
_WGS84_E2 = 6.69437999014e-3


def _f64(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=device)


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
    n = _WGS84_A / torch.sqrt(1.0 - _WGS84_E2 * torch.sin(lat) ** 2)
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
        n = _WGS84_A / torch.sqrt(1.0 - _WGS84_E2 * torch.sin(lat) ** 2)
        alt = p / torch.cos(lat) - n
        lat = torch.atan2(z, p * (1.0 - _WGS84_E2 * n / (n + alt)))
    n = _WGS84_A / torch.sqrt(1.0 - _WGS84_E2 * torch.sin(lat) ** 2)
    alt = p / torch.cos(lat) - n
    return lat, long, alt
