"""J2 oblateness gravity (counterpart of ``elodin_tpu/gravity/j2.py``)."""

from __future__ import annotations

import torch

from ..spatial import _as_f


class J2:
    def __init__(self):
        self.r_ref = 6.378e6  # equatorial radius, m
        self.mu_earth = 3.986004418e14  # GM, m^3/s^2
        self.J2 = 1.08262668e-3

    def compute_field(self, x, y, z, mass):
        """Point gravity and the J2 zonal perturbation force on ``mass`` at
        (x, y, z) in an Earth-centred frame; batched over leading axes."""
        r = torch.stack([_as_f(x), _as_f(y), _as_f(z)], dim=-1)
        return self.force(r, mass)

    def force(self, r, mass):
        r = _as_f(r)
        norm = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
        e_r = r / norm
        # every term through dimensionless ratios, as in the JAX package
        # (bare norm**6 overflows an f32 exponent at LEO radii): no
        # intermediate exceeds ~mu/r^2 * (r_ref/r)^2
        u = r[..., 2:3] / norm  # sin(geocentric latitude)
        mass = _as_f(mass, r.device)
        m = mass[..., None] if mass.dim() == r.dim() - 1 else mass
        g0 = self.mu_earth / norm**2  # point-mass acceleration
        f = -m * g0 * e_r
        e_z = torch.tensor([0.0, 0.0, 1.0], dtype=r.dtype, device=r.device).expand_as(r)
        j2_scale = g0 * self.J2 * (self.r_ref / norm) ** 2
        j2 = -m * j2_scale * (3.0 * u * e_z + (1.5 - 7.5 * u * u) * e_r)
        return f + j2
