"""EGM2008 spherical-harmonic gravity, Pines formulation, batched
(counterpart of ``elodin_tpu/gravity/egm08.py``).

The same algorithm in the same order of operations: the sectorial terms
R_m, I_m in closed form, (s+it)^m = rho^m (cos m phi, sin m phi); the
Helmholtz polynomials A[l, m](u) row by row over degree (the JAX module's
``lax.scan`` becomes a loop of L + 2 steps, and since the degree is a
Python number there, each row is its recursion entries, the subdiagonal,
the diagonal and zeros, concatenated); the recursion constants built
with numpy at construction.

Coefficients: ``C_normal.npy`` / ``S_normal.npy`` from
``cache_directory`` when both exist there, else the vendored real
low-degree set (``egm08_coeffs``); nothing is downloaded.  Where the JAX
example passes its cache directory, the port passes none, so it reads no
file outside the checkout.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..examples._consts import const
from . import egm08_coeffs


def _k(m: np.ndarray) -> np.ndarray:
    """Kronecker factor: 1 for m==0 else 2."""
    return np.where(m == 0, 1.0, 2.0)


class EGM08:
    def __init__(self, max_degree: int, cache_directory: str | None = None,
                 synthetic_extension: bool = False):
        self.r_ref = 6.378e6
        self.mu_earth = 3.986004418e14
        self.max_degree = int(max_degree)
        L = self.max_degree

        c_path = os.path.join(cache_directory or "", "C_normal.npy")
        s_path = os.path.join(cache_directory or "", "S_normal.npy")
        if cache_directory and os.path.isfile(c_path) and os.path.isfile(s_path):
            c = np.load(c_path)[: L + 1, : L + 1].astype(np.float64)
            s = np.load(s_path)[: L + 1, : L + 1].astype(np.float64)
            self.field_provenance = "file"
        else:
            c, s = egm08_coeffs.vendored(L)
            self.field_provenance = "vendored-low-degree"
            if synthetic_extension and L > egm08_coeffs.VENDORED_MAX_DEGREE:
                c, s = egm08_coeffs.kaula_extend(c, s)
                self.field_provenance = "vendored+kaula-synthetic"
        self.c_bar = np.ascontiguousarray(c)
        self.s_bar = np.ascontiguousarray(s)

        # static recursion constants; the Helmholtz table goes to degree
        # L+1, which the a4 term needs
        lg = np.arange(L + 2, dtype=np.float64)[:, None]
        mg = np.arange(L + 2, dtype=np.float64)[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            n1 = np.sqrt((2 * lg + 1) * (2 * lg - 1) / ((lg + mg) * (lg - mg)))
            n2 = np.sqrt(
                (lg + mg - 1)
                * (lg - mg - 1)
                * (2 * lg + 1)
                / ((2 * lg - 3) * (lg + mg) * (lg - mg))
            )
            nq1 = np.sqrt((lg - mg) * _k(mg) * (lg + mg + 1) / _k(mg + 1))
            nq2 = np.sqrt(
                (lg + mg + 2)
                * (lg + mg + 1)
                * (2 * lg + 1)
                * _k(mg)
                / ((2 * lg + 3) * _k(mg + 1))
            )
        valid = lg >= mg + 2
        self._n1 = np.where(valid, np.nan_to_num(n1), 0.0)
        self._n2 = np.where(valid, np.nan_to_num(n2), 0.0)
        self._nq1 = np.ascontiguousarray(
            np.nan_to_num(np.where((lg - mg) >= 0, nq1, 0.0))[: L + 1, : L + 1])
        self._nq2 = np.ascontiguousarray(np.nan_to_num(nq2)[: L + 1, : L + 1])

        # diagonal A[l,l]: A[0,0]=1, A[l,l] = A[l-1,l-1] sqrt((2l+1)k(l)/(2l k(l-1)))
        diag = np.ones(L + 2)
        for l in range(1, L + 2):
            kl = 2.0
            klm1 = 1.0 if l - 1 == 0 else 2.0
            diag[l] = diag[l - 1] * np.sqrt((2 * l + 1) * kl / (2 * l * klm1))
        self._diag = diag
        # subdiagonal factor: A[l, l-1] = u * A[l,l] * sqrt(2l k(l-1)/k(l))
        sub = np.zeros(L + 2)
        for l in range(1, L + 2):
            klm1 = 1.0 if l - 1 == 0 else 2.0
            sub[l] = diag[l] * np.sqrt(2 * l * klm1 / 2.0)
        self._sub = sub
        # each row's recursion constants (orders m < l-1), as arrays of
        # their own for the device cache
        self._rows = [(np.ascontiguousarray(self._n1[l, : max(l - 1, 0)]),
                       np.ascontiguousarray(self._n2[l, : max(l - 1, 0)]))
                      for l in range(L + 2)]
        self._orders = np.arange(L + 1, dtype=np.float64)
        self._degrees1 = self._orders + 1

    # -- core -------------------------------------------------------------

    def _a_bar(self, u: torch.Tensor) -> torch.Tensor:
        """Normalized Helmholtz polynomials A[l, m](u), batched over u:
        shape u.shape + (L+2, L+2) (one extra degree for a4)."""
        L = self.max_degree
        zero = torch.zeros(u.shape + (L + 2,), dtype=u.dtype, device=u.device)
        prev = prev2 = zero
        rows = []
        for l in range(L + 2):
            n1, n2 = self._rows[l]
            parts = []
            if n1.size:  # orders m < l-1: the recursion
                k = n1.size
                parts.append(u[..., None] * const(n1, u) * prev[..., :k]
                             - const(n2, u) * prev2[..., :k])
            if l >= 1:  # m = l-1
                parts.append((u * self._sub[l])[..., None])
            parts.append(torch.full_like(u[..., None], self._diag[l]))  # m = l
            if l < L + 1:  # m > l
                parts.append(zero[..., : L + 1 - l])
            new = torch.cat(parts, dim=-1)
            rows.append(new)
            prev2, prev = prev, new
        return torch.stack(rows, dim=-2)

    def acceleration(self, r_vec: torch.Tensor) -> torch.Tensor:
        """Specific gravity acceleration at ECEF position(s) (..., 3)."""
        L = self.max_degree
        x, y, z = r_vec[..., 0], r_vec[..., 1], r_vec[..., 2]
        r = torch.sqrt(x * x + y * y + z * z)
        s, t, u = x / r, y / r, z / r

        A_full = self._a_bar(u)  # (..., L+2, L+2)
        A = A_full[..., : L + 1, : L + 1]

        # sectorial phases: R_m + i I_m = (s + i t)^m, closed form
        m_idx = const(self._orders, r)
        rho_xy = torch.sqrt(s * s + t * t)
        phi = torch.arctan2(t, s)
        # the m=0 amplitude is 1 exactly (0**0 on the z-axis)
        amp = torch.where(m_idx == 0, 1.0, rho_xy[..., None] ** m_idx)
        R = amp * torch.cos(phi[..., None] * m_idx)
        I = amp * torch.sin(phi[..., None] * m_idx)  # noqa: E741
        # R_{m-1}, I_{m-1} shifted; R_{-1} treated as 0
        Rm1 = torch.cat([torch.zeros_like(R[..., :1]), R[..., :-1]], dim=-1)
        Im1 = torch.cat([torch.zeros_like(I[..., :1]), I[..., :-1]], dim=-1)

        # rho_{l+1}/r_ref
        ratio = self.r_ref / r
        rho = (self.mu_earth / r)[..., None] * ratio[..., None] ** const(self._degrees1, r)
        w = rho / self.r_ref  # (..., L+1) over degree l

        C, S = const(self.c_bar, r), const(self.s_bar, r)
        E = C * Rm1[..., None, :] + S * Im1[..., None, :]
        F = S * Rm1[..., None, :] - C * Im1[..., None, :]
        D = C * R[..., None, :] + S * I[..., None, :]

        mw = m_idx  # order weights
        a1 = torch.sum(w[..., :, None] * A * mw * E, dim=(-2, -1))
        a2 = torch.sum(w[..., :, None] * A * mw * F, dim=(-2, -1))

        # A[l, m+1] and A[l+1, m+1] windows of the (L+2)-degree table
        A_m1 = A_full[..., : L + 1, 1: L + 2]
        A_l1m1 = A_full[..., 1: L + 2, 1: L + 2]
        a3 = torch.sum(w[..., :, None] * A_m1 * const(self._nq1, r) * D, dim=(-2, -1))
        a4 = -torch.sum(w[..., :, None] * A_l1m1 * const(self._nq2, r) * D, dim=(-2, -1))

        return torch.stack([a1 + s * a4, a2 + t * a4, a3 + u * a4], dim=-1)

    def compute_field(self, x, y, z, mass):
        """Force on ``mass`` at (x, y, z)."""
        r = torch.stack([torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(z)], dim=-1)
        return mass * self.acceleration(r)
