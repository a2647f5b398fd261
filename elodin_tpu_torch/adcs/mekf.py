"""Multiplicative extended Kalman filter for attitude (counterpart of
``elodin_tpu/adcs/mekf.py``).

State: quaternion estimate, gyro bias and a 6x6 error covariance.  The
math is batched and branch-free (``torch.where`` in place of the small-
rate branches), in the JAX module's order of operations; the innovation
solve is ``ops.smallalg.psd_solve``, the unrolled Cholesky, which never
syncs the host.  ``Mekf`` is a dataclass registered with
``torch.utils._pytree`` (its tensors are the leaves, ``dt`` the context),
as the JAX class is a pytree.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.utils._pytree as pytree

from .. import _config
from ..ops.smallalg import psd_solve
from ..spatial import _as_f, quat_identity, quat_integrate_body, quat_inverse, quat_rotate, skew

_EPS_OMEGA = 1e-5


def calculate_covariance(sigma_g, sigma_b, dt: float) -> torch.Tensor:
    """Process noise Q."""
    sigma_g = _as_f(sigma_g)
    sigma_b = _as_f(sigma_b)
    vg = torch.diag(sigma_g * sigma_g * dt)
    vb = torch.diag(sigma_b * sigma_b * dt)
    q00 = vg + vb * (dt * dt / 3.0)
    q01 = vb * (dt / 2.0)
    q11 = vb
    top = torch.cat([q00, q01], dim=1)
    bot = torch.cat([q01, q11], dim=1)
    return torch.cat([top, bot], dim=0)


def propagate_quaternion(q, omega, dt):
    """Closed-form quaternion propagation under constant omega; the
    identity for tiny rates."""
    n = torch.linalg.vector_norm(omega, dim=-1)
    n_safe = torch.where(n > _EPS_OMEGA, n, 1.0)
    c = torch.cos(0.5 * n * dt)
    s = torch.sin(0.5 * n * dt) / n_safe
    ox, oy, oz = (omega[..., i] * s for i in range(3))
    # big omega's rows act on [x, y, z, w]
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    nx = c * x + oz * y - oy * z + ox * w
    ny = -oz * x + c * y + ox * z + oy * w
    nz = oy * x - ox * y + c * z + oz * w
    nw = -ox * x - oy * y - oz * z + c * w
    q_new = torch.stack([nx, ny, nz, nw], dim=-1)
    return torch.where((n > _EPS_OMEGA)[..., None], q_new, q)


def propagate_state_covariance(p, omega, yqy, dt):
    """P' = Phi P Phi^T + Y Q Y^T with the closed-form MEKF transition."""
    n2 = torch.sum(omega * omega, dim=-1)
    n = torch.sqrt(n2)
    safe = n > _EPS_OMEGA
    n_s = torch.where(safe, n, 1.0)
    n2_s = torch.where(safe, n2, 1.0)
    s = torch.sin(n * dt)
    c = torch.cos(n * dt)
    pp = s / n_s
    qq = (1.0 - c) / n2_s
    rr = (n * dt - s) / (n2_s * n_s)
    ox = skew(omega)
    ox2 = ox @ ox
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    phi00 = torch.where(
        safe[..., None, None],
        eye - ox * pp[..., None, None] + ox2 * qq[..., None, None],
        eye,
    )
    phi01 = torch.where(
        safe[..., None, None],
        ox * qq[..., None, None] - eye * dt - ox2 * rr[..., None, None],
        -eye * dt,
    )
    zeros = torch.zeros_like(eye).expand(phi00.shape)
    top = torch.cat([phi00, phi01], dim=-1)
    bot = torch.cat([zeros, eye.expand(phi00.shape)], dim=-1)
    phi = torch.cat([top, bot], dim=-2)
    return phi @ p @ phi.transpose(-1, -2) + yqy


@dataclass
class Mekf:
    """MEKF state."""

    q_hat: torch.Tensor  # (..., 4)
    b_hat: torch.Tensor  # (..., 3)
    p: torch.Tensor  # (..., 6, 6)
    omega: torch.Tensor  # (..., 3) latest gyro reading
    yqy: torch.Tensor  # (6, 6)
    dt: float

    @staticmethod
    def new(sigma_g, sigma_b, dt: float, device=None) -> "Mekf":
        ft = _config.default_float()
        y = torch.diag(torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], dtype=ft, device=device))
        q = calculate_covariance(_as_f(sigma_g, device), _as_f(sigma_b, device), dt)
        return Mekf(
            q_hat=quat_identity(device),
            b_hat=torch.zeros(3, dtype=ft, device=device),
            p=torch.eye(6, dtype=ft, device=device),
            omega=torch.zeros(3, dtype=ft, device=device),
            yqy=y @ q @ y.T,
            dt=dt,
        )

    def estimate_attitude(self, measured_bodys, references, sigma_r) -> "Mekf":
        """Propagate, then a sequential vector-measurement update."""
        omega = self.omega - self.b_hat
        q_hat = propagate_quaternion(self.q_hat, omega, self.dt)
        p = propagate_state_covariance(self.p, omega, self.yqy, self.dt)
        delta_x = torch.zeros(q_hat.shape[:-1] + (6,), dtype=q_hat.dtype, device=q_hat.device)
        eye6 = torch.eye(6, dtype=p.dtype, device=p.device)
        eye3 = torch.eye(3, dtype=p.dtype, device=p.device)
        # strict: a length mismatch must fail, not drop a measurement
        for body, ref, sigma in zip(measured_bodys, references, sigma_r, strict=True):
            body = _as_f(body)
            ref = _as_f(ref)
            var_r = eye3 * (_as_f(sigma, p.device) ** 2)
            body_r = quat_rotate(quat_inverse(q_hat), ref)
            e = body - body_r
            h = torch.cat(
                [skew(body_r), torch.zeros(body_r.shape[:-1] + (3, 3), dtype=p.dtype,
                                           device=p.device)],
                dim=-1,
            )
            ht = h.transpose(-1, -2)
            s_mat = h @ p @ ht + var_r
            k = psd_solve(s_mat, (p @ ht).transpose(-1, -2)).transpose(-1, -2)
            p = (eye6 - k @ h) @ p
            d = (h @ delta_x[..., None])[..., 0]
            delta_x = delta_x + (k @ (e - d)[..., None])[..., 0]
        q_hat = quat_integrate_body(q_hat, delta_x[..., :3])
        b_hat = self.b_hat + delta_x[..., 3:]
        # omega keeps the raw gyro reading: a second update without a fresh
        # sample must not subtract the bias twice
        return Mekf(q_hat, b_hat, p, self.omega, self.yqy, self.dt)

    def reset_if_invalid(self) -> "Mekf":
        """Branch-free reset of a non-finite state."""
        bad = ~(
            torch.isfinite(self.q_hat).all(dim=-1)
            & torch.isfinite(self.b_hat).all(dim=-1)
            & torch.isfinite(self.p).flatten(-2).all(dim=-1)
            & torch.isfinite(self.omega).all(dim=-1)
        )
        return Mekf(
            torch.where(bad[..., None], quat_identity(self.q_hat.device).to(self.q_hat.dtype),
                        self.q_hat),
            torch.where(bad[..., None], 0.0, self.b_hat),
            torch.where(bad[..., None, None],
                        torch.eye(6, dtype=self.p.dtype, device=self.p.device), self.p),
            torch.where(bad[..., None], 0.0, self.omega),
            self.yqy,
            self.dt,
        )


pytree.register_pytree_node(
    Mekf,
    lambda m: ([m.q_hat, m.b_hat, m.p, m.omega, m.yqy], m.dt),
    lambda children, dt: Mekf(*children, dt=dt),
)
