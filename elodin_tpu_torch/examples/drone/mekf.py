"""The drone's multiplicative extended Kalman filter: attitude plus
gyro / accel / magnetometer biases (counterpart of
``examples/drone/mekf.py``).

The 18x18 covariance algebra is block-sparse as in the JAX module: the
propagation writes out G's nonzero rows, and the accel and magnetometer
observations are two 3-row block updates, each with a cofactor 3x3
inverse.  The JAX module's ``.at[...].add`` on row and column blocks
becomes a concatenation of the updated block with the untouched rest, so
no tensor is written in place (which ``torch.func.vmap`` refuses for an
unbatched tensor).

This module defines ``@el.map`` systems, so it must not use postponed
annotations.
"""

import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el
from elodin_tpu_torch.spatial import skew

from .._consts import const

CTRL_DT = 1.0 / 300.0

P0 = 0.1
# Bias states start well-known (near zero): a loose bias prior lets the
# first big innovation freeze into the statically-unobservable bias states
# and leaves a permanent attitude offset.
P0_BIAS = 1e-4
GYRO_COV = 0.1
GYRO_BIAS_COV = 0.01
ACCEL_COV = 0.1
ACCEL_BIAS_COV = 0.001
MAG_BIAS_COV = 0.001
MAG_OBS_COV = 0.1

_UP = np.array([0.0, 0.0, 1.0])
_F3 = el.ComponentType(el.PrimitiveType.F64, (3,))
T = torch.Tensor

EstCov = ty.Annotated[
    T,
    el.Component(
        "estimate_covariance",
        el.ComponentType(el.PrimitiveType.F64, (18, 18)),
        metadata={"private": "true"},
    ),
]
AttEst = ty.Annotated[el.Quaternion, el.Component("attitude_estimate")]
GyroBiasEst = ty.Annotated[T, el.Component("gyro_bias_estimate", _F3)]
AccelBiasEst = ty.Annotated[T, el.Component("accel_bias_estimate", _F3)]
MagBiasEst = ty.Annotated[T, el.Component("magnetometer_bias_estimate", _F3)]
AttEstError = ty.Annotated[T, el.Component("attitude_estimate_error", el.ComponentType.F64)]


def process_noise(dt: float) -> np.ndarray:
    """Van-Loan-style discretized Q for the 18-state error model."""
    i3 = np.eye(3)
    q = np.zeros((18, 18))
    q[0:3, 0:3] = (GYRO_COV * dt + GYRO_BIAS_COV * dt**3 / 3.0) * i3
    q[0:3, 9:12] = -GYRO_BIAS_COV * dt**2 / 2.0 * i3
    q[9:12, 0:3] = -GYRO_BIAS_COV * dt**2 / 2.0 * i3
    q[9:12, 9:12] = GYRO_BIAS_COV * dt * i3
    q[3:6, 3:6] = (ACCEL_COV * dt + ACCEL_BIAS_COV * dt**3 / 3.0) * i3
    q[3:6, 6:9] = (ACCEL_COV * dt**2 / 2.0 + ACCEL_BIAS_COV * dt**4 / 8.0) * i3
    q[6:9, 3:6] = (ACCEL_COV * dt**2 / 2.0 + ACCEL_BIAS_COV * dt**4 / 8.0) * i3
    q[6:9, 6:9] = (ACCEL_COV * dt**3 / 3.0 + ACCEL_BIAS_COV * dt**5 / 20.0) * i3
    q[3:6, 12:15] = -ACCEL_BIAS_COV * dt**2 / 2.0 * i3
    q[12:15, 3:6] = -ACCEL_BIAS_COV * dt**2 / 2.0 * i3
    q[6:9, 12:15] = -ACCEL_BIAS_COV * dt**3 / 6.0 * i3
    q[12:15, 6:9] = -ACCEL_BIAS_COV * dt**3 / 6.0 * i3
    q[12:15, 12:15] = ACCEL_BIAS_COV * dt * i3
    q[15:18, 15:18] = MAG_BIAS_COV * dt * i3
    return q


_Q_DISCRETE = process_noise(CTRL_DT)
_EYE3 = np.eye(3)


@el.dataclass
class MEKF(el.Archetype):
    estimate_covariance: EstCov = field(
        default_factory=lambda: np.diag(np.concatenate([np.full(9, P0), np.full(9, P0_BIAS)]))
    )
    attitude_estimate: AttEst = field(default_factory=el.Quaternion.identity)
    gyro_bias_estimate: GyroBiasEst = field(default_factory=lambda: np.zeros(3))
    accel_bias_estimate: AccelBiasEst = field(default_factory=lambda: np.zeros(3))
    magnetometer_bias_estimate: MagBiasEst = field(default_factory=lambda: np.zeros(3))
    attitude_estimate_error: AttEstError = field(default_factory=lambda: np.float64(0.0))


def _ab(a: T, b: T) -> T:
    """a (n,3) @ b (3,m) as broadcasts, the JAX module's form."""
    return a[:, 0:1] * b[0] + a[:, 1:2] * b[1] + a[:, 2:3] * b[2]


def _ab_t(a: T, b: T) -> T:
    """a (n,3) @ b.T for b (m,3), the same form."""
    return a[:, 0:1] * b[:, 0] + a[:, 1:2] * b[:, 1] + a[:, 2:3] * b[:, 2]


def _mv(a: T, v: T) -> T:
    """a (n,3) @ v (3,) matvec, the same form."""
    return a[:, 0] * v[0] + a[:, 1] * v[1] + a[:, 2] * v[2]


def _inv3(m: T) -> T:
    """Cofactor (adjugate / det) inverse of a 3x3, elementwise: no library
    inverse, which would sync the host and round otherwise."""
    c00 = m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]
    c01 = m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]
    c02 = m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]
    c10 = m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]
    c11 = m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]
    c12 = m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]
    c20 = m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]
    c21 = m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]
    c22 = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = m[0, 0] * c00 + m[0, 1] * c10 + m[0, 2] * c20
    adj = torch.stack([
        torch.stack([c00, c01, c02]),
        torch.stack([c10, c11, c12]),
        torch.stack([c20, c21, c22]),
    ])
    return adj / det


def make_update(sn):
    """The MEKF's measurement and time update, closed over the sensor
    module."""

    @el.map
    def update(
        gyro: sn.Gyro,
        accel: sn.Accel,
        mag: sn.Magnetometer,
        health: sn.AccelHealth,
        pos: el.WorldPos,
        p_cov: EstCov,
        q_est: AttEst,
        bg: GyroBiasEst,
        ba: AccelBiasEst,
        bm: MagBiasEst,
    ) -> tuple[EstCov, AttEst, GyroBiasEst, AccelBiasEst, MagBiasEst, AttEstError]:
        dt = CTRL_DT
        up = const(_UP, accel)
        a_norm = torch.linalg.norm(accel)
        accel_u = torch.where(a_norm > 1e-6, accel / torch.clamp(a_norm, min=1e-6), up)
        w = gyro - bg
        a_meas = accel_u - ba
        m_meas = mag - bm

        # reference propagation: integrate the bias-corrected gyro
        q_est = (q_est + q_est * el.Quaternion.from_array(
            torch.cat([0.5 * w * dt, torch.zeros_like(w[:1])]))).normalize()
        rot = q_est.to_mat3()

        # first-order covariance propagation P += dt (G P + P G^T) + Q, with
        # G's nonzero rows (0:9) written out
        ab = torch.cat([-skew(w), -_ab(rot, skew(a_meas))], dim=0)
        m_top = _ab(ab, p_cov[0:3])
        m9 = torch.cat(
            [m_top[0:3] - p_cov[9:12], m_top[3:6] - _ab(rot, p_cov[12:15]), p_cov[3:6]],
            dim=0,
        )
        p_cov = torch.cat([p_cov[0:9, :] + dt * m9, p_cov[9:, :]], dim=0)
        p_cov = torch.cat([p_cov[:, 0:9] + dt * m9.T, p_cov[:, 9:]], dim=1)
        p_cov = p_cov + const(_Q_DISCRETE, p_cov)

        # observation: gravity and field directions in the body frame, the
        # third and second rows of rot (body -> world)
        up_b = rot[2]
        north_b = rot[1]
        sk_u = skew(up_b)
        sk_n = skew(north_b)

        accel_obs_cov = 1.0 + (1.0 - health) * 1000.0

        # two 3-row block Kalman updates (accel, then mag); block i of H is
        # [skew(dir) | 0 | I3 at its bias triplet]
        eye3 = const(_EYE3, p_cov)
        dx = torch.zeros_like(p_cov[0])
        for sk_m, lo, innov3, r in (
            (sk_u, 12, a_meas - up_b, accel_obs_cov),
            (sk_n, 15, m_meas - north_b, MAG_OBS_COV),
        ):
            pht = _ab_t(p_cov[:, 0:3], sk_m) + p_cov[:, lo:lo + 3]  # (18,3)
            s3 = _ab(sk_m, pht[0:3]) + pht[lo:lo + 3] + r * eye3
            k = _ab(pht, _inv3(s3))  # (18,3)
            resid = innov3 - (_mv(sk_m, dx[0:3]) + dx[lo:lo + 3])
            dx = dx + _mv(k, resid)
            p_cov = p_cov - _ab_t(k, pht)
        q_est = (q_est * el.Quaternion.from_array(
            torch.cat([0.5 * dx[0:3], torch.ones_like(dx[:1])]))).normalize()
        # the truth-vs-estimate score, in the same map
        err = q_est.angular_distance(pos.angular())
        return p_cov, q_est, bg + dx[9:12], ba + dx[12:15], bm + dx[15:18], err

    return update
