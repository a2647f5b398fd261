"""All-attitude booster aerodynamics in torch (counterpart of
``examples/falcon9/aero.py``): Mach tables, the nose-first / engines-first
blend, plume dominance and X-configured grid fins.  Coefficient values are
the JAX example's, verbatim; the Mach lookup is ``ops.interp`` with
``jnp.interp``'s semantics."""

from __future__ import annotations

import numpy as np
import torch

from ...ops.interp import interp
from .._consts import const, f64
from .constants import S_REF_M2, STAGE1_LENGTH_M, STAGE1_RADIUS_M

# One Mach grid for every table in the bank.
MACH_PTS = np.array([0.0, 0.6, 0.9, 1.1, 1.5, 2.0, 3.0, 5.0, 10.0])

# Coefficient bank rows (EST priors; descent CA anchored to the recorded
# CRS-12 descent q-bar peak of ~60 kPa).
CA_ASCENT = np.array([0.30, 0.32, 0.45, 0.55, 0.50, 0.42, 0.35, 0.30, 0.28])
CA_DESCENT = np.array([1.90, 1.95, 2.10, 2.40, 2.30, 2.20, 2.10, 2.00, 1.90])
CN_CROSS = np.array([1.20, 1.20, 1.25, 1.35, 1.30, 1.25, 1.20, 1.15, 1.10])
CN_DELTA_FIN = np.array([1.2, 1.2, 0.9, 0.8, 1.1, 1.3, 1.25, 1.2, 1.1])

# Center-of-pressure stations (m above the engine plane): nose-first CP
# ahead of the CG, fins-out engines-first CP behind it.
X_CP_ASCENT_M = 28.0
X_CP_DESCENT_M = 26.0

# Pitch/yaw damping derivatives on body length (negative = stable).
CMQ_ASCENT = -2.5
CMQ_DESCENT = -12.0

# Plume-dominance scale: kappa = C_T / (C_T + CT0).
PLUME_CT0 = 1.0

# --- grid fins (X configuration at the interstage) ---------------------------
FIN_STATION_M = 44.0
S_FIN_M2 = 1.5
_AZ = np.deg2rad([45.0, 135.0, 225.0, 315.0])
# Tangential force direction for + deflection, and hinge positions.
FIN_FORCE_DIR = np.column_stack([np.zeros(4), -np.sin(_AZ), np.cos(_AZ)])
FIN_POS = np.column_stack(
    [np.full(4, FIN_STATION_M), STAGE1_RADIUS_M * np.cos(_AZ), STAGE1_RADIUS_M * np.sin(_AZ)]
)
# (4,3) mixer columns = (pitch, yaw, roll): a positive command gives a
# positive body torque about that axis.
FIN_MIX = np.concatenate(
    [-FIN_FORCE_DIR[:, 2:3], FIN_FORCE_DIR[:, 1:2], np.ones((4, 1))], axis=1
)

_X_HAT = np.array([1.0, 0.0, 0.0])
_PITCH_YAW = np.array([0.0, 1.0, 1.0])
_EYE3 = np.eye(3)


def mach_lookup(table, mach):
    """Linear interpolation of one coefficient row at ``mach``."""
    mach = f64(mach)
    return interp(mach, const(MACH_PTS, mach), const(table, mach))


def config_blend(v_axial_body):
    """1 = nose-first (ascent tables), 0 = engines-first (descent tables);
    smooth over +-~100 m/s of axial air-relative velocity."""
    return 0.5 * (1.0 + torch.tanh(v_axial_body / 50.0))


def plume_dominance(thrust_n, qbar_pa):
    """Fraction of aerodynamic force erased by the engine plume, in [0, 1)."""
    ct = thrust_n / torch.clamp(qbar_pa * S_REF_M2, min=1.0)
    return ct / (ct + PLUME_CT0)


def body_aero_wrench(v_air_body, mach, qbar_pa, cg_station_m, omega_body=None,
                     ca_scale=1.0, cn_scale=1.0):
    """Continuous all-attitude aero (force, torque) in the body frame: axial
    plus cross-flow decomposition, the wrench at the blended CP, Cmq damping
    of the perpendicular body rates."""
    v_air_body = f64(v_air_body)
    x_hat = const(_X_HAT, v_air_body)
    speed = torch.linalg.vector_norm(v_air_body, dim=-1)
    v_hat = v_air_body / torch.clamp(speed, min=1e-6)
    w = config_blend(v_air_body[0])
    ca = ca_scale * (w * mach_lookup(CA_ASCENT, mach)
                     + (1.0 - w) * mach_lookup(CA_DESCENT, mach))
    cn = cn_scale * mach_lookup(CN_CROSS, mach)
    axial = v_hat[0]
    cross = v_hat - axial * x_hat
    force = -qbar_pa * S_REF_M2 * (ca * axial * x_hat + cn * cross)
    station = w * X_CP_ASCENT_M + (1.0 - w) * X_CP_DESCENT_M
    torque = torch.linalg.cross((station - cg_station_m) * x_hat, force, dim=-1)
    omega = torch.zeros_like(v_air_body) if omega_body is None else omega_body
    cmq = w * CMQ_ASCENT + (1.0 - w) * CMQ_DESCENT
    damp_gain = (qbar_pa * S_REF_M2 * STAGE1_LENGTH_M**2
                 / (2.0 * torch.clamp(speed, min=1.0)) * cmq)
    torque = torque + damp_gain * omega * const(_PITCH_YAW, v_air_body)
    return force, torque


def fin_wrench(deltas_rad, mach, qbar_pa, cg_station_m, eff_scale=1.0):
    """(force, torque) from the four grid-fin deflections, body frame."""
    deltas_rad = f64(deltas_rad)
    cnd = eff_scale * mach_lookup(CN_DELTA_FIN, mach)
    f_each = (qbar_pa * S_FIN_M2 * cnd * deltas_rad)[:, None] * const(FIN_FORCE_DIR, deltas_rad)
    arm = const(FIN_POS, deltas_rad) - const(_X_HAT, deltas_rad) * cg_station_m
    return f_each.sum(0), torch.linalg.cross(arm, f_each, dim=-1).sum(0)


def fin_mix(pitch_yaw_roll):
    """(pitch, yaw, roll) command (rad) -> four deflections (rad)."""
    pitch_yaw_roll = f64(pitch_yaw_roll)
    return const(FIN_MIX, pitch_yaw_roll) @ pitch_yaw_roll


def fin_torque_authority(mach, qbar_pa, cg_station_m):
    """Per-axis |torque| per radian of (pitch, yaw, roll) command: the
    attitude controller's deflection scaling."""
    eye = const(_EYE3, f64(qbar_pa))

    def one(cmd):
        _, t = fin_wrench(fin_mix(cmd), mach, qbar_pa, cg_station_m)
        return torch.abs(t)

    per = torch.stack([one(eye[i]) for i in range(3)])  # (cmd_axis, torque_axis)
    return torch.stack([per[2, 0], per[0, 1], per[1, 2]])  # roll, pitch, yaw -> x,y,z
