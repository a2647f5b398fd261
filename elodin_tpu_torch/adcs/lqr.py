"""Yang analytic quaternion LQR (counterpart of ``elodin_tpu/adcs/lqr.py``;
Yang, "Analytic LQR Design for Spacecraft Control System Based on
Quaternion Model")."""

from __future__ import annotations

import torch

from ..spatial import _as_f, quat_inverse, quat_mul


def lqr_control_mats(j, q_ang_vel, q_pos, r):
    """The diagonal D and K gains."""
    j, q_ang_vel, q_pos, r = (_as_f(x) for x in (j, q_ang_vel, q_pos, r))
    k_diag = torch.sqrt(q_pos / r)
    d_diag = torch.sqrt(q_ang_vel / r + j * k_diag)
    return d_diag, k_diag


def yang_lqr_control(att_est, ang_vel, goal, d, k):
    """Control torque in the body frame; batched."""
    error = quat_mul(quat_inverse(att_est), goal)
    # the sign of the scalar part: the raw w would scale the torque by
    # cos(theta/2), collapsing control authority near a 180-degree slew
    w = error[..., 3:4]
    sign = torch.where(w >= 0, 1.0, -1.0).to(w.dtype)
    error_vec = error[..., :3]
    return -(ang_vel * d) + sign * (error_vec * k)


class YangLQR:
    def __init__(self, j, q_ang_vel, q_pos, r):
        self.d, self.k = lqr_control_mats(j, q_ang_vel, q_pos, r)

    def control(self, att_est, ang_vel, goal):
        return yang_lqr_control(att_est, ang_vel, goal, self.d, self.k)
