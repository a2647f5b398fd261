"""ArduPilot-style setpoint shaping and attitude-error decomposition
(counterpart of ``examples/drone/shaping.py``): the "sqrt controller"
input-shaping stack, branchless (``torch.where``), component by
component, in the JAX module's order of operations.
"""

import math

import numpy as np
import torch

import elodin_tpu_torch as el

from .._consts import const

Tensor = torch.Tensor
_UP = np.array([0.0, 0.0, 1.0])


def _max(a, b):
    """jnp.maximum of a tensor or a Python float with a float bound."""
    return torch.clamp(a, min=b) if isinstance(a, Tensor) else max(a, b)


# --- quaternion / euler utilities -------------------------------------------


def quat_to_euler(q: el.Quaternion) -> Tensor:
    """3-2-1 (roll, pitch, yaw) from a quaternion, singularity-clamped."""
    x, y, z, w = q.vector().unbind(-1)
    roll = torch.arctan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    sinp = torch.clamp(2.0 * (w * y - x * z), -1.0, 1.0)
    pitch = torch.arcsin(sinp)
    yaw = torch.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw])


def euler_to_quat(angles: Tensor) -> el.Quaternion:
    return el.Quaternion.from_euler(angles)


def quat_to_axis_angle(q: el.Quaternion) -> Tensor:
    """Rotation vector (axis * angle); smooth near identity."""
    v = q.vector()
    xyz, w = v[:3], v[3]
    # sign-normalize to the short arc
    s = torch.where(w < 0.0, -torch.ones_like(w), torch.ones_like(w))
    xyz, w = xyz * s, w * s
    sin_half = torch.linalg.norm(xyz)
    angle = 2.0 * torch.arctan2(sin_half, w)
    # angle/sin(angle/2) -> 2 as angle -> 0
    scale = torch.where(sin_half > 1e-9, angle / torch.clamp(sin_half, min=1e-30), 2.0)
    return xyz * scale


def normalize_angle(a: Tensor) -> Tensor:
    """Wrap to (-pi, pi] (odd multiples of pi map to +pi)."""
    return math.pi - torch.remainder(math.pi - a, 2.0 * math.pi)


def quat_dist(q1: el.Quaternion, q2: el.Quaternion) -> Tensor:
    """Huynh inner-product rotation distance (rad)."""
    d = torch.abs(torch.sum(q1.vector() * q2.vector(), dim=-1))
    return 2.0 * torch.arccos(torch.clamp(d, -1.0, 1.0))


def angular_to_euler_rate(att: el.Quaternion, omega_body: Tensor) -> Tensor:
    """euler_rate = T(roll, pitch) @ omega_body for the 3-2-1 sequence,
    written component by component."""
    roll, pitch, _ = quat_to_euler(att).unbind(0)
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp = torch.clamp(torch.cos(pitch), min=1e-6)
    tp = torch.sin(pitch) / cp
    w0, w1, w2 = omega_body[0], omega_body[1], omega_body[2]
    return torch.stack([
        w0 + sr * tp * w1 + cr * tp * w2,
        cr * w1 - sr * w2,
        (sr * w1 + cr * w2) / cp,
    ])


def euler_to_angular_rate(att: el.Quaternion, euler_rate: Tensor) -> Tensor:
    """Inverse of angular_to_euler_rate, in the same form."""
    roll, pitch, _ = quat_to_euler(att).unbind(0)
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    r, p, y = euler_rate[0], euler_rate[1], euler_rate[2]
    return torch.stack([
        r - sp * y,
        cr * p + sr * cp * y,
        -sr * p + cr * cp * y,
    ])


# --- sqrt-controller input shaping -------------------------------------------


def sqrt_controller(error, p, accel_max, dt):
    """Second-order-limited proportional law (the ArduPilot sqrt
    controller): P * error near zero, sign(e) sqrt(2 a (|e| - d/2)) beyond
    the linear distance d = a / p^2; the |error|/dt clip keeps the last step
    from overshooting."""
    err_abs = torch.abs(error)
    linear_dist = accel_max / _max(p, 1e-9) ** 2
    sqrt_out = torch.sign(error) * torch.sqrt(
        2.0 * accel_max * torch.clamp(err_abs - 0.5 * linear_dist, min=0.0)
    )
    out = torch.where(err_abs > linear_dist, sqrt_out, error * p)
    return torch.clamp(out, -err_abs / dt, err_abs / dt)


def shape_rate(target_rate, desired_rate, accel_max, dt, time_constant):
    """Slew ``target_rate`` toward ``desired_rate`` under an acceleration
    cap; the first-order pull (1/tc) is clipped so one step never
    overshoots."""
    err = desired_rate - target_rate
    p = 1.0 / _max(time_constant, 0.01)
    correction = torch.clamp(err * p, -torch.abs(err) / dt, torch.abs(err) / dt)
    new = target_rate + correction * dt
    step = accel_max * dt
    return torch.clamp(new, target_rate - step, target_rate + step)


def shape_angle(error_angle, target_rate, accel_max, dt, time_constant):
    """Angle error -> shaped rate target: the sqrt-controller demand, then
    shape_rate's accel-limited slew."""
    p = 1.0 / _max(time_constant, 0.01)
    desired_rate = sqrt_controller(error_angle, p, accel_max, dt)
    return shape_rate(target_rate, desired_rate, accel_max, dt, 0.0)


def angular_to_euler_accel_limit(att: el.Quaternion, accel_body: Tensor) -> Tensor:
    """Conservative per-euler-axis acceleration budget from body-axis
    limits (each body budget over its trig-clipped projection, the min)."""
    roll, pitch, _ = quat_to_euler(att).unbind(0)
    sin_phi = torch.clamp(torch.abs(torch.sin(roll)), 0.1, 1.0)
    cos_phi = torch.clamp(torch.abs(torch.cos(roll)), 0.1, 1.0)
    sin_theta = torch.clamp(torch.abs(torch.sin(pitch)), 0.1, 1.0)
    cos_theta = torch.clamp(torch.abs(torch.cos(pitch)), 0.1, 1.0)
    ax, ay, az = accel_body.unbind(0)
    roll_lim = ax
    pitch_lim = torch.minimum(ay / cos_phi, az / sin_phi)
    yaw_lim = torch.minimum(
        torch.minimum(ax / sin_theta, ay / (sin_phi * cos_theta)),
        az / (cos_phi * cos_theta),
    )
    return torch.stack([roll_lim, pitch_lim, yaw_lim])


# --- tilt-priority attitude error --------------------------------------------


def tilt_heading_error(q_target: el.Quaternion, q_body: el.Quaternion):
    """Decompose body->target into tilt (thrust vector) then heading twist:
    (att_error_body 3-vector, thrust_error_angle)."""
    up = const(_UP, q_body.vector())
    z_body = q_body @ up
    z_tgt = q_target @ up
    cosang = torch.clamp(torch.sum(z_body * z_tgt, dim=-1), -1.0, 1.0)
    tilt_angle = torch.arccos(cosang)
    axis_w = torch.linalg.cross(z_body, z_tgt)
    axis_norm = torch.linalg.norm(axis_w)
    ok = torch.minimum(axis_norm, tilt_angle) > 1e-6
    axis_w = torch.where(ok, axis_w / torch.clamp(axis_norm, min=1e-30), up)
    # the tilt axis in the body frame, where the rate loop acts
    axis_b = q_body.inverse() @ axis_w
    q_tilt = el.Quaternion.from_axis_angle(axis_b, torch.where(ok, tilt_angle, 0.0))
    tilt_vec = quat_to_axis_angle(q_tilt)
    # what remains after the tilt correction is the heading twist
    q_head = q_tilt.inverse() * (q_body.inverse() * q_target)
    head_vec = quat_to_axis_angle(q_head)
    err = torch.stack([tilt_vec[0], tilt_vec[1], head_vec[2]])
    return err, tilt_angle

