"""Quad-X motor plant: PWM -> rpm (first-order) -> thrust/torque (rpm^2)
(counterpart of ``examples/drone/motors.py``; the EDU-450 curve reduced
to its fitted constants, thrust = kT rpm^2, torque = kQ rpm^2).

This module defines ``@el.map`` systems, so it must not use postponed
annotations.
"""

import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

from .._consts import const

FAST_DT = 1.0 / 900.0
MOT_TIME_CONST = 0.05

# EDU-450-class propulsion fit: hover (~2.45 N/motor for a 1 kg quad) near
# 5200 rpm, max thrust ~8 N near 9400 rpm.
KT_THRUST = 9.0e-8  # N / rpm^2
KQ_TORQUE = 1.35e-9  # N m / rpm^2
PWM_MIN, PWM_MAX = 1000.0, 2000.0
RPM_MAX = 9400.0

# Quad-X: motor azimuths (deg from +x): FR, RL, FL, RR; spin CCW=+1.
ARM_M = 0.24
_AZ = np.pi * np.array([0.25, -0.75, 0.75, -0.25])
MOTOR_POS = np.column_stack([ARM_M * np.cos(_AZ), ARM_M * np.sin(_AZ), np.zeros(4)])
SPIN = np.array([1.0, 1.0, -1.0, -1.0])
THRUST_AXIS = np.array([0.0, 0.0, 1.0])

_F4 = el.ComponentType(el.PrimitiveType.F64, (4,))

MotorPwm = ty.Annotated[torch.Tensor, el.Component("motor_pwm", _F4)]
MotorRpm = ty.Annotated[torch.Tensor, el.Component("motor_rpm", _F4)]
MotorThrust = ty.Annotated[torch.Tensor, el.Component("motor_thrust", _F4)]


@el.dataclass
class Motors(el.Archetype):
    motor_pwm: MotorPwm = field(default_factory=lambda: np.full(4, PWM_MIN))
    motor_rpm: MotorRpm = field(default_factory=lambda: np.zeros(4))
    motor_thrust: MotorThrust = field(default_factory=lambda: np.zeros(4))


def pwm_to_rpm(pwm: torch.Tensor) -> torch.Tensor:
    return torch.clamp((pwm - PWM_MIN) / (PWM_MAX - PWM_MIN), 0.0, 1.0) * RPM_MAX


@el.map
def response(pwm: MotorPwm, rpm: MotorRpm) -> tuple[MotorRpm, MotorThrust]:
    """First-order rpm tracking of the PWM command at the fast-loop rate."""
    alpha = FAST_DT / (FAST_DT + MOT_TIME_CONST)
    rpm = rpm + alpha * (pwm_to_rpm(pwm) - rpm)
    return rpm, KT_THRUST * rpm**2


@el.map
def wrench(pos: el.WorldPos, thrust: MotorThrust, rpm: MotorRpm, f: el.Force) -> el.Force:
    """Total body wrench: collective thrust, differential-thrust roll/pitch,
    reaction-torque yaw, rotated into the world frame."""
    axis = const(THRUST_AXIS, thrust)
    force_b = axis * torch.sum(thrust)
    tau_b = torch.sum(
        torch.linalg.cross(const(MOTOR_POS, thrust), thrust[:, None] * axis), dim=0
    ) + axis * torch.sum(const(SPIN, rpm) * KQ_TORQUE * rpm**2)
    q = pos.angular()
    return f + el.SpatialForce(linear=q @ force_b, torque=q @ tau_b)
