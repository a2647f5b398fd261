"""The cascaded flight controller, flying on the estimator (counterpart of
``examples/drone/control.py``): sqrt-controller shaping of the pilot
command into an acceleration-limited attitude / euler-rate target,
tilt-priority attitude error with rate feedforward blended out as the
thrust-vector error grows, and a body-rate PID with per-axis target /
error / derivative low-pass filters.  The angle loop closes on the MEKF
attitude estimate; altitude hold uses true altitude.

This module defines ``@el.map`` systems, so it must not use postponed
annotations.
"""

import math
import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

from .._consts import const

CTRL_DT = 1.0 / 300.0

RATE_P = np.array([0.40, 0.40, 2.50])
RATE_I = np.array([0.02, 0.02, 0.02])
RATE_D = np.array([0.05, 0.05, 0.01])
ANGLE_P = np.array([4.0, 4.0, 1.0])
ALT_P, ALT_D = 6.0, 4.0
I_LIMIT = 0.4
HOVER_THRUST_N = 9.81 / 4.0  # per motor, 1 kg vehicle
MAX_MOTOR_THRUST_N = 8.0

# Above this thrust-vector error the rate feedforward starts blending out;
# at twice it the controller is tilt-only (the reference's
# AC_ATTITUDE_THRUST_ERROR_ANGLE = 30 deg).
THRUST_ERROR_ANGLE = math.radians(30.0)

_F3 = el.ComponentType(el.PrimitiveType.F64, (3,))
T = torch.Tensor

AngleDesired = ty.Annotated[
    T, el.Component("angle_desired", _F3, metadata={"element_names": "roll,pitch,yaw_rate"})]
AttTarget = ty.Annotated[el.Quaternion, el.Component("attitude_target")]
EulerRateTarget = ty.Annotated[
    T, el.Component("euler_rate_target", _F3, metadata={"element_names": "r,p,y"})]
AngVelSetpoint = ty.Annotated[T, el.Component("ang_vel_setpoint", _F3)]
RatePidState = ty.Annotated[
    T,
    el.Component(
        "rate_pid_state",
        el.ComponentType(el.PrimitiveType.F64, (3, 3)),
        metadata={"element_names": "e.r,e.p,e.y,i.r,i.p,i.y,d.r,d.p,d.y"},
    ),
]
TorqueDemand = ty.Annotated[T, el.Component("torque_demand", _F3)]
AltSetpoint = ty.Annotated[T, el.Component("alt_setpoint", el.ComponentType.F64)]


@el.dataclass
class AttitudeController(el.Archetype):
    angle_desired: AngleDesired = field(default_factory=lambda: np.zeros(3))
    attitude_target: AttTarget = field(default_factory=el.Quaternion.identity)
    euler_rate_target: EulerRateTarget = field(default_factory=lambda: np.zeros(3))
    ang_vel_setpoint: AngVelSetpoint = field(default_factory=lambda: np.zeros(3))
    rate_pid_state: RatePidState = field(default_factory=lambda: np.zeros((3, 3)))
    torque_demand: TorqueDemand = field(default_factory=lambda: np.zeros(3))
    alt_setpoint: AltSetpoint = field(default_factory=lambda: np.float64(2.0))


def make_systems(sn, mekf_mod, motors_mod, filt_mod=None, shp=None, prm=None):
    """The control stack (runs at the 300 Hz control rate)."""
    if shp is None or prm is None or filt_mod is None:
        raise TypeError("make_systems needs the filter, shaping and params modules")
    arm2 = 2.0 * motors_mod.ARM_M**2  # sum of y_i^2 (= sum of x_i^2), quad-X
    kq_over_kt = motors_mod.KQ_TORQUE / motors_mod.KT_THRUST
    accel_body = prm.accel_limits_rad_s2()
    t_filter = filt_mod.LPF(prm.FLTT, 1.0 / CTRL_DT)
    e_filter = filt_mod.LPF(prm.FLTE, 1.0 / CTRL_DT)
    d_filter = filt_mod.LPF(prm.FLTD, 1.0 / CTRL_DT)
    mix_roll = motors_mod.MOTOR_POS[:, 1].copy()
    mix_pitch = motors_mod.MOTOR_POS[:, 0].copy()

    @el.map
    def update_target(
        angle: AngleDesired, tgt: AttTarget, rate_tgt: EulerRateTarget
    ) -> tuple[AttTarget, EulerRateTarget]:
        """Shape the pilot command into an accel-limited moving target:
        roll / pitch through the sqrt controller as one (2,) chain, yaw
        slewed toward the commanded rate; the target quaternion integrates
        the shaped euler rates."""
        euler_tgt = shp.quat_to_euler(tgt)
        lim = shp.angular_to_euler_accel_limit(tgt, const(accel_body, angle))
        rp_rate = shp.shape_angle(
            shp.normalize_angle(angle[:2] - euler_tgt[:2]),
            rate_tgt[:2], lim[:2], CTRL_DT, prm.ATC_INPUT_TC,
        )
        yaw_rate = shp.shape_rate(
            rate_tgt[2], angle[2], lim[2], CTRL_DT, prm.PILOT_Y_RATE_TC
        )
        new_rate_tgt = torch.cat([rp_rate, yaw_rate[None]])
        omega = torch.nan_to_num(shp.euler_to_angular_rate(tgt, new_rate_tgt))
        return tgt.integrate_body(omega * CTRL_DT), new_rate_tgt

    @el.map
    def attitude_loop(
        q_est: mekf_mod.AttEst,
        tgt: AttTarget,
        rate_tgt: EulerRateTarget,
        gyro: sn.Gyro,
        prev_sp: AngVelSetpoint,
    ) -> AngVelSetpoint:
        """Tilt-priority P on the estimated attitude plus feedforward of
        the shaped target rates, washed out linearly to zero by twice
        THRUST_ERROR_ANGLE, where yaw holds the current gyro rate."""
        att_err, tilt_angle = shp.tilt_heading_error(tgt, q_est)
        p_term = const(ANGLE_P, att_err) * att_err
        ff_world = torch.nan_to_num(shp.euler_to_angular_rate(tgt, rate_tgt))
        ff_body = (q_est.inverse() * tgt) @ ff_world
        s = torch.clamp(1.0 - (tilt_angle - THRUST_ERROR_ANGLE) / THRUST_ERROR_ANGLE, 0.0, 1.0)
        sp_xy = p_term[:2] + ff_body[:2] * s
        sp_z = gyro[2] * (1.0 - s) + (p_term[2] + ff_body[2]) * s
        raw = torch.cat([sp_xy, sp_z[None]])
        return t_filter.apply(prev_sp, raw)

    @el.map
    def rate_loop(
        sp: AngVelSetpoint, gyro: sn.Gyro, s: RatePidState
    ) -> tuple[RatePidState, TorqueDemand]:
        """Body-rate PID on the filtered, biased gyro, with the ATC_RAT
        per-axis error / derivative low-pass filters."""
        e_prev, i_prev, d_prev = s.unbind(0)
        e = e_filter.apply(e_prev, sp - gyro)
        i = torch.clamp(i_prev + e * CTRL_DT, -I_LIMIT, I_LIMIT)
        d = d_filter.apply(d_prev, torch.clamp((e - e_prev) / CTRL_DT, -50.0, 50.0))
        return torch.stack([e, i, d]), (const(RATE_P, e) * e + const(RATE_I, e) * i
                                         + const(RATE_D, e) * d)

    @el.map
    def mixer(
        pos: el.WorldPos,
        vel: el.WorldVel,
        alt_sp: AltSetpoint,
        demand: TorqueDemand,
    ) -> motors_mod.MotorPwm:
        """Quad-X mixing (exact geometry inverse) and the altitude-hold
        collective."""
        collective = (
            HOVER_THRUST_N
            + (ALT_P * (alt_sp - pos.linear()[2]) - ALT_D * vel.linear()[2]) / 4.0
        )
        per_motor = (
            collective
            + demand[0] * const(mix_roll, demand) / arm2  # roll
            - demand[1] * const(mix_pitch, demand) / arm2  # pitch
            + demand[2] * const(motors_mod.SPIN, demand) / (4.0 * kq_over_kt)  # yaw
        )
        thrust_cmd = torch.clamp(per_motor, 0.0, MAX_MOTOR_THRUST_N)
        rpm_cmd = torch.sqrt(thrust_cmd / motors_mod.KT_THRUST)
        return (
            motors_mod.PWM_MIN
            + torch.clamp(rpm_cmd / motors_mod.RPM_MAX, 0.0, 1.0)
            * (motors_mod.PWM_MAX - motors_mod.PWM_MIN)
        )

    return update_target | attitude_loop | rate_loop | mixer
