"""Crazyflie 2.1 plant and firmware-style control cascade, in torch
(counterpart of ``examples/crazyflie-edu/sim.py``): a 500 Hz quad-X plant
with first-order motor dynamics and the student-lab cascade, position P ->
velocity PI -> attitude P -> rate P -> mixer, as the in-graph "firmware";
the lab's setpoint schedule (takeoff, square, land) is a function of time.

    python -m elodin_tpu_torch.examples.crazyflie_edu.sim bench --ticks 500 --device cpu

The JAX example's ``x.at[2].add(v)`` is a ``torch.cat`` of the first two
entries and the sum, and ``jnp.array([a, b, ...])`` of 0-d values a
``torch.stack``: both run under ``Query.map``'s ``torch.func.vmap``.  (This
module defines ``@el.system`` functions, so it must not use postponed
annotations.)
"""

import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

from .._consts import const
from ...spatial import _cross
from .config import (
    G0,
    HOVER_THRUST_PER_MOTOR_N,
    INERTIA,
    MASS_KG,
    MAX_OMEGA_RADPS,
    MOTOR_POS,
    MOTOR_TAU_S,
    MOTOR_YAW_SIGN,
    SIM_RATE_HZ,
    SIM_TIME_STEP,
    THRUST_CONSTANT,
    TORQUE_CONSTANT,
    mixing_matrix,
)

T = torch.Tensor
MotorOmega = ty.Annotated[
    T, el.Component("motor_omega", el.ComponentType(el.PrimitiveType.F64, (4,)))
]
MotorCmd = ty.Annotated[
    T, el.Component("motor_cmd", el.ComponentType(el.PrimitiveType.F64, (4,)))
]
VelInt = ty.Annotated[
    T, el.Component("vel_integral", el.ComponentType(el.PrimitiveType.F64, (3,)))
]
Setpoint = ty.Annotated[
    T, el.Component("setpoint", el.ComponentType(el.PrimitiveType.F64, (3,)))
]

_MIX = mixing_matrix()

# lab flight plan: (t_start, x, y, z) waypoints — takeoff, square, land
WAYPOINTS = np.array(
    [
        [0.0, 0.0, 0.0, 0.6],
        [3.0, 0.6, 0.0, 0.6],
        [6.0, 0.6, 0.6, 0.6],
        [9.0, 0.0, 0.6, 0.6],
        [12.0, 0.0, 0.0, 0.6],
        [15.0, 0.0, 0.0, 0.05],
    ]
)
_WP_T = np.ascontiguousarray(WAYPOINTS[:, 0])
_WP_XYZ = np.ascontiguousarray(WAYPOINTS[:, 1:])

_Z = np.array([0.0, 0.0, 1.0])
_G_ACC = np.array([0.0, 0.0, G0])
_GRAVITY = MASS_KG * np.array([0.0, 0.0, -G0])
_FLATTEN = np.array([1.0, 1.0, 0.0])
_ROTOR_Z = np.array([0.0, 0.0, 1.0])
_ARM = abs(float(MOTOR_POS[0, 0]))


@el.dataclass
class Crazyflie(el.Archetype):
    motor_omega: MotorOmega = field(default_factory=lambda: np.zeros(4))
    motor_cmd: MotorCmd = field(default_factory=lambda: np.zeros(4))
    vel_integral: VelInt = field(default_factory=lambda: np.zeros(3))
    setpoint: Setpoint = field(default_factory=lambda: np.zeros(3))


@el.system
def lab_schedule(
    tick: el.Query[el.SimulationTick],
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[Setpoint],
) -> el.Query[Setpoint]:
    """Waypoint lookup as a function of time (keyboard_controller.py's
    scripted-lab mode)."""
    t = tick[0] * ts[0]
    idx = torch.clamp(
        torch.searchsorted(const(_WP_T, t), t, right=True) - 1, 0, len(WAYPOINTS) - 1
    )
    return q.map(Setpoint, lambda _s: const(_WP_XYZ, t)[idx])


@el.system
def firmware(
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[el.WorldPos, el.WorldVel, Setpoint, VelInt, MotorCmd],
) -> el.Query[MotorCmd, VelInt]:
    """The student cascade (user_code.c labs 1-4): position P, velocity PI,
    attitude P, rate P, mixed to motor thrust commands."""
    dt = ts[0]

    def one(pos, vel, sp, integ, _cmd):
        r = pos.linear()
        v = vel.linear()
        q_att = pos.angular()
        omega_b = vel.angular()

        # position -> velocity setpoint
        v_sp = torch.clamp(1.4 * (sp - r), -0.8, 0.8)
        err_v = v_sp - v
        integ_new = torch.clamp(integ + err_v * dt, -0.5, 0.5)
        a_cmd = 4.0 * err_v + 1.2 * integ_new + const(_G_ACC, r)

        # acceleration -> attitude setpoint (tilt) + collective thrust
        thrust = MASS_KG * torch.linalg.norm(a_cmd)
        z_des = a_cmd / (torch.linalg.norm(a_cmd) + 1e-9)
        z_cur = q_att @ const(_Z, r)
        tilt_axis = _cross(z_cur, z_des)
        s = torch.linalg.norm(tilt_axis)
        tilt_err = torch.atan2(s, torch.clamp(z_cur @ z_des, -1.0, 1.0))
        axis = torch.where(s > 1e-7, tilt_axis / (s + 1e-12), torch.zeros_like(tilt_axis))
        # attitude P -> body rate setpoint (world-frame axis to body frame)
        rate_sp_w = 9.0 * tilt_err * axis
        rate_sp = q_att.inverse() @ rate_sp_w
        # rate P + yaw damping -> body torques
        omega_body = q_att.inverse() @ omega_b
        torque = const(INERTIA, r) * (22.0 * (rate_sp - omega_body))
        torque = torch.cat([torque[:2], (torque[2] + -2e-4 * omega_body[2])[None]])

        # mix [roll, pitch, yaw, throttle] to per-motor thrusts
        u = torch.stack(
            [
                torque[0] / (4.0 * _ARM),
                torque[1] / (4.0 * _ARM),
                torque[2] / (4.0 * TORQUE_CONSTANT / THRUST_CONSTANT),
                thrust / 4.0,
            ]
        )
        f_motor = torch.clamp(const(_MIX, r) @ u, 0.0, 4.0 * HOVER_THRUST_PER_MOTOR_N)
        omega_cmd = torch.sqrt(f_motor / THRUST_CONSTANT)
        return torch.clamp(omega_cmd, 0.0, MAX_OMEGA_RADPS), integ_new

    return q.map((MotorCmd, VelInt), one)


@el.system
def motor_dynamics(
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[MotorOmega, MotorCmd],
) -> el.Query[MotorOmega]:
    """First-order rotor spin-up (sim.py motor_dynamics)."""
    dt = ts[0]

    def one(omega, cmd):
        return omega + (cmd - omega) * (dt / MOTOR_TAU_S)

    return q.map(MotorOmega, one)


@el.map
def plant_forces(
    pos: el.WorldPos, vel: el.WorldVel, omega: MotorOmega, f: el.Force
) -> el.Force:
    """Thrust = kf*w^2 per motor along body z; reaction yaw torque km*w^2;
    linear air drag; gravity."""
    thrusts = THRUST_CONSTANT * omega * omega  # (4,)
    q_att = pos.angular()
    body_z = q_att @ const(_Z, omega)
    f_total = torch.sum(thrusts) * body_z
    # body torques: r x F + yaw reaction
    tau_body = torch.sum(
        _cross(const(MOTOR_POS, omega), thrusts[:, None] * const(_ROTOR_Z, omega)), dim=0
    )
    yaw = torch.sum(const(MOTOR_YAW_SIGN, omega) * TORQUE_CONSTANT * omega * omega)
    tau_body = torch.cat([tau_body[:2], (tau_body[2] + yaw)[None]])
    tau_world = q_att @ tau_body
    v = vel.linear()
    drag = -9e-7 * v * torch.linalg.norm(v) - 2e-5 * v
    return el.SpatialForce(
        linear=f.force() + f_total + drag + const(_GRAVITY, omega),
        torque=f.torque() + tau_world,
    )


@el.map
def ground(pos: el.WorldPos, vel: el.WorldVel) -> tuple[el.WorldPos, el.WorldVel]:
    p = pos.linear()
    below = p[2] < 0.0
    p_new = torch.where(below, p * const(_FLATTEN, p), p)
    v_new = torch.where(below, torch.zeros_like(p), vel.linear())
    w_new = torch.where(below, torch.zeros_like(p), vel.angular())
    return (
        el.SpatialTransform(angular=pos.angular(), linear=p_new),
        el.SpatialMotion(angular=w_new, linear=v_new),
    )


def world() -> el.World:
    w = el.World()
    w.spawn(
        [
            el.Body(
                world_pos=el.SpatialTransform(linear=np.array([0.0, 0.0, 0.0])),
                inertia=el.SpatialInertia(mass=MASS_KG, inertia=INERTIA),
            ),
            Crazyflie(),
        ],
        name="Crazyflie",
    )
    return w


def system() -> el.System:
    return (
        lab_schedule
        | firmware
        | motor_dynamics
        | el.six_dof(sys=plant_forces, integrator=el.Integrator.SemiImplicit)
        | ground
    )


if __name__ == "__main__":
    world().run(system(), simulation_rate=SIM_RATE_HZ)
