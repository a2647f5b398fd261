"""CubeSat attitude dynamics: EGM08 gravity, sun sensors, magnetometer,
MEKF attitude estimation, LQR pointing, reaction wheels (counterpart of
``examples/cube-sat/main.py``, an OreSat-like vehicle in LEO).

Edge folds in both directions (sun sensors -> sat, and sat -> reaction
wheels through ``RevEdge``), EGM08 spherical-harmonic gravity, the
quaternion LQR, wheel saturation and the semi-implicit integrator, every
system in the JAX example's order of operations.  Its ``jax.lax.select``
is ``torch.where``.  The JAX example reads its EGM08 coefficients from
the user's cache directory, which holds no coefficient file, so both fall
back to the vendored set; the port reads no cache (``egm08.EGM08``).
This module defines ``@el.system`` functions, so it must not use
postponed annotations.
"""

import math
from dataclasses import dataclass, field
from typing import Annotated

import numpy as np
import torch

import elodin_tpu_torch as el
from elodin_tpu_torch.adcs.lqr import lqr_control_mats, yang_lqr_control
from elodin_tpu_torch.adcs.mekf import Mekf, calculate_covariance
from elodin_tpu_torch.gravity import egm08

from .._consts import const

SIM_TIME_STEP = 1.0 / 120.0
G = 6.6743e-11
M = 5.972e24
earth_radius = 6378.1 * 1000
altitude = 400 * 1000
radius = earth_radius + altitude
velocity = math.sqrt(G * M / radius)
rw_force_clamp = 0.002

angular_vel_axis = np.array([1.0, 1.0, 1.0]) / np.linalg.norm(np.array([1.0, 1.0, 1.0]))
initial_angular_vel = angular_vel_axis * np.radians(80)

gravity_model = egm08.EGM08(16)

T = torch.Tensor


def _vec3(name):
    return Annotated[T, el.Component(name, el.ComponentType(el.PrimitiveType.F64, (3,)))]


# -- sensors -----------------------------------------------------------------

GyroOmega = _vec3("gyro_omega")
MagReadingBody = _vec3("mag_value")
MagReadingRef = _vec3("mag_ref")
CssReading = _vec3("css_reading")
SunPos = _vec3("sun_pos")


@dataclass
class Sensors(el.Archetype):
    gyro_omega: GyroOmega
    mag_value: MagReadingBody
    mag_ref: MagReadingRef
    css_reading: CssReading
    sun_pos: SunPos


CssValue = Annotated[T, el.Component("css_value", el.ComponentType(el.PrimitiveType.F64, ()))]
CssFov = Annotated[T, el.Component("css_fov", el.ComponentType(el.PrimitiveType.F64, (1,)))]
CssNormal = _vec3("css_normal")
CSSEdge = Annotated[el.Edge, el.Component("css_edge")]


@dataclass
class CSSRel(el.Archetype):
    edge: CSSEdge


@dataclass
class SunSensor(el.Archetype):
    value: CssValue
    fov: CssFov
    normal: CssNormal


_SUN_DIR = np.array([1.0, 0.0, 0.0])


@el.map
def sun_pos(pos: el.WorldPos) -> SunPos:
    # the sun fixed along +x at 1 AU in this scenario
    lin = pos.linear()
    return const(_SUN_DIR, lin) * 1.496e11 - lin


@el.system
def sun_sensor(
    sensor: el.GraphQuery[CSSEdge],
    css_normal: el.Query[CssNormal, CssFov],
    sun: el.Query[SunPos, el.WorldPos],
) -> el.Query[CssValue]:
    def inner(acc, css_normal, fov, sun_pos, world_pos):
        sun_dir = sun_pos / torch.linalg.norm(sun_pos)
        sun_b = world_pos.angular().inverse() @ sun_dir
        cos = torch.sum(css_normal * sun_b, dim=-1)
        return acc + torch.where((torch.abs(torch.arccos(cos)) < fov).all(), cos, 0.0)

    return sensor.edge_fold(css_normal, sun, CssValue, np.array(0.0), inner)


@el.system
def sun_sensor_value(
    graph: el.GraphQuery[Annotated[CSSEdge, el.RevEdge]],
    sat: el.Query[el.WorldPos],
    css: el.Query[CssValue, CssNormal],
) -> el.Query[CssReading]:
    value = graph.edge_fold(
        sat,
        css,
        CssReading,
        np.array([0.0, 0.0, 0.0]),
        lambda acc, _, value, norm: acc + value * norm,
    )
    return value.map(CssReading, lambda x: x / torch.linalg.norm(x))


sun_sensor_sys = sun_pos.pipe(sun_sensor).pipe(sun_sensor_value)

k_0 = np.array([-30926.00e-9, 5817.00e-9, -2318.00e-9])
_MAG_REF = k_0 / np.linalg.norm(k_0)


@el.map
def fake_magnetometer_ref(pos: el.WorldPos) -> MagReadingRef:
    return const(_MAG_REF, pos.inner)


@el.map
def fake_magnetometer_body(pos: el.WorldPos, mag_ref: MagReadingRef) -> MagReadingBody:
    return pos.angular().inverse() @ mag_ref


@el.map
def gyro_omega(pos: el.WorldPos, vel: el.WorldVel) -> GyroOmega:
    return pos.angular().inverse() @ vel.angular()


sensors = sun_sensor_sys | fake_magnetometer_ref | fake_magnetometer_body | gyro_omega

# -- MEKF (through the port's adcs library) ----------------------------------

P = Annotated[T, el.Component("P", el.ComponentType(el.PrimitiveType.F64, (6, 6)))]
AttEst = Annotated[el.Quaternion, el.Component("att_est")]
AngVelEst = _vec3("ang_vel_est")
BiasEst = _vec3("bias_est")

_sigma_g = np.array([0.01, 0.01, 0.01])
_sigma_b = np.array([0.01, 0.01, 0.01])
_Y = np.diag(np.array([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]))
_Q = calculate_covariance(torch.as_tensor(_sigma_g), torch.as_tensor(_sigma_b),
                          SIM_TIME_STEP).numpy()
_YQY = _Y @ _Q @ _Y.T


@el.map
def kalman_filter(
    p: P,
    att_est: AttEst,
    bias_est: BiasEst,
    omega: GyroOmega,
    css: CssReading,
    sun: SunPos,
    mag_body: MagReadingBody,
    mag_ref: MagReadingRef,
) -> tuple[P, AttEst, AngVelEst, BiasEst]:
    state = Mekf(
        q_hat=att_est.vector(),
        b_hat=bias_est,
        p=p,
        omega=omega,
        yqy=const(_YQY, p),
        dt=SIM_TIME_STEP,
    )
    sun_ref = sun / torch.linalg.norm(sun)
    state = state.estimate_attitude([css, mag_body], [sun_ref, mag_ref], [0.02, 0.03])
    return (
        state.p,
        el.Quaternion(state.q_hat),
        state.omega,
        state.b_hat,
    )


@dataclass
class KalmanFilter(el.Archetype):
    p: P
    att_est: AttEst
    ang_vel_est: AngVelEst
    bias_est: BiasEst


# -- control -----------------------------------------------------------------

Goal = Annotated[el.Quaternion, el.Component("goal")]
UserGoal = _vec3("euler_input")
ControlForce = Annotated[el.SpatialForce, el.Component("control_force")]


@dataclass
class ControlInput(el.Archetype):
    goal: Goal
    control_force: ControlForce


@dataclass
class UserInput(el.Archetype):
    deg: UserGoal


j = np.array([0.13, 0.10, 0.05])
_d, _k = (x.numpy() for x in lqr_control_mats(
    j, np.array([5.0, 5.0, 5.0]), np.array([5.0, 5.0, 5.0]), np.array([8.0, 8.0, 8.0])))
_BODY_AXIS = np.array([0.0, 0.0, -1.0])


@el.map
def earth_point(pos: el.WorldPos, deg: UserGoal) -> Goal:
    # nadir pointing plus a user euler offset
    lin = pos.linear()
    body_axis = const(_BODY_AXIS, lin)
    r = -lin / torch.linalg.norm(lin)
    rot_axis = torch.linalg.cross(body_axis, r)
    s = torch.linalg.norm(rot_axis)
    nadir = el.Quaternion(
        torch.where(
            s > 1e-9,
            el.Quaternion.from_axis_angle(
                rot_axis / torch.where(s > 1e-9, s, 1.0),
                torch.arctan2(s, torch.sum(body_axis * r, dim=-1)),
            ).vector(),
            el.Quaternion.identity(lin.device).vector(),
        )
    )
    offset = el.Quaternion.from_euler(torch.deg2rad(deg))
    return nadir * offset


@el.map
def control(att_est: AttEst, omega: AngVelEst, goal: Goal) -> ControlForce:
    torque = yang_lqr_control(att_est.vector(), omega, goal.vector(),
                              const(_d, omega), const(_k, omega))
    return el.SpatialForce(torque=torque)


# -- reaction wheels ---------------------------------------------------------

RWEdge = Annotated[el.Edge, el.Component("rw_edge")]
RWAxis = _vec3("rw_axis")
RWForce = Annotated[el.SpatialForce, el.Component("rw_force")]
RWAngMomentum = _vec3("rw_ang_momentum")


@el.system
def actuator_allocator(
    q: el.GraphQuery[Annotated[RWEdge, el.RevEdge]],
    rw_query: el.Query[RWAxis],
    control_query: el.Query[ControlForce],
) -> el.Query[RWForce]:
    return q.edge_fold(
        rw_query,
        control_query,
        RWForce,
        el.SpatialForce(),
        lambda xs, axis, control_force: (
            xs + el.SpatialForce(torque=torch.sum(control_force.torque() * axis, dim=-1) * axis)
        ),
    )


@el.map
def saturate_force(force: RWForce, ang_momentum: RWAngMomentum) -> tuple[RWForce, RWAngMomentum]:
    new_h = ang_momentum + force.torque() * SIM_TIME_STEP
    torque = torch.where(torch.abs(new_h) < 0.04, force.torque(), 0.0)
    torque = torch.clamp(torque, -rw_force_clamp, rw_force_clamp)
    return (el.SpatialForce(torque=torque), ang_momentum + torque * SIM_TIME_STEP)


@dataclass
class RWRel(el.Archetype):
    edge: RWEdge


@dataclass
class ReactionWheel(el.Archetype):
    axis: RWAxis
    rw_force: RWForce = field(default_factory=lambda: el.SpatialForce())
    ang_momentum: RWAngMomentum = field(default_factory=lambda: np.zeros(3))


@el.system
def rw_effector(
    rw_force: el.GraphQuery[RWEdge],
    force_query: el.Query[el.WorldPos],
    rw_query: el.Query[RWForce],
) -> el.Query[el.Force]:
    return rw_force.edge_fold(
        force_query,
        rw_query,
        el.Force,
        el.SpatialForce(),
        lambda f, pos, force: f + el.SpatialForce(torque=pos.angular() @ force.torque()),
    )


# -- gravity -----------------------------------------------------------------

Radius = Annotated[T, el.Component("radius", el.ComponentType(el.PrimitiveType.F64, ()))]


@el.map
def gravity_effector(
    _: Goal,
    force: el.Force,
    a_pos: el.WorldPos,
    a_inertia: el.Inertia,
) -> tuple[el.Force, Radius]:
    pos = a_pos.linear()
    f = gravity_model.compute_field(pos[0], pos[1], pos[2], a_inertia.mass())
    return (force + el.SpatialForce(linear=f), torch.linalg.norm(pos))


@dataclass
class Debug(el.Archetype):
    radius: Radius


# -- world -------------------------------------------------------------------


def build_world() -> el.World:
    w = el.World()
    sat = w.spawn(
        [
            el.Body(
                world_pos=el.SpatialTransform(linear=np.array([1.0, 0.0, 0.0]) * radius),
                world_vel=el.SpatialMotion(
                    initial_angular_vel, np.array([0.0, 1.0, 0.0]) * velocity
                ),
                inertia=el.SpatialInertia(2825.2 / 1000.0, j),
            ),
            ControlInput(
                el.Quaternion.from_axis_angle(np.array([1.0, 0.0, 0.0]), np.radians(0)),
                el.SpatialForce(),
            ),
            UserInput(np.array([0.0, 0.0, 0.0])),
            Sensors(np.zeros(3), np.zeros(3), np.zeros(3), np.zeros(3), np.zeros(3)),
            KalmanFilter(np.identity(6), el.Quaternion.identity(), np.zeros(3), np.zeros(3)),
            Debug(np.float64(0.0)),
        ],
        name="OreSat",
        id="ore_sat",
    )
    rws = [
        w.spawn(ReactionWheel(axis=np.array(a)), name=f"Reaction Wheel {i + 1}", id=f"rw_{i + 1}")
        for i, a in enumerate([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    ]
    csss = [
        w.spawn(
            SunSensor(value=0.0, fov=np.radians(90), normal=np.array(n)),
            name=f"Course Sun Sensor {i}",
            id=f"css_{i}",
        )
        for i, n in enumerate(
            [
                [0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0],
                [0.0, 0.0, -1.0], [0.0, -1.0, 0.0], [-1.0, 0.0, 0.0],
            ]
        )
    ]
    for i, rw in enumerate(rws):
        w.spawn(RWRel(el.Edge(sat, rw)), name=f"Sat -> RW {i + 1}")
    for i, css in enumerate(csss):
        w.spawn(CSSRel(el.Edge(css, sat)), name=f"CSS {i} -> Sat")
    return w


def build_system() -> el.System:
    return el.six_dof(
        sys=sensors
        | kalman_filter
        | control
        | actuator_allocator
        | saturate_force
        | rw_effector
        | gravity_effector
        | earth_point,
        integrator=el.Integrator.SemiImplicit,
    )


if __name__ == "__main__":
    w = build_world()
    w.run(
        build_system(),
        simulation_rate=1.0 / SIM_TIME_STEP,
        max_ticks=60 * 20 * 60,
    )
