"""Finned sounding rocket in torch (counterpart of
``examples/rocket/main.py``): ISA atmosphere lookup, a multilinear
aero-coefficient table over (Mach, fin deflection, angle of attack), a
thrust curve, a Butterworth-filtered acceleration feedback through a
rolling buffer, a pitch PID driving the fins and an external fin trim.

Every system keeps the JAX example's arithmetic in the same order.  Its
two ``jax.lax.cond`` (``aero_coefs``, ``v_rel_accel``) are ``torch.where``
over both branches: a Python ``if`` on a tensor cannot run under
``torch.func.vmap``, and both branches are cheap and finite.  The JAX
example's table lookups call its gather-free ``interp``; the port calls
``ops.interp.interp`` (``jnp.interp``'s own form), which agrees to
round-off.  (This module defines ``@el.system`` functions, so it must not
use postponed annotations.)
"""

import math
import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

from ...ops.interp import interp, lerp_nd
from .._consts import const

SIM_TIME_STEP = 1.0 / 120.0
lp_sample_freq = round(1.0 / SIM_TIME_STEP)
lp_buffer_size = lp_sample_freq * 4
lp_cutoff_freq = 1

thrust_vector_body_frame = np.array([-1.0, 0.0, 0.0])
a_ref = 24.89130 / 100**2
l_ref = 5.43400 / 100
xmc = 0.40387
pitch_pid = [1.1, 0.8, 3.8]

# -- components --------------------------------------------------------------

T = torch.Tensor
_F = el.ComponentType.F64


def _vec(n):
    return el.ComponentType(el.PrimitiveType.F64, (n,))


Wind = ty.Annotated[T, el.Component("wind", _vec(3), metadata={"element_names": "x,y,z"})]
AeroCoefs = ty.Annotated[T, el.Component(
    "aero_coefs", _vec(6), metadata={"element_names": "Cl,CnR,CmR,CA,CZR,CYR"})]
AeroForce = ty.Annotated[el.SpatialForce, el.Component(
    "aero_force", el.ComponentType.SpatialMotionF64,
    metadata={"element_names": "τx,τy,τz,x,y,z"})]
CenterOfGravity = ty.Annotated[T, el.Component("center_of_gravity", _F)]
DynamicPressure = ty.Annotated[T, el.Component("dynamic_pressure", _F)]
AngleOfAttack = ty.Annotated[T, el.Component("angle_of_attack", _F)]
Mach = ty.Annotated[T, el.Component("mach", _F)]
Motor = ty.Annotated[T, el.Component("rocket_motor", _F)]
FinControl = ty.Annotated[T, el.Component("fin_control", _F)]
FinDeflect = ty.Annotated[T, el.Component("fin_deflect", _F)]
FinControlTrim = ty.Annotated[T, el.Component(
    "fin_control_trim", _F, metadata={"external_control": "true", "wait_for_write": "false"})]
VBody = ty.Annotated[T, el.Component("v_body", _vec(3), metadata={"element_names": "u,v,w"})]
VRelAccel = ty.Annotated[T, el.Component(
    "v_rel_accel", _vec(3), metadata={"element_names": "x,y,z", "priority": 20})]
VRelAccelBuffer = ty.Annotated[T, el.Component(
    "v_rel_accel_buffer", el.ComponentType(el.PrimitiveType.F64, (lp_buffer_size, 3)),
    metadata={"priority": -1})]
VRelAccelFiltered = ty.Annotated[T, el.Component(
    "v_rel_accel_filtered", _vec(3), metadata={"element_names": "x,y,z", "priority": 19})]
PitchPID = ty.Annotated[T, el.Component(
    "pitch_pid", _vec(3), metadata={"element_names": "Kp,Ki,Kd"})]
PitchPIDState = ty.Annotated[T, el.Component(
    "pitch_pid_state", _vec(3), metadata={"element_names": "e,i,d"})]
AccelSetpoint = ty.Annotated[T, el.Component(
    "accel_setpoint", _vec(2), metadata={"element_names": "p,y"})]
AccelSetpointSmooth = ty.Annotated[T, el.Component(
    "accel_setpoint_smooth", _vec(2), metadata={"element_names": "p,y"})]
Thrust = ty.Annotated[T, el.Component("thrust", _F)]

# -- aero table (analytic surrogate on the reference's grid axes) -----------

MACH_GRID = np.array([0.1, 0.5, 0.9])
DELTA_GRID = np.array([-40.0, -20.0, 0.0, 20.0, 40.0])
ALPHA_GRID = np.array([0.0, 5.0, 10.0, 15.0])


def _build_aero_table() -> np.ndarray:
    """(coef, mach, delta, alpha) grid for [CmR, CA, CZR]: slender-body +
    fin-lift analytic model with compressibility scaling."""
    m, d, a = np.meshgrid(MACH_GRID, DELTA_GRID, ALPHA_GRID, indexing="ij")
    beta = 1.0 / np.sqrt(np.clip(1.0 - np.minimum(m, 0.95) ** 2, 0.2, 1.0))
    # normal-force coefficient: body (2*alpha) + fins (lift slope * (alpha+delta))
    cn_body = 2.0 * np.deg2rad(a) * 1.8
    cn_fins = 2.4 * beta * np.deg2rad(a + 0.35 * d)
    czr = (cn_body + cn_fins) * 10.0
    # pitching moment about the moment center: fins act behind the CG
    cmr = (-0.9 * cn_fins + 0.45 * cn_body) * 14.0
    # axial force: base drag + induced
    ca = (0.28 + 0.004 * np.abs(d) + 0.0025 * a + 0.12 * m**2) * (
        1.0 + 0.5 * (np.abs(d) / 40.0) ** 2
    )
    return np.stack([cmr, ca, czr])


AERO_TABLE = _build_aero_table()

THRUST_TIME = np.array([0.01, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 24.0, 32.0, 32.15])
THRUST_N = np.array([322.0, 180.0, 120.0, 95.0, 88.4, 88.4, 88.4, 88.4, 88.4, 0.0])


def to_coord(grid: np.ndarray, val: T) -> T:
    return (val - grid.min()) * (len(grid) - 1) / max(grid.max() - grid.min(), 1e-6)


def _butterworth_last_weights(n: int, f_sampling: float, f_cutoff: float) -> np.ndarray:
    """The last output of a forward 2nd-order Butterworth low-pass over an
    ``n``-sample buffer as a fixed linear functional of the buffer: the
    filter's recurrence run over an identity matrix.  The control loop
    reads only that last sample, so a tick costs one weighted sum instead
    of an (n-2)-step recurrence."""
    ff = f_cutoff / f_sampling
    ita = 1.0 / np.tan(np.pi * ff)
    q = np.sqrt(2.0)
    b0 = 1.0 / (1.0 + q * ita + ita**2)
    b1, b2 = 2 * b0, b0
    a1 = 2.0 * (ita**2 - 1.0) * b0
    a2 = -(1.0 - q * ita + ita**2) * b0
    x = np.eye(n)  # column j tracks sample j's contribution
    x_im1, x_im2 = x[1], x[0]
    y_im1, y_im2 = x[1], x[0]
    for i in range(2, n):
        y = b0 * x[i] + b1 * x_im1 + b2 * x_im2 + a1 * y_im1 + a2 * y_im2
        x_im1, x_im2 = x[i], x_im1
        y_im1, y_im2 = y, y_im1
    return y_im1


_BUTTER_LAST_W = _butterworth_last_weights(lp_buffer_size, lp_sample_freq, lp_cutoff_freq)
_BUTTER_LAST_W_COL = np.ascontiguousarray(_BUTTER_LAST_W[:, None])

_GRAVITY = np.array([0.0, 0.0, -9.81])
_X_HAT = np.array([1.0, 0.0, 0.0])
_Y_HAT = np.array([0.0, 1.0, 0.0])
# the setpoint smoother's step fraction 1 - exp(-dt/tau), tau = 2 s
_SMOOTH_STEP = 1.0 - math.exp(-0.5 * SIM_TIME_STEP)


def _dot(a: T, b: T) -> T:
    return torch.sum(a * b, dim=-1)


def euler_to_quat(angles_deg) -> el.Quaternion:
    return el.Quaternion.from_euler(torch.deg2rad(torch.as_tensor(angles_deg,
                                                                  dtype=torch.float64)))


def quat_from_vecs(v1: T, v2: T) -> el.Quaternion:
    """The rotation taking ``v1``'s direction to ``v2``'s.  Anti-parallel
    inputs give a zero quaternion, whose normalisation would be NaN and
    poison the acceleration buffer and the PID for the rest of the run;
    they fall back to a half turn about an axis orthogonal to ``v1``."""
    v1 = v1 / torch.linalg.norm(v1)
    v2 = v2 / torch.linalg.norm(v2)
    n = torch.linalg.cross(v1, v2)
    w = _dot(v2, v2) * _dot(v1, v1) + _dot(v1, v2)
    degenerate = (w * w + _dot(n, n)) < 1e-12
    ortho = torch.linalg.cross(v1, const(_X_HAT, v1))
    ortho = torch.where(_dot(ortho, ortho) < 1e-12,
                        torch.linalg.cross(v1, const(_Y_HAT, v1)), ortho)
    q = torch.where(degenerate,
                    torch.cat([ortho, torch.zeros_like(ortho[..., :1])], dim=-1),
                    torch.cat([n, w.unsqueeze(-1)], dim=-1))
    return el.Quaternion.from_array(q).normalize()


def _f(x) -> np.ndarray:
    return np.float64(x)


@el.dataclass
class Rocket(el.Archetype):
    angle_of_attack: AngleOfAttack = field(default_factory=lambda: _f(0.0))
    aero_coefs: AeroCoefs = field(default_factory=lambda: np.zeros(6))
    center_of_gravity: CenterOfGravity = field(default_factory=lambda: _f(0.2))
    mach: Mach = field(default_factory=lambda: _f(0.0))
    dynamic_pressure: DynamicPressure = field(default_factory=lambda: _f(0.0))
    aero_force: AeroForce = field(default_factory=lambda: el.SpatialForce())
    wind: Wind = field(default_factory=lambda: np.zeros(3))
    motor: Motor = field(default_factory=lambda: _f(0.0))
    fin_deflect: FinDeflect = field(default_factory=lambda: _f(0.0))
    fin_control: FinControl = field(default_factory=lambda: _f(0.0))
    fin_control_trim: FinControlTrim = field(default_factory=lambda: _f(0.0))
    v_body: VBody = field(default_factory=lambda: np.zeros(3))
    v_rel_accel_buffer: VRelAccelBuffer = field(
        default_factory=lambda: np.zeros((lp_buffer_size, 3)))
    v_rel_accel: VRelAccel = field(default_factory=lambda: np.zeros(3))
    v_rel_accel_filtered: VRelAccelFiltered = field(default_factory=lambda: np.zeros(3))
    pitch_pid: PitchPID = field(default_factory=lambda: np.array(pitch_pid))
    pitch_pid_state: PitchPIDState = field(default_factory=lambda: np.zeros(3))
    accel_setpoint: AccelSetpoint = field(default_factory=lambda: np.zeros(2))
    accel_setpoint_smooth: AccelSetpointSmooth = field(default_factory=lambda: np.zeros(2))
    thrust: Thrust = field(default_factory=lambda: _f(0.0))


@el.map
def gravity(f: el.Force, inertia: el.Inertia) -> el.Force:
    m = inertia.mass()
    return f + el.SpatialForce(linear=const(_GRAVITY, m) * m)


# International Standard Atmosphere layers (public data)
_ISA = {
    "h": np.array([0.0, 11e3, 20e3, 32e3, 47e3, 51e3, 71e3, 84_852.0]),
    "T": np.array([15.0, -56.5, -56.5, -44.5, -2.5, -2.5, -58.5, -86.2]),
    "d": np.array([1.225, 0.3639, 0.0880, 0.0132, 0.0014, 0.0009, 0.0001, 0.0]),
}


@el.map
def mach(p: el.WorldPos, v: el.WorldVel, w: Wind) -> tuple[Mach, DynamicPressure]:
    altitude = p.linear()[2]
    h = const(_ISA["h"], altitude)
    temperature = interp(altitude, h, const(_ISA["T"], altitude)) + 273.15
    density = interp(altitude, h, const(_ISA["d"], altitude))
    speed_of_sound = torch.sqrt(1.4 * 287.05 * temperature)
    v_flow = torch.linalg.norm(v.linear() - w)
    return v_flow / speed_of_sound, torch.clamp(0.5 * density * v_flow**2, min=1e-6)


@el.map
def compute_v_body(p: el.WorldPos, v: el.WorldVel, w: Wind) -> VBody:
    return p.angular().inverse() @ (v.linear() - w)


@el.map
def angle_of_attack(p: el.WorldPos, v: el.WorldVel, w: Wind) -> AngleOfAttack:
    u = p.angular().inverse() @ (v.linear() - w)
    cos = _dot(u, const(thrust_vector_body_frame, u)) / torch.clamp(
        torch.linalg.norm(u), min=1e-6)
    return torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0))) * -torch.sign(u[2])


@el.map
def aero_coefs(
    mach: Mach,
    angle_of_attack: AngleOfAttack,
    fin_deflect: FinDeflect,
    fin_trim: FinControlTrim,
) -> AeroCoefs:
    effective = torch.clamp(fin_deflect + fin_trim, -40.0, 40.0)
    # the JAX example's lax.cond, as a select over both branches
    aoa_sign = torch.where(torch.abs(angle_of_attack) < 1e-6,
                           torch.ones_like(angle_of_attack), torch.sign(angle_of_attack))
    effective = effective * aoa_sign
    coords = [
        to_coord(MACH_GRID, mach),
        to_coord(DELTA_GRID, effective),
        to_coord(ALPHA_GRID, torch.abs(angle_of_attack)),
    ]
    table = const(AERO_TABLE, mach)
    coefs = [lerp_nd(table[i], coords) for i in range(table.shape[0])]
    cl = fin_trim * 0.1
    zero = torch.zeros_like(cl)
    return torch.stack([cl, zero, coefs[0] * aoa_sign, coefs[1], coefs[2] * aoa_sign, zero])


@el.map
def aero_forces(aero_coefs: AeroCoefs, xcg: CenterOfGravity, q: DynamicPressure) -> AeroForce:
    Cl, CnR, CmR, CA, CZR, CYR = aero_coefs.unbind(-1)
    CmR = CmR - CZR * (xcg - xmc) / l_ref
    CnR = CnR - CYR * (xcg - xmc) / l_ref
    lin = torch.stack([CA, CYR, CZR]) * q * a_ref
    torque = torch.stack([Cl, -CmR, CnR]) * q * a_ref * l_ref
    return el.SpatialForce(linear=lin, torque=torque)


@el.map
def apply_aero_forces(p: el.WorldPos, f_aero: AeroForce, f: el.Force) -> el.Force:
    return f + p.angular() @ f_aero


@el.system
def thrust(
    tick: el.Query[el.SimulationTick],
    dt: el.Query[el.SimulationTimeStep],
    q: el.Query[Motor],
) -> el.Query[Thrust]:
    t = tick[0] * dt[0]
    f_t = interp(t, const(THRUST_TIME, t), const(THRUST_N, t))
    return q.map(Thrust, lambda _: f_t)


@el.map
def apply_thrust(thrust: Thrust, f: el.Force, p: el.WorldPos) -> el.Force:
    return f + el.SpatialForce(
        linear=p.angular() @ const(thrust_vector_body_frame, thrust) * thrust)


@el.map
def v_rel_accel(v: el.WorldVel, a: el.WorldAccel) -> VRelAccel:
    tvb = const(thrust_vector_body_frame, v.linear())
    # the JAX example's lax.cond, as a select over both branches
    vv = torch.where(torch.linalg.norm(v.linear()) < 1e-6, tvb, v.linear())
    v_rot = quat_from_vecs(tvb, vv)
    return v_rot.inverse() @ a.linear()


@el.map
def v_rel_accel_buffer(a_rel: VRelAccel, buffer: VRelAccelBuffer) -> VRelAccelBuffer:
    return torch.cat((buffer[1:], a_rel.reshape(1, 3)))


@el.map
def v_rel_accel_filtered(s: VRelAccelBuffer) -> VRelAccelFiltered:
    # the filter's last output (see _butterworth_last_weights), as the JAX
    # example's multiply and reduce
    return torch.sum(const(_BUTTER_LAST_W_COL, s) * s, dim=0)


@el.map
def accel_setpoint_smooth(a: AccelSetpoint, a_s: AccelSetpointSmooth) -> AccelSetpointSmooth:
    # first-order lag toward the setpoint, tau = 2 s
    return a_s + (a - a_s) * _SMOOTH_STEP


@el.map
def pitch_pid_state(
    a_setpoint: AccelSetpointSmooth, a_rel: VRelAccelFiltered, s: PitchPIDState
) -> PitchPIDState:
    e = a_rel[2] - a_setpoint[0]
    i = torch.clamp(s[1] + e * SIM_TIME_STEP * 2, -2.0, 2.0)
    d = e - s[0]
    return torch.stack([e, i, d])


@el.map
def pitch_pid_control(pid: PitchPID, s: PitchPIDState) -> FinControl:
    Kp, Ki, Kd = pid.unbind(-1)
    e, i, d = s.unbind(-1)
    return (Kp * e + Ki * i + Kd * d) * SIM_TIME_STEP


@el.map
def fin_control(fd: FinDeflect, fc: FinControl, mach: Mach) -> FinDeflect:
    fc = torch.clamp(fc / (0.1 + mach), -0.2, 0.2)
    return torch.clamp(fd + fc, -40.0, 40.0)


def build_world() -> el.World:
    w = el.World()
    w.spawn(
        [
            el.Body(
                world_pos=el.SpatialTransform(
                    angular=euler_to_quat([0.0, 70.0, 0.0]),
                    linear=torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64),
                ),
                inertia=el.SpatialInertia(3.0, torch.tensor([0.1, 1.0, 1.0],
                                                            dtype=torch.float64)),
            ),
            Rocket(),
        ],
        name="Rocket",
        id="rocket",
    )
    return w


def build_system() -> el.System:
    effectors = (
        gravity
        | mach
        | compute_v_body
        | angle_of_attack
        | aero_coefs
        | aero_forces
        | apply_aero_forces
        | thrust
        | apply_thrust
    )
    control = (
        v_rel_accel
        | v_rel_accel_buffer
        | v_rel_accel_filtered
        | accel_setpoint_smooth
        | pitch_pid_state
        | pitch_pid_control
        | fin_control
    )
    return control | el.six_dof(sys=effectors, integrator=el.Integrator.Rk4)


if __name__ == "__main__":
    w = build_world()
    w.run(build_system(), simulation_rate=1.0 / SIM_TIME_STEP, max_ticks=120 * 40)
