"""BDX-class RC jet in torch (counterpart of ``examples/rc-jet/sim.py``): a
fixed-wing six-dof with body-axis aerodynamics and an in-graph autopilot.

Vehicle: ~9 kg electric-ducted-fan sport jet.  Aerodynamics use a linear
stability-derivative model (textbook magnitudes for this class): lift, drag
and side force plus roll, pitch and yaw moment derivatives in body axes,
first-order servo lag on [aileron, elevator, rudder, throttle], EDF thrust
with ram falloff.  The autopilot holds airspeed with throttle, altitude
with pitch, and flies heading changes through a coordinated bank.

    python -m elodin_tpu_torch.examples.rc_jet.sim bench --ticks 240 --device cpu

The mission table and the module's vectors are numpy constants, made into
tensors once per device (``_consts.const``); ``jnp.array([a, b, ...])`` of
0-d values is a ``torch.stack``.  (This module defines ``@el.system``
functions, so it must not use postponed annotations.)
"""

import math
import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

from .._consts import const

SIM_RATE_HZ = 240.0
SIM_TIME_STEP = 1.0 / SIM_RATE_HZ

# --- airframe (BDX-class, self-consistent) ----------------------------------
MASS = 9.0
S_WING = 0.60
SPAN = 1.80
CHORD = 0.35
INERTIA = np.array([0.5, 0.8, 1.2])  # Ix, Iy, Iz
RHO = 1.225
G0 = 9.81

# --- aero derivatives (per rad) ----------------------------------------------
CL0, CL_A, CL_DE = 0.20, 5.0, 0.40
CD0, K_IND = 0.035, 0.05
CY_B = -0.30
CM0, CM_A, CM_Q, CM_DE = 0.02, -0.60, -12.0, -1.10
CL_B, CL_P, CL_DA, CL_R = -0.08, -0.45, 0.25, 0.05
CN_B, CN_R, CN_DR, CN_P = 0.07, -0.12, -0.08, -0.02

# --- propulsion + actuators --------------------------------------------------
THRUST_MAX_N = 80.0
RAM_FALLOFF = 0.5  # thrust = T_max*u*(1 - RAM*v/60)
SERVO_TAU_S = 0.05
MAX_DEFLECT_RAD = math.radians(25.0)

CRUISE_SPEED = 35.0
CRUISE_ALT = 120.0

# mission: (t, altitude, heading_deg)
MISSION = [(0.0, 120.0, 90.0), (15.0, 160.0, 90.0), (30.0, 160.0, 180.0)]
# the mission with headings in radians: JAX rebuilds it each call
_MISSION_T = np.array([m[0] for m in MISSION])
_MISSION_ALT_HDG = np.array([[m[1], math.radians(m[2])] for m in MISSION])

_X = np.array([1.0, 0.0, 0.0])
_Y = np.array([0.0, 1.0, 0.0])
_Z = np.array([0.0, 0.0, 1.0])
_GRAVITY = MASS * np.array([0.0, 0.0, -G0])

T = torch.Tensor
Surfaces = ty.Annotated[
    T,
    el.Component("surfaces", el.ComponentType(el.PrimitiveType.F64, (4,)),
                 metadata={"element_names": "da,de,dr,throttle"}),
]
SurfaceCmd = ty.Annotated[
    T,
    el.Component("surface_cmd", el.ComponentType(el.PrimitiveType.F64, (4,))),
]
ApInt = ty.Annotated[
    T,
    el.Component("ap_integral", el.ComponentType(el.PrimitiveType.F64, (3,))),
]
AlphaBeta = ty.Annotated[
    T,
    el.Component("alpha_beta", el.ComponentType(el.PrimitiveType.F64, (2,)),
                 metadata={"element_names": "alpha,beta"}),
]


@el.dataclass
class Jet(el.Archetype):
    surfaces: Surfaces = field(default_factory=lambda: np.array([0.0, 0.0, 0.0, 0.55]))
    surface_cmd: SurfaceCmd = field(default_factory=lambda: np.array([0.0, 0.0, 0.0, 0.55]))
    ap_integral: ApInt = field(default_factory=lambda: np.zeros(3))
    alpha_beta: AlphaBeta = field(default_factory=lambda: np.zeros(2))


def body_axes(q_att):
    """Body axes in the FLU convention our quaternion implies: x nose,
    y LEFT wing, z up (right-handed).  Standard flight-dynamics (FRD)
    quantities are derived with the sign flips noted at each use."""
    like = q_att.inner
    bx = q_att @ const(_X, like)
    by = q_att @ const(_Y, like)
    bz = q_att @ const(_Z, like)
    return bx, by, bz


@el.system
def autopilot(
    tick: el.Query[el.SimulationTick],
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[el.WorldPos, el.WorldVel, ApInt, SurfaceCmd],
) -> el.Query[SurfaceCmd, ApInt]:
    """Airspeed->throttle PI, altitude->pitch->elevator, heading->bank->
    aileron, beta->rudder (the external controller's loops, in-graph)."""
    t = tick[0] * ts[0]
    dt = ts[0]
    idx = torch.clamp(
        torch.searchsorted(const(_MISSION_T, t), t, right=True) - 1, 0, len(MISSION) - 1
    )
    alt_sp, hdg_sp = const(_MISSION_ALT_HDG, t)[idx].unbind(-1)

    def one(pos, vel, integ, _cmd):
        r = pos.linear()
        v = vel.linear()
        w = vel.angular()
        q_att = pos.angular()
        bx, by, bz = body_axes(q_att)
        speed = torch.linalg.norm(v) + 1e-6
        v_b = torch.stack([v @ bx, v @ by, v @ bz])
        # std beta: + wind from the right; our body y is the LEFT wing
        beta = -torch.arcsin(torch.clamp(v_b[1] / speed, -1.0, 1.0))
        # body rates in STANDARD flight-dynamics axes (x fwd, y right,
        # z DOWN): our body frame is FLU, so q_std/r_std flip sign
        p_std = w @ bx
        q_std = -(w @ by)
        r_std = -(w @ bz)

        # airspeed -> throttle (PI)
        err_v = CRUISE_SPEED - speed
        i_v = torch.clamp(integ[0] + err_v * dt, -8.0, 8.0)
        throttle = torch.clamp(0.55 + 0.05 * err_v + 0.01 * i_v, 0.05, 1.0)

        # altitude -> climb-rate -> pitch attitude -> elevator (std signs:
        # de > 0 produces nose-down via CM_DE < 0)
        climb_sp = torch.clamp(0.25 * (alt_sp - r[2]), -4.0, 4.0)
        pitch = torch.arcsin(torch.clamp(bx[2], -1.0, 1.0))
        pitch_sp = torch.clamp(climb_sp / CRUISE_SPEED, -0.30, 0.30)
        err_p = pitch_sp - pitch
        i_p = torch.clamp(integ[1] + err_p * dt, -0.4, 0.4)
        de = torch.clamp(-(0.5 * err_p + 0.15 * i_p) + 0.12 * q_std, -1.0, 1.0)

        # heading -> bank -> aileron; math-convention heading (CCW+), so a
        # left (CCW) turn needs negative standard bank
        hdg = torch.atan2(v[1], v[0])
        err_h = torch.atan2(torch.sin(hdg_sp - hdg), torch.cos(hdg_sp - hdg))
        bank_sp = torch.clamp(-1.2 * err_h, -0.6, 0.6)
        # std bank + right wing down = LEFT wing up = by[2] > 0
        bank = torch.atan2(by[2], bz[2] + 1e-9)
        err_b = bank_sp - bank
        i_b = torch.clamp(integ[2] + err_b * dt, -0.3, 0.3)
        da = torch.clamp(0.3 * err_b + 0.05 * i_b - 0.08 * p_std, -1.0, 1.0)

        # sideslip -> rudder + yaw damping (CN_DR < 0)
        dr = torch.clamp(-0.5 * beta + 0.2 * r_std, -1.0, 1.0)

        return torch.stack([da, de, dr, throttle]), torch.stack([i_v, i_p, i_b])

    return q.map((SurfaceCmd, ApInt), one)


@el.system
def servos(
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[Surfaces, SurfaceCmd],
) -> el.Query[Surfaces]:
    """First-order actuator lag (actuators.py)."""
    dt = ts[0]
    return q.map(
        Surfaces, lambda s, cmd: s + (cmd - s) * (dt / SERVO_TAU_S)
    )


@el.map
def aero_forces(
    pos: el.WorldPos, vel: el.WorldVel, surf: Surfaces, f: el.Force
) -> tuple[el.Force, AlphaBeta]:
    """Body-axis stability-derivative model (aero.py / whitepaper 8.2) +
    EDF thrust + gravity."""
    q_att = pos.angular()
    bx, by, bz = body_axes(q_att)
    v = vel.linear()
    w = vel.angular()
    speed = torch.linalg.norm(v) + 1e-6
    v_b = torch.stack([v @ bx, v @ by, v @ bz])
    alpha = torch.atan2(-v_b[2], v_b[0])
    beta = -torch.arcsin(torch.clamp(v_b[1] / speed, -1.0, 1.0))  # FLU -> std
    # standard-axes body rates (z down); our body frame is FLU
    p_std = w @ bx
    q_std = -(w @ by)
    r_std = -(w @ bz)
    q_dyn = 0.5 * RHO * speed * speed
    da, de, dr = surf[0] * MAX_DEFLECT_RAD, surf[1] * MAX_DEFLECT_RAD, surf[2] * MAX_DEFLECT_RAD

    p_hat = p_std * SPAN / (2.0 * speed)
    q_hat = q_std * CHORD / (2.0 * speed)
    r_hat = r_std * SPAN / (2.0 * speed)

    cl = CL0 + CL_A * alpha + CL_DE * de
    cd = CD0 + K_IND * cl * cl
    cy = CY_B * beta
    cm = CM0 + CM_A * alpha + CM_Q * q_hat + CM_DE * de
    c_roll = CL_B * beta + CL_P * p_hat + CL_DA * da + CL_R * r_hat
    c_yaw = CN_B * beta + CN_R * r_hat + CN_DR * dr + CN_P * p_hat

    # wind axes: drag along -v, lift perpendicular in the (v, body-z) plane
    v_hat = v / speed
    lift_dir_raw = bz - (bz @ v_hat) * v_hat
    lift_dir = lift_dir_raw / (torch.linalg.norm(lift_dir_raw) + 1e-9)
    # std side force is along the RIGHT wing = -by in FLU
    f_aero = q_dyn * S_WING * (cl * lift_dir - cd * v_hat - cy * by)

    # standard moments (m: + nose up about y-right/z-down; n: + nose right)
    # map back into our z-up body frame: y and z torque components negate
    tau_w = q_dyn * S_WING * (
        c_roll * SPAN * bx - cm * CHORD * by - c_yaw * SPAN * bz
    )

    thrust = (THRUST_MAX_N * surf[3]
              * torch.clamp(1.0 - RAM_FALLOFF * speed / 60.0, min=0.2))
    return (
        el.SpatialForce(
            linear=f.force() + f_aero + thrust * bx + const(_GRAVITY, v),
            torque=f.torque() + tau_w,
        ),
        torch.stack([alpha, beta]),
    )


def world() -> el.World:
    w = el.World()
    # trimmed cruise start: level flight east at altitude
    q0 = el.Quaternion.from_axis_angle(np.array([0.0, 0.0, 1.0]), math.radians(90.0))
    w.spawn(
        [
            el.Body(
                world_pos=el.SpatialTransform(
                    angular=q0, linear=np.array([0.0, 0.0, CRUISE_ALT])
                ),
                world_vel=el.SpatialMotion(
                    linear=CRUISE_SPEED * np.array([0.0, 1.0, 0.0])
                ),
                inertia=el.SpatialInertia(mass=MASS, inertia=INERTIA),
            ),
            Jet(),
        ],
        name="BDX",
    )
    return w


def system() -> el.System:
    return (
        autopilot
        | servos
        | el.six_dof(sys=aero_forces, integrator=el.Integrator.SemiImplicit)
    )


if __name__ == "__main__":
    world().run(system(), simulation_rate=SIM_RATE_HZ)
