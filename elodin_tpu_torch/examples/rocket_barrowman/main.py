"""Calisto-style rocket flight on Barrowman aerodynamics, in torch
(counterpart of ``examples/rocket-barrowman/main.py``): the Barrowman CNa
and center of pressure from ``barrowman.py`` drive a weathercocking six-dof,
the normal force at the center of pressure producing the restoring pitch
moment that keeps a statically stable rocket pointed into the wind.

    python -m elodin_tpu_torch.examples.rocket_barrowman.main bench --ticks 20 --device cpu

(This module defines ``@el.system`` functions, so it must not use
postponed annotations.)
"""

import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

from .._consts import const
from .barrowman import calisto, solve, static_margin

SIM_TIME_STEP = 1.0 / 120.0

COMPONENTS, D_REF, XCG = calisto()
AERO = solve(COMPONENTS)
MARGIN_CAL = static_margin(AERO, XCG, D_REF)
S_REF = 3.14159265 * D_REF**2 / 4.0

RHO = 1.225
MASS = 16.2  # Calisto loaded mass, kg
THRUST_N = 1600.0  # Cesaroni M-class average
BURN_TIME_S = 3.9
CD_AXIAL = 0.45
I_PITCH = 6.6  # kg m^2 about CG, slender-body estimate
WIND = np.array([4.0, 0.0, 0.0])

_Z = np.array([0.0, 0.0, 1.0])
_G = np.array([0.0, 0.0, -9.81])

BurnTime = ty.Annotated[torch.Tensor, el.Component("burn_time", el.ComponentType.F64)]


@el.dataclass
class Rocket(el.Archetype):
    burn_time: BurnTime = field(default_factory=lambda: np.float64(0.0))


@el.system
def thrust_and_aero(
    tick: el.Query[el.SimulationTick],
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[el.WorldPos, el.WorldVel, el.Inertia, el.Force],
) -> el.Query[el.Force]:
    t = tick[0] * ts[0]
    # the thrust while burning: JAX's where of two Python numbers, here of
    # two tensors of t's dtype
    thrust_n = torch.where(t < BURN_TIME_S, torch.full_like(t, THRUST_N), torch.zeros_like(t))

    def one(pos, vel, inertia, f):
        m = inertia.mass()
        body_z = pos.angular() @ const(_Z, m)  # nose direction
        v_air = vel.linear() - const(WIND, m)
        speed = torch.linalg.norm(v_air) + 1e-9
        v_hat = v_air / speed
        q_dyn = 0.5 * RHO * speed * speed

        # axial drag + thrust along the body axis while burning
        thrust = thrust_n * body_z
        drag = -q_dyn * CD_AXIAL * S_REF * v_hat

        # Barrowman normal force at the CP: CN = CNa * alpha, perpendicular
        # to the body axis in the (axis, wind) plane
        cos_a = torch.clamp(body_z @ v_hat, -1.0, 1.0)
        alpha = torch.arccos(cos_a)
        n_dir_raw = -(v_hat - cos_a * body_z)
        n_norm = torch.linalg.norm(n_dir_raw) + 1e-9
        n_dir = n_dir_raw / n_norm
        fn = q_dyn * S_REF * AERO.cna * alpha * n_dir

        # restoring torque: normal force acts (Xcp - Xcg) behind the CG
        arm = (AERO.xcp - XCG) * body_z
        torque = torch.linalg.cross(-arm, fn)

        gravity = m * const(_G, m)
        return el.SpatialForce(
            linear=f.force() + thrust + drag + fn + gravity,
            torque=f.torque() + torque,
        )

    return q.map(el.Force, one)


def world() -> el.World:
    w = el.World()
    w.spawn(
        [
            el.Body(
                world_pos=el.SpatialTransform(linear=np.array([0.0, 0.0, 0.1])),
                world_vel=el.SpatialMotion(linear=np.array([0.0, 0.0, 0.5])),
                inertia=el.SpatialInertia(
                    mass=MASS, inertia=np.array([I_PITCH, I_PITCH, 0.08])
                ),
            ),
            Rocket(),
        ],
        name="Calisto",
    )
    return w


def system() -> el.System:
    return el.six_dof(sys=thrust_and_aero)


if __name__ == "__main__":
    print(
        f"Barrowman: CNa={AERO.cna:.3f}/rad  Xcp={AERO.xcp:.3f} m  "
        f"margin={MARGIN_CAL:.2f} cal"
    )
    world().run(system(), simulation_rate=1.0 / SIM_TIME_STEP)
