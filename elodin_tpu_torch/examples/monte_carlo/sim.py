"""Booster landing burn for dispersed Monte Carlo campaigns, in torch
(counterpart of ``examples/monte-carlo/sim.py``): a vehicle under gravity,
drag and a suicide-burn thrust controller, with campaign parameters
dispersing its initial state and properties.  Every system keeps the JAX
example's arithmetic in the same order.  (This module defines ``@el.map``
functions, so it must not use postponed annotations.)
"""

import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

from .._consts import const

PROPELLANT0_KG = 6000.0  # initial propellant load (single source of truth)

SIMULATION_RATE_HZ = 120.0
SIM_TIME_STEP = 1.0 / SIMULATION_RATE_HZ
DEFAULT_MAX_TICKS = 2400  # 20 s

G0 = 9.81

PARAMS = dict(
    start_altitude=el.monte_carlo.Param(float, default=2000.0, min=1500.0, max=2500.0),
    start_vz=el.monte_carlo.Param(float, default=-150.0, min=-200.0, max=-120.0),
    wind_x=el.monte_carlo.Param(float, default=0.0, min=-15.0, max=15.0),
    thrust_eff=el.monte_carlo.Param(float, default=1.0, min=0.92, max=1.05),
    dry_mass=el.monte_carlo.Param(float, default=25_000.0, min=24_000.0, max=27_000.0),
)

T = torch.Tensor
Wind = ty.Annotated[T, el.Component(
    "wind", el.ComponentType(el.PrimitiveType.F64, (3,)), metadata={"element_names": "x,y,z"})]
Propellant = ty.Annotated[T, el.Component("propellant", el.ComponentType.F64)]
ThrustCmd = ty.Annotated[T, el.Component("thrust_cmd", el.ComponentType.F64)]
ThrustEff = ty.Annotated[T, el.Component("thrust_eff", el.ComponentType.F64)]
Touchdown = ty.Annotated[T, el.Component("touchdown_vz", el.ComponentType.F64)]

MAX_THRUST = 845_000.0  # single Merlin-class engine, N
ISP = 282.0
CD_A = 10.0  # drag area * coefficient

_GRAVITY_DIR = np.array([0.0, 0.0, -G0])
_UP = np.array([0.0, 0.0, 1.0])
_HORIZONTAL = np.array([1.0, 1.0, 0.0])


@el.dataclass
class Booster(el.Archetype):
    wind: Wind = field(default_factory=lambda: np.zeros(3))
    propellant: Propellant = field(default_factory=lambda: np.float64(PROPELLANT0_KG))
    thrust_cmd: ThrustCmd = field(default_factory=lambda: np.float64(0.0))
    thrust_eff: ThrustEff = field(default_factory=lambda: np.float64(1.0))
    touchdown_vz: Touchdown = field(default_factory=lambda: np.float64(0.0))


@el.map
def landing_guidance(
    pos: el.WorldPos, vel: el.WorldVel, inertia: el.Inertia, prop: Propellant
) -> ThrustCmd:
    """Suicide-burn trigger: full throttle when stopping distance matches
    altitude; proportional braking below."""
    z = pos.linear()[2]
    vz = vel.linear()[2]
    m = inertia.mass()
    a_net = MAX_THRUST / m - G0
    stop_dist = vz * vz / (2.0 * torch.clamp(a_net, min=1.0))
    # required deceleration to null vz exactly at the pad (+2m margin)
    a_req = vz * vz / (2.0 * torch.clamp(z - 2.0, min=1.0)) + G0
    burn = torch.logical_and(vz < -2.0, z < stop_dist * 1.15)
    zero = torch.zeros_like(z)
    throttle = torch.where(burn, torch.clamp(m * a_req / MAX_THRUST, 0.0, 1.0), zero)
    return torch.where(prop <= 0.0, zero, throttle)


@el.map
def forces(
    pos: el.WorldPos,
    vel: el.WorldVel,
    inertia: el.Inertia,
    wind: Wind,
    throttle: ThrustCmd,
    eff: ThrustEff,
    f: el.Force,
) -> el.Force:
    m = inertia.mass()
    gravity = const(_GRAVITY_DIR, m) * m
    rel = vel.linear() - wind
    speed = torch.linalg.norm(rel)
    rho = 1.225 * torch.exp(-pos.linear()[2] / 8500.0)
    drag = -0.5 * rho * CD_A * speed * rel
    thrust = const(_UP, m) * MAX_THRUST * throttle * eff
    above_ground = pos.linear()[2] > 0.0
    total = torch.where(above_ground, gravity + drag + thrust, torch.zeros_like(gravity))
    return el.SpatialForce(linear=f.force() + total)


@el.map
def burn_propellant(
    throttle: ThrustCmd, prop: Propellant, inertia: el.Inertia, eff: ThrustEff
) -> tuple[Propellant, el.Inertia]:
    mdot = MAX_THRUST * throttle * eff / (ISP * G0)
    new_prop = torch.clamp(prop - mdot * SIM_TIME_STEP, min=0.0)
    dm = prop - new_prop
    m = inertia.mass() - dm
    diag = inertia.inertia_diag()
    return new_prop, el.SpatialInertia.from_array(
        torch.cat([diag, torch.zeros_like(diag), m.unsqueeze(-1)]))


@el.map
def ground_clamp(pos: el.WorldPos, vel: el.WorldVel,
                 td: Touchdown) -> tuple[el.WorldPos, el.WorldVel, Touchdown]:
    """Clamp at the pad and latch touchdown velocity."""
    z = pos.linear()[2]
    landed = z <= 0.0
    td_new = torch.where(torch.logical_and(landed, td == 0.0), vel.linear()[2], td)
    new_pos = el.SpatialTransform(
        angular=pos.angular(),
        linear=torch.where(landed, pos.linear() * const(_HORIZONTAL, z), pos.linear()),
    )
    new_vel = el.SpatialMotion(
        angular=vel.angular(),
        linear=torch.where(landed, torch.zeros_like(vel.linear()), vel.linear()),
    )
    return new_pos, new_vel, td_new


def build(params=None) -> tuple[el.World, el.System]:
    p = {k: (params.get(k, v.default) if params else v.default) for k, v in PARAMS.items()}
    w = el.World()
    wet_mass = p["dry_mass"] + PROPELLANT0_KG
    w.spawn(
        [
            el.Body(
                world_pos=el.WorldPos(linear=np.array([0.0, 0.0, p["start_altitude"]])),
                world_vel=el.WorldVel(linear=np.array([3.0, 0.0, p["start_vz"]])),
                inertia=el.Inertia(wet_mass),
            ),
            Booster(
                wind=np.array([p["wind_x"], 0.0, 0.0]),
                thrust_eff=np.float64(p["thrust_eff"]),
            ),
        ],
        name="booster",
    )
    sys = landing_guidance | el.six_dof(
        sys=forces, integrator=el.Integrator.SemiImplicit
    ) | burn_propellant | ground_clamp
    return w, sys
