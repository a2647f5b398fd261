"""Voyager-style interplanetary trajectory with a Jupiter gravity assist, in
torch (counterpart of ``examples/voyager/main.py``): the planets fly
circular ephemerides from public mean elements, computed each tick, and the
probe integrates under Sun and planet gravity with an hour time step.

The probe departs Earth's orbit on a Hohmann-like transfer phased so that it
meets Jupiter near transfer aphelion; the flyby slingshots it onto a
hyperbolic solar-escape trajectory.  (This module defines ``@el.system``
functions, so it must not use postponed annotations.)

    python -m elodin_tpu_torch.examples.voyager.main bench --ticks 20 --device cpu
"""

import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

SIM_TIME_STEP = 3600.0  # 1 h ticks
SIMULATION_RATE_HZ = 1.0 / SIM_TIME_STEP

G = 6.6743e-11
M_SUN = 1.98892e30
MU_SUN = G * M_SUN
AU = 1.495978707e11
YEAR_S = 365.25 * 86400.0

# name, orbit radius (AU), mass (kg)  — public mean elements, circular approx
PLANETS = [
    ("mercury", 0.387, 3.3011e23),
    ("venus", 0.723, 4.8675e24),
    ("earth", 1.000, 5.97219e24),
    ("mars", 1.524, 6.4171e23),
    ("jupiter", 5.203, 1.8982e27),
    ("saturn", 9.537, 5.6834e26),
    ("uranus", 19.19, 8.6810e25),
    ("neptune", 30.07, 1.02413e26),
]

# transfer phasing: Hohmann from 1 AU to Jupiter takes half the transfer
# period; Jupiter must lead Earth by 180 deg minus its own travel angle
_A_T = (1.0 + 5.203) / 2.0
T_TRANSFER_S = 0.5 * np.sqrt(_A_T**3) * YEAR_S
_JUP_PERIOD_Y = np.sqrt(5.203**3)
JUPITER_LEAD_DEG = 180.0 - 360.0 * (T_TRANSFER_S / YEAR_S) / _JUP_PERIOD_Y
# small bias aims the probe at a trailing-side flyby (behind Jupiter) so the
# slingshot adds heliocentric energy; tuned once against the circular model
PHASE_BIAS_DEG = -0.95

PHASE0_DEG = {name: 0.0 for name, _r, _m in PLANETS}
# the probe departs from (1 AU, 0) with Earth a few degrees behind: it has
# already escaped Earth's sphere of influence
PHASE0_DEG["earth"] = -4.0
PHASE0_DEG["jupiter"] = JUPITER_LEAD_DEG + PHASE_BIAS_DEG

ProbeTag = ty.Annotated[
    torch.Tensor, el.Component("probe_tag", el.ComponentType.F64)
]
OrbitRadius = ty.Annotated[
    torch.Tensor, el.Component("orbit_radius", el.ComponentType.F64)
]
OrbitPhase = ty.Annotated[
    torch.Tensor, el.Component("orbit_phase", el.ComponentType.F64)
]
BodyMass = ty.Annotated[torch.Tensor, el.Component("body_mass", el.ComponentType.F64)]


@el.dataclass
class Planet(el.Archetype):
    orbit_radius: OrbitRadius = field(default_factory=lambda: np.float64(AU))
    orbit_phase: OrbitPhase = field(default_factory=lambda: np.float64(0.0))
    body_mass: BodyMass = field(default_factory=lambda: np.float64(0.0))


@el.system
def ephemeris(
    tick: el.Query[el.SimulationTick],
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[OrbitRadius, OrbitPhase, el.WorldPos],
) -> el.Query[el.WorldPos]:
    """Kinematic circular heliocentric orbits."""
    t = tick[0] * ts[0]

    def one(r, phase0, pos):
        omega = torch.sqrt(MU_SUN / r**3)
        th = phase0 + omega * t
        lin = r * torch.stack([torch.cos(th), torch.sin(th), 0.0 * th])
        return el.SpatialTransform(angular=pos.angular(), linear=lin)

    return q.map(el.WorldPos, one)


@el.dataclass
class Probe(el.Archetype):
    probe_tag: ProbeTag = field(default_factory=lambda: np.float64(1.0))


@el.system
def nbody_gravity(
    probe: el.Query[ProbeTag, el.WorldPos, el.Inertia, el.Force],
    bodies: el.Query[OrbitRadius, BodyMass, el.WorldPos],
) -> el.Query[el.Force]:
    """Sun + all-planet point gravity on the probe (the probe is the only
    entity with Force; planets are kinematic)."""
    planet_pos = bodies.bufs[2]
    planet_mass = bodies.bufs[1]

    def one(_tag, pos, inertia, f):
        r = pos.linear()
        m = inertia.mass()
        acc = -MU_SUN * r / torch.linalg.norm(r) ** 3
        d = planet_pos[..., 4:] - r  # (n_planets, 3)
        dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1.0e6)
        acc = acc + torch.sum(
            (G * planet_mass)[:, None] * d / dist[:, None] ** 3, dim=0
        )
        return el.SpatialForce(linear=f.force() + m * acc)

    return probe.map(el.Force, one)


def build() -> tuple[el.World, el.System]:
    w = el.World()
    for name, r_au, mass in PLANETS:
        th = np.radians(PHASE0_DEG[name])
        r = r_au * AU
        w.spawn(
            [
                el.Body(
                    world_pos=el.SpatialTransform(
                        linear=np.array([r * np.cos(th), r * np.sin(th), 0.0])
                    ),
                ),
                Planet(
                    orbit_radius=np.float64(r),
                    orbit_phase=np.float64(th),
                    body_mass=np.float64(mass),
                ),
            ],
            name=name,
        )
    # probe: Earth departure with Hohmann perihelion speed, prograde
    v_peri = np.sqrt(MU_SUN * (2.0 / AU - 1.0 / (_A_T * AU)))
    w.spawn(
        [
            el.Body(
                world_pos=el.SpatialTransform(linear=np.array([AU, 0.0, 0.0])),
                world_vel=el.SpatialMotion(linear=np.array([0.0, v_peri, 0.0])),
                inertia=el.SpatialInertia(mass=825.0),  # Voyager launch mass
            ),
            Probe(),
        ],
        name="voyager",
    )
    w.schematic(
        """
        viewport name=Viewport look_at="voyager.world_pos" show_grid=#true
        """
    )
    sys = (
        ephemeris
        | el.six_dof(sys=nbody_gravity, integrator=el.Integrator.SemiImplicit)
    )
    return w, sys


def specific_energy(r, v):
    return 0.5 * float(np.dot(v, v)) - MU_SUN / float(np.linalg.norm(r))


if __name__ == "__main__":
    w, sysm = build()
    w.run(sysm, simulation_rate=SIMULATION_RATE_HZ)
