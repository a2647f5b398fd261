"""Apollo-style lunar powered descent with ZEM/ZEV guidance, in torch
(counterpart of ``examples/apollo-lander/main.py``).  The guidance law runs
inside the tick, so a dispersed Monte Carlo over initial conditions advances
the whole guided descent of every sample together on the device
(``run_dispersed``, through ``monte_carlo.BatchedCampaign``).

    python -m elodin_tpu_torch.examples.apollo_lander.main bench --ticks 20 --device cpu
    python -m elodin_tpu_torch.examples.apollo_lander.main descend --device cpu
    python -m elodin_tpu_torch.examples.apollo_lander.main dispersed 1024 --seed 0

``descend`` lands ``build_world()`` and holds it to the JAX example's gates;
``dispersed`` prints ``run_dispersed``'s outcome; any other command line
goes to the sim CLI (``World.run``).

Every ``jnp.where`` of the JAX example is a ``torch.where`` here, so the
touchdown latch runs under the campaign's sample ``vmap``.  (This module
defines ``@el.map`` functions, so it must not use postponed annotations.)
"""

import argparse
import json
import sys
import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

from .._consts import const

SIM_RATE = 50.0
DT = 1.0 / SIM_RATE

G_MOON = 1.62
DRY_MASS = 4_700.0
FUEL0 = 8_200.0
MAX_THRUST = 45_000.0  # descent engine, N
ISP = 311.0
G0 = 9.81

TARGET = np.array([0.0, 0.0, 0.0])
T_GO_MIN = 2.0

_G = np.array([0.0, 0.0, -G_MOON])
_SINK = np.array([0.0, 0.0, -1.0])
_FLATTEN = np.array([1.0, 1.0, 0.0])

T = torch.Tensor
Fuel = ty.Annotated[T, el.Component("fuel", el.ComponentType.F64)]
Throttle = ty.Annotated[T, el.Component("throttle", el.ComponentType.F64)]
TGo = ty.Annotated[T, el.Component("t_go", el.ComponentType.F64)]
Landed = ty.Annotated[T, el.Component("landed_vz", el.ComponentType.F64)]
LandedVlat = ty.Annotated[T, el.Component("landed_vlat", el.ComponentType.F64)]


@el.dataclass
class Lander(el.Archetype):
    fuel: Fuel = field(default_factory=lambda: np.float64(FUEL0))
    throttle: Throttle = field(default_factory=lambda: np.float64(0.0))
    t_go: TGo = field(default_factory=lambda: np.float64(110.0))
    landed_vz: Landed = field(default_factory=lambda: np.float64(0.0))
    landed_vlat: LandedVlat = field(default_factory=lambda: np.float64(0.0))


@el.map
def zem_zev_guidance(
    pos: el.WorldPos, vel: el.WorldVel, inertia: el.Inertia, fuel: Fuel,
    t_go_state: TGo,
) -> tuple[Throttle, TGo, el.Force]:
    """ZEM/ZEV guidance: a = 6*ZEM/t_go^2 - 2*ZEV/t_go with the classic
    counting-down time-to-go (fixed-final-time formulation); below 400 m a
    terminal velocity funnel with vertical thrust priority."""
    r = pos.linear()
    v = vel.linear()
    m = inertia.mass()
    g = const(_G, r)

    t_go = torch.clamp(t_go_state, min=T_GO_MIN)

    zem = const(TARGET, r) - (r + v * t_go + 0.5 * g * t_go**2)
    zev = const(_SINK, r) - (v + g * t_go)
    # gravity is inside the ZEM/ZEV drift prediction and applied as its own
    # force below, so it is not subtracted here
    a_cmd = 6.0 * zem / t_go**2 - 2.0 * zev / t_go

    # terminal phase: below 300 m track a feasibility-limited velocity
    # funnel vz = -0.09 z (decel demand k^2 z stays under the lunar T/W)
    z = r[2]
    # lateral-cleanup hold: while the horizontal offset is still large
    # below 80 m, slow the funnel so the lateral loop closes first
    hold = torch.clamp(1.0 - (torch.linalg.norm(r[:2]) - 3.0) / 40.0, 0.25, 1.0)
    # blend the hold in over 80->60 m: a hard step in vz_target would
    # saturate the engine vertically and leave no lateral budget
    funnel_scale = 1.0 + (hold - 1.0) * torch.clamp((80.0 - z) / 20.0, 0.0, 1.0)
    vz_target = -torch.clamp(0.09 * z * funnel_scale, min=1.0)
    # the position chase fades out below ~60 m so the lateral velocity
    # decays before touchdown; the vertical loop has thrust priority and
    # the lateral demand is clipped to the budget it leaves
    k_pos = 0.10 * torch.clamp((z - 4.0) / 45.0, 0.0, 1.0)
    a_vert = G_MOON + 1.5 * (vz_target - v[2])
    a_max = MAX_THRUST / m
    lat_budget = 0.9 * torch.sqrt(
        torch.clamp(a_max**2 - a_vert**2, min=1e-6)
    )
    a_lat = -k_pos * r[:2] - 0.5 * v[:2]
    lat_mag = torch.linalg.norm(a_lat)
    a_lat = a_lat * torch.clamp(lat_budget / torch.clamp(lat_mag, min=1e-9), max=1.0)
    a_term = torch.cat([a_lat, a_vert[None]])
    terminal = z < 400.0
    a_total = torch.where(terminal, a_term, a_cmd)

    f_cmd = a_total * m
    f_mag = torch.linalg.norm(f_cmd)
    zero = torch.zeros_like(f_mag)
    throttle = torch.clamp(f_mag / MAX_THRUST, 0.0, 1.0)
    throttle = torch.where(fuel <= 0.0, zero, throttle)
    # thrust only when above ground
    throttle = torch.where(z > 0.05, throttle, zero)
    direction = f_cmd / torch.clamp(f_mag, min=1.0)
    force = el.SpatialForce(
        linear=direction * throttle * MAX_THRUST + g * m
    )
    return throttle, torch.clamp(t_go_state - DT, min=T_GO_MIN), force


@el.map
def burn_fuel(throttle: Throttle, fuel: Fuel, inertia: el.Inertia) -> tuple[Fuel, el.Inertia]:
    mdot = MAX_THRUST * throttle / (ISP * G0)
    new_fuel = torch.clamp(fuel - mdot * DT, min=0.0)
    m = DRY_MASS + new_fuel
    zero = torch.zeros_like(m)
    return new_fuel, el.SpatialInertia.from_array(
        torch.stack([m, m, m, zero, zero, zero, m])
    )


@el.map
def ground(
    pos: el.WorldPos, vel: el.WorldVel, landed: Landed, vlat: LandedVlat
) -> tuple[el.WorldPos, el.WorldVel, Landed, LandedVlat]:
    """Touchdown: the first tick at or below the ground latches the
    vertical and lateral speeds, and the lander stays on the surface."""
    z = pos.linear()[2]
    hit = z <= 0.0
    first = torch.logical_and(hit, landed == 0.0)
    landed2 = torch.where(first, vel.linear()[2], landed)
    vlat2 = torch.where(first, torch.linalg.norm(vel.linear()[:2]), vlat)
    lin = pos.linear()
    new_pos = el.SpatialTransform(
        angular=pos.angular(),
        linear=torch.where(hit, lin * const(_FLATTEN, lin), lin),
    )
    new_vel = el.SpatialMotion(
        angular=vel.angular(),
        linear=torch.where(hit, torch.zeros_like(vel.linear()), vel.linear()),
    )
    return new_pos, new_vel, landed2, vlat2


def build_world(offset=(-450.0, 200.0), altitude=2_000.0, vel0=(60.0, -15.0, -35.0)):
    w = el.World()
    m0 = DRY_MASS + FUEL0
    w.spawn(
        [
            el.Body(
                world_pos=el.WorldPos(
                    linear=np.array([offset[0], offset[1], altitude])
                ),
                world_vel=el.WorldVel(linear=np.array(vel0)),
                inertia=el.Inertia(m0),
            ),
            Lander(),
        ],
        name="eagle",
    )
    return w


def build_system() -> el.System:
    # guidance is the six_dof effector (runs after clear_forces); gravity is
    # folded into the guidance force
    return el.six_dof(
        sys=zem_zev_guidance, integrator=el.Integrator.SemiImplicit
    ) | burn_fuel | ground


def descend(device="cuda", ticks: int = int(180 * SIM_RATE)) -> dict:
    """The guided soft landing of ``build_world()``: its touchdown speed,
    miss distance and fuel left, held to the JAX example's gates."""
    exec_ = build_world().build(build_system(), simulation_rate=SIM_RATE, device=device)
    exec_.run(ticks)
    df = exec_.history(["eagle.world_pos", "eagle.landed_vz", "eagle.fuel"])
    pos = np.asarray(df["eagle.world_pos"][-1])
    td = float(np.asarray(df["eagle.landed_vz"][-1]))
    fuel = float(np.asarray(df["eagle.fuel"][-1]))
    miss = float(np.linalg.norm(pos[4:6]))
    print(f"touchdown: vz={td:.2f} m/s, miss={miss:.1f} m, fuel left {fuel:.0f} kg")
    # the JAX example's asserts, raised whatever the interpreter's -O
    if not td < 0.0:
        raise AssertionError("never landed")
    if not td > -3.0:
        raise AssertionError(f"hard landing {td}")
    if not miss < 10.0:
        raise AssertionError(f"missed the target by {miss} m")
    return {"touchdown_vz": td, "miss_m": miss, "fuel_kg": fuel}


def dispersions(n_samples: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The dispersed approach states, drawn as the JAX example draws them
    (``np.random.default_rng(seed)``), as the campaign's overrides."""
    rng = np.random.default_rng(seed)
    n = n_samples
    offsets = rng.uniform([-700, -300], [-200, 300], (n, 2))
    alts = rng.uniform(1700, 2300, n)
    vels = rng.uniform([40, -25, -45], [80, -5, -25], (n, 3))
    pos0 = np.concatenate(
        [np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)), offsets, alts[:, None]], axis=1
    )
    vel0 = np.concatenate([np.zeros((n, 3)), vels], axis=1)
    return {"eagle.world_pos": pos0, "eagle.world_vel": vel0}


def make_campaign(n_samples: int = 1024, seed: int = 0, device="cuda"):
    """The dispersed descent as a ``BatchedCampaign`` on ``device``."""
    from ...monte_carlo import BatchedCampaign

    return BatchedCampaign(
        build_world(), build_system(), n_samples,
        overrides=dispersions(n_samples, seed),
        simulation_rate=SIM_RATE, device=device,
    )


def scores(result) -> dict[str, np.ndarray]:
    """Per sample: the touchdown speeds, the final position and fuel, landed
    and soft (the envelope: vertical above -3 m/s, horizontal under 1 m/s,
    fuel left)."""
    td = result.component("eagle.landed_vz")
    vlat = result.component("eagle.landed_vlat")
    final = result.component("eagle.world_pos")[:, 4:]
    fuel = result.component("eagle.fuel")
    landed = td < 0.0
    soft = landed & (td > -3.0) & (vlat < 1.0) & (fuel > 0.0)
    return {"landed_vz": td, "landed_vlat": vlat, "final": final, "fuel": fuel,
            "landed": landed, "soft": soft}


def run_dispersed(n_samples: int = 1024, seed: int = 0, ticks=int(180 * SIM_RATE),
                  device="cuda") -> dict:
    """Batched Monte Carlo over dispersed approach states: the JAX
    example's outcome dict."""
    result = make_campaign(n_samples, seed, device).run(ticks)
    s = scores(result)
    landed, td = s["landed"], s["landed_vz"]
    miss = np.linalg.norm(s["final"][:, :2], axis=1)
    return {
        "n_samples": n_samples,
        "wall_s": result.wall_seconds,
        "landed_frac": float(landed.mean()),
        "soft_frac": float(s["soft"].mean()),
        "mean_td_vz": float(td[landed].mean()) if landed.any() else None,
        "p95_miss_m": float(np.percentile(miss[landed], 95)) if landed.any() else None,
        "min_fuel_kg": float(s["fuel"].min()),
    }


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("descend", "dispersed"):
        build_world().run(build_system(), simulation_rate=SIM_RATE)
        return
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("command", choices=("descend", "dispersed"))
    ap.add_argument("n_samples", type=int, nargs="?", default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.command == "dispersed":
        print(json.dumps(run_dispersed(args.n_samples, args.seed, device=args.device)))
    else:
        print(json.dumps(descend(args.device)))


if __name__ == "__main__":
    main()
