"""Frame-correctness regression sim in torch (counterpart of
``examples/frames/main.py``): the sign of gravity in each local frame (a
ball dropped in ENU and in NED) and a symmetric two-body orbit in an
inertial frame, its gravity an explicit-edge fold, whose energy must be
conserved.  Runs as a self-checking script:

    python -m elodin_tpu_torch.examples.frames.main --device cpu

(This module defines ``@el.system`` functions, so it must not use
postponed annotations.)
"""

import argparse

import numpy as np
import torch

import elodin_tpu_torch as el

from .._consts import const

G = 6.6743e-11
SIM_RATE = 120.0


def run_drop(frame: str, ticks: int = 120, device="cuda") -> np.ndarray:
    """Ball drop in ENU (+z up, g = -9.81 z) or NED (+z down, g = +9.81 z):
    the ball's z at every tick."""
    sign = -1.0 if frame == "ENU" else 1.0
    z0 = 10.0 * -sign  # start 10 units 'up' in both conventions
    g = np.array([0.0, 0.0, sign * 9.81])

    w = el.World()
    w.spawn(
        el.Body(
            world_pos=el.WorldPos(linear=np.array([0.0, 0.0, z0])),
            inertia=el.Inertia(1.0),
        ),
        name="ball",
    )

    @el.map
    def gravity(inertia: el.Inertia, f: el.Force) -> el.Force:
        return f + el.SpatialForce(linear=const(g, inertia.inner) * inertia.mass())

    exec_ = w.build(el.six_dof(sys=gravity), simulation_rate=SIM_RATE, device=device)
    exec_.run(ticks)
    df = exec_.history("ball.world_pos")
    return np.array([v.to_numpy()[6] for v in df["ball.world_pos"]])


GravityEdge = el.Annotated[el.Edge, el.Component("gravity_edge", el.ComponentType.Edge)]


@el.dataclass
class GravityConstraint(el.Archetype):
    edge: GravityEdge

    def __init__(self, a, b):
        self.edge = GravityEdge(a, b)


@el.system
def gravity(
    graph: el.GraphQuery[GravityEdge],
    q: el.Query[el.WorldPos, el.Inertia],
) -> el.Query[el.Force]:
    def fn(force, a_pos, a_inertia, b_pos, b_inertia):
        rvec = a_pos.linear() - b_pos.linear()
        n = torch.linalg.norm(rvec)
        f = G * a_inertia.mass() * b_inertia.mass() * rvec / n**3
        return el.Force(linear=force.force() - f)

    return graph.edge_fold(q, q, el.Force, el.Force(), fn)


def build_two_body():
    """Symmetric two-body orbit in an inertial frame: (world, system)."""
    w = el.World()
    m = 1.0 / G  # so G*m = 1
    r, v = 1.0, 0.5
    a = w.spawn(
        el.Body(
            world_pos=el.WorldPos(linear=np.array([r, 0.0, 0.0])),
            world_vel=el.WorldVel(linear=np.array([0.0, v, 0.0])),
            inertia=el.Inertia(m),
        ),
        name="a",
    )
    b = w.spawn(
        el.Body(
            world_pos=el.WorldPos(linear=np.array([-r, 0.0, 0.0])),
            world_vel=el.WorldVel(linear=np.array([0.0, -v, 0.0])),
            inertia=el.Inertia(m),
        ),
        name="b",
    )
    w.spawn(GravityConstraint(a, b), name="ab")
    w.spawn(GravityConstraint(b, a), name="ba")
    return w, el.six_dof(sys=gravity)


def total_energy(df, masses=(1.0 / G, 1.0 / G)) -> np.ndarray:
    """Kinetic + gravitational potential for the two-body run."""
    pa = np.stack([v.to_numpy()[4:] for v in df["a.world_pos"]])
    pb = np.stack([v.to_numpy()[4:] for v in df["b.world_pos"]])
    va = np.stack([v.to_numpy()[3:] for v in df["a.world_vel"]])
    vb = np.stack([v.to_numpy()[3:] for v in df["b.world_vel"]])
    ma, mb = masses
    ke = 0.5 * ma * np.sum(va**2, axis=1) + 0.5 * mb * np.sum(vb**2, axis=1)
    pe = -G * ma * mb / np.linalg.norm(pa - pb, axis=1)
    return ke + pe


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    z_enu = run_drop("ENU", device=args.device)
    z_ned = run_drop("NED", device=args.device)
    # the JAX example's asserts, raised whatever the interpreter's -O
    if not z_enu[-1] < z_enu[0]:
        raise AssertionError("ENU: ball should fall toward -z")
    if not z_ned[-1] > z_ned[0]:
        raise AssertionError("NED: ball should fall toward +z")
    np.testing.assert_allclose(z_enu, -z_ned, atol=1e-12)
    print("gravity sign per frame: OK")

    w, sys = build_two_body()
    exec_ = w.build(sys, simulation_rate=SIM_RATE, device=args.device)
    exec_.run(1200)
    df = exec_.history(["a.world_pos", "b.world_pos", "a.world_vel", "b.world_vel"])
    e = total_energy(df)
    drift = abs(e[-1] - e[0]) / abs(e[0])
    if not drift < 1e-6:
        raise AssertionError(f"energy drift {drift:.2e}")
    print(f"two-body energy conservation: OK (drift {drift:.2e} over 10 s)")


if __name__ == "__main__":
    main()
