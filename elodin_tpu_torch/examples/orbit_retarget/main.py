"""Gradient-based orbit retargeting: differentiate through the simulator
(counterpart of ``examples/orbit-retarget/main.py``).

A spacecraft coasts in the gravity field of a central body; which initial
velocity reaches a target point after T seconds?  Normalised units (mu = 1,
r0 = 1): the craft starts on a circular orbit and must arrive at a point
120 degrees ahead and 40 % farther out, in 70 % of the circular period.
The whole rollout (RK4, the edge-fold gravity, every tick) is
differentiable through ``el.rollout``, and ``solve`` descends the loss with
``torch.optim.Adam`` where the JAX example uses ``optax.adam``: the same
rule (beta 0.9 and 0.999, eps 1e-8 outside the square root, bias
correction), so the iterates agree.  The JAX example writes the override
``col.at[row, 3:].set(v0)``; here the row is rebuilt with ``torch.cat``
and set by ``diff.set_entity``, which writes nothing in place.

    python -m elodin_tpu_torch.examples.orbit_retarget.main [--remat] [--device cpu]

(This module defines ``@el.system`` functions, so it must not use
postponed annotations.)
"""

import argparse
import math
import sys

import torch

import elodin_tpu_torch as el
from elodin_tpu_torch.diff import entity_row, set_entity

SIM_TIME_STEP = 1.0 / 120.0
MU = 1.0  # G * M_central in normalised units
TICKS = 504  # 4.2 s ~ 0.7 circular periods at r=1 (T_circ = 2*pi)
LEARNING_RATE = 3e-2
REMAT_SEGMENTS = 8

GravityEdge = el.Annotated[el.Edge, el.Component("gravity_edge", el.ComponentType.Edge)]


@el.dataclass
class GravityConstraint(el.Archetype):
    a: GravityEdge

    def __init__(self, a: el.EntityId, b: el.EntityId):
        self.a = GravityEdge(a, b)


@el.system
def gravity(
    graph: el.GraphQuery[GravityEdge],
    query: el.Query[el.WorldPos, el.Inertia],
) -> el.Query[el.Force]:
    def gravity_fn(force, a_pos, a_inertia, b_pos, b_inertia):
        r = a_pos.linear() - b_pos.linear()
        m = a_inertia.mass()
        M = b_inertia.mass()
        norm = torch.linalg.norm(r)
        f = M * m * r / (norm * norm * norm)  # G = 1 in normalised units
        return el.Force(linear=force.force() - f)

    return graph.edge_fold(
        left_query=query,
        right_query=query,
        return_type=el.Force,
        init_value=el.Force(),
        fold_fn=gravity_fn,
    )


def build_world() -> el.World:
    w = el.World()
    f64 = torch.float64
    center = w.spawn(
        [
            el.Body(
                world_pos=el.WorldPos(linear=torch.zeros(3, dtype=f64)),
                world_vel=el.WorldVel(linear=torch.zeros(3, dtype=f64)),
                inertia=el.Inertia(MU),  # mass*G = mu
            )
        ],
        name="center",
    )
    craft = w.spawn(
        [
            el.Body(
                world_pos=el.WorldPos(linear=torch.tensor([1.0, 0.0, 0.0], dtype=f64)),
                world_vel=el.WorldVel(linear=torch.tensor([0.0, 1.0, 0.0], dtype=f64)),
                inertia=el.Inertia(1e-9),  # test mass
            )
        ],
        name="craft",
    )
    w.spawn(GravityConstraint(craft, center), name="craft <- center")
    return w


def build_system() -> el.System:
    return el.six_dof(sys=gravity)


def target(device) -> torch.Tensor:
    """The point 120 degrees ahead at radius 1.4."""
    theta = math.radians(120.0)
    return 1.4 * torch.tensor([math.cos(theta), math.sin(theta), 0.0],
                              dtype=torch.float64, device=device)


def make_loss(ticks: int = TICKS, remat_segments: int | None = None, device="cuda"):
    """The squared miss distance as a function of the craft's initial
    linear velocity (3,), over a rollout of ``ticks`` ticks
    (``el.rollout``'s ``remat_segments``)."""
    roll = el.rollout(
        build_world(),
        build_system(),
        ticks,
        outputs=("world_pos",),
        remat_segments=remat_segments,
        simulation_rate=1.0 / SIM_TIME_STEP,
        device=device,
    )
    row = entity_row(roll.meta, "world_pos", "craft")
    goal = target(device)
    v_col0 = roll.initial_state["world_vel"]

    def loss(v0):
        v_col = set_entity(v_col0, roll.meta, "world_vel", "craft",
                           torch.cat([v_col0[row, :3], v0]))
        final = roll({"world_vel": v_col})
        return torch.sum((final["world_pos"][row, 4:] - goal) ** 2)

    return loss


def solve(remat: bool = False, iters: int = 250, verbose: bool = True, device="cuda"):
    """Descend the initial velocity to hit the target point.  Returns
    (v0, miss_distance)."""
    loss = make_loss(TICKS, REMAT_SEGMENTS if remat else None, device)
    v0 = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64, device=device,
                      requires_grad=True)
    opt = torch.optim.Adam([v0], lr=LEARNING_RATE)
    for i in range(iters):
        opt.zero_grad()
        val = loss(v0)
        val.backward()
        opt.step()
        if verbose and (i % 25 == 0 or i == iters - 1):
            print(f"iter {i:4d}  miss = {torch.sqrt(val).item():.3e}  "
                  f"v0 = {v0.detach().cpu().numpy()}")
    with torch.no_grad():
        miss = float(torch.sqrt(loss(v0)))
    return v0.detach(), miss


def main(argv):
    ap = argparse.ArgumentParser(description="Orbit retargeting by gradient descent "
                                             "through the simulator")
    ap.add_argument("--remat", action="store_true",
                    help=f"checkpoint the rollout in {REMAT_SEGMENTS} segments")
    ap.add_argument("--iters", type=int, default=250)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    v0, miss = solve(remat=a.remat, iters=a.iters, device=a.device)
    print(f"converged: miss distance {miss:.3e} (remat={a.remat})")
    print(f"transfer injection velocity: {v0.cpu().numpy()}")
    if a.iters >= 250 and not miss < 1e-3:
        raise SystemExit(f"miss distance {miss:.3e} is not below 1e-3")


if __name__ == "__main__":
    main(sys.argv[1:])
