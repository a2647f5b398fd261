"""Bouncing ball in ENU with wind and drag in torch (counterpart of
``examples/ball/sim.py``): gravity, quadratic drag against a wind drawn
from the entity's seed with JAX's threefry (``ops.threefry``), and a
ground bounce, stepped by ``six_dof`` (RK4).

The JAX example's ``lax.cond`` in ``bounce`` is a ``torch.where`` over both
branches, which are cheap and finite.  (This module defines
``@el.map`` functions, so it must not use postponed annotations.)
"""

import typing
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

from ...ops import threefry
from .._consts import const

SIM_TIME_STEP = 1.0 / 120.0
BALL_RADIUS = 0.2
BOUNCINESS = 0.85

Wind = typing.Annotated[
    torch.Tensor,
    el.Component(
        "wind",
        el.ComponentType(el.PrimitiveType.F64, (3,)),
        metadata={"element_names": "x,y,z"},
    ),
]

_GRAVITY = np.array([0.0, 0.0, -9.81])
_FLIP_Z = np.array([1.0, 1.0, -1.0])


@el.dataclass
class WindData(el.Archetype):
    seed: el.Seed = field(default_factory=lambda: np.int64(0))
    wind: Wind = field(default_factory=lambda: np.zeros(3))


def world(seed: int = 0) -> el.World:
    w = el.World()
    w.spawn(
        [
            el.Body(world_pos=el.SpatialTransform(
                linear=torch.tensor([0.0, 0.0, 6.0], dtype=torch.float64))),
            WindData(seed=np.int64(seed)),
        ],
        name="ball",
    )
    w.schematic(
        """
        coordinate frame=ENU
        viewport name=Viewport pos="(0,0,0,0, 8,2,4)" look_at="(0,0,0,0, 0,0,3)"
        object_3d frame="ENU" ball.world_pos { sphere radius=0.2 { color orange } }
        """,
        "ball.kdl",
    )
    return w


@el.map
def gravity(f: el.Force, inertia: el.Inertia) -> el.Force:
    m = inertia.mass()
    return f + el.SpatialForce(linear=const(_GRAVITY, m) * m)


@el.map
def bounce(p: el.WorldPos, v: el.WorldVel) -> el.WorldVel:
    # the JAX example's lax.cond, as a select over both branches
    hit = torch.maximum(p.linear()[2], v.linear()[2]) < 0.0
    bounced = el.SpatialMotion(linear=v.linear() * const(_FLIP_Z, v.inner) * BOUNCINESS)
    return el.SpatialMotion.from_array(torch.where(hit, bounced.inner, v.inner))


@el.map
def sample_wind(s: el.Seed, _w: Wind) -> Wind:
    return threefry.normal(threefry.key(s), (3,), torch.float64)


@el.map
def apply_drag(w: Wind, v: el.WorldVel, f: el.Force) -> el.Force:
    rel = w - v.linear()
    cd = 0.5
    rho = 1.225
    speed = torch.linalg.vector_norm(rel)
    area = 2 * 3.1415 * BALL_RADIUS**2
    # speed * rel, not speed^2 * unit(rel): a wind equal to the velocity
    # gives 0, not 0/0
    drag_force = 0.5 * cd * rho * area * speed * rel
    return f + el.SpatialForce(linear=drag_force)


def system() -> el.System:
    effectors = gravity | apply_drag
    return sample_wind | bounce | el.six_dof(sys=effectors)


def build_world() -> el.World:
    """The seed-0 world, as ``scripts/export_example.py`` builds it."""
    return world()


def build_system() -> el.System:
    return system()


if __name__ == "__main__":
    world().run(system(), simulation_rate=1.0 / SIM_TIME_STEP, max_ticks=1200)
