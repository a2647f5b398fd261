"""Sensor-camera bouncing-balls room in torch (counterpart of
``examples/sensor-camera/main.py``): balls bounce in a walled room, and two
of them carry sensor cameras at different frame rates.  The frames are
rendered by the editor; the sim registers the cameras' configs with
``World.sensor_camera`` as assets.  (This module defines ``@el.map``
functions, so it must not use postponed annotations.)

    python -m elodin_tpu_torch.examples.sensor_camera.main bench --ticks 20 --device cpu
"""

import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

from .._consts import const

SIM_TIME_STEP = 1.0 / 120.0
BALL_RADIUS = 0.3
BOUNDARY = 5.0
BOUNCINESS = 0.95
FRICTION = 0.05

SCENE_FPS = 60.0
THERMAL_FPS = 30.0
SCENE_LATENCY_US = 16_667
THERMAL_LATENCY_US = 33_333

BallSeed = ty.Annotated[torch.Tensor, el.Component("ball_seed", el.ComponentType.F64)]

_GRAVITY = np.array([0.0, 0.0, -9.81])
_LO = np.array([-BOUNDARY, -BOUNDARY, BALL_RADIUS])
_HI = np.array([BOUNDARY, BOUNDARY, 2.0 * BOUNDARY])


@el.dataclass
class BallTag(el.Archetype):
    ball_seed: BallSeed = field(default_factory=lambda: np.float64(0.0))


@el.map
def gravity(f: el.Force, inertia: el.Inertia) -> el.Force:
    m = inertia.mass()
    return f + el.SpatialForce(linear=m * const(_GRAVITY, m))


@el.map
def bounce_walls(pos: el.WorldPos, vel: el.WorldVel) -> tuple[el.WorldPos, el.WorldVel]:
    """Reflect off the six room walls with restitution and tangential
    friction."""
    p = pos.linear()
    v = vel.linear()
    lo, hi = const(_LO, p), const(_HI, p)
    hit_lo = p < lo
    hit_hi = p > hi
    hit = hit_lo | hit_hi
    v_new = torch.where(hit, -v * BOUNCINESS, v * (1.0 - FRICTION * SIM_TIME_STEP))
    p_new = torch.clamp(p, lo, hi)
    return (
        el.SpatialTransform(angular=pos.angular(), linear=p_new),
        el.SpatialMotion(angular=vel.angular(), linear=v_new),
    )


def world(n_balls: int = 8) -> el.World:
    rng = np.random.default_rng(12)
    w = el.World()
    cam_entities = {}
    for i in range(n_balls):
        p0 = rng.uniform([-3, -3, 2], [3, 3, 8])
        v0 = rng.uniform(-3, 3, 3)
        eid = w.spawn(
            [
                el.Body(
                    world_pos=el.SpatialTransform(linear=np.asarray(p0)),
                    world_vel=el.SpatialMotion(linear=np.asarray(v0)),
                    inertia=el.SpatialInertia(mass=1.0),
                ),
                BallTag(ball_seed=np.float64(i)),
            ],
            name=f"Ball {i}",
        )
        cam_entities[i] = eid
    w.sensor_camera(
        entity=cam_entities[0], name="scene_cam", width=256, height=256,
        fov=90.0, format="rgba", fps=SCENE_FPS,
        latency_us=SCENE_LATENCY_US,
    )
    w.sensor_camera(
        entity=cam_entities[1], name="thermal_cam", width=128, height=128,
        fov=90.0, format="thermal", fps=THERMAL_FPS,
        latency_us=THERMAL_LATENCY_US,
    )
    w.schematic(
        """
        hsplit {
            viewport name=Viewport look_at="(0,0,0,0, 0,0,2)" show_grid=#true
            vsplit {
                sensor_view "ball_0.scene_cam" name="RGB Camera"
                sensor_view "ball_1.thermal_cam" name="Thermal Camera"
            }
        }
        """
    )
    return w


def system() -> el.System:
    return el.six_dof(sys=gravity) | bounce_walls


if __name__ == "__main__":
    world().run(system(), simulation_rate=1.0 / SIM_TIME_STEP)
