"""Geo-frames showcase in torch (counterpart of ``examples/geo-frames/sim.py``):
an ENU-anchored world with ECEF landmark markers and spinning bodies, placed
through the geodetic, ECEF and NED transforms of ``elodin_tpu_torch.frames``.
``orbit`` is the JAX example's kinematic circular orbit, which the default
``system()`` leaves out, as there.  (This module defines ``@el.system``
functions, so it must not use postponed annotations.)

    python -m elodin_tpu_torch.examples.geo_frames.sim bench --ticks 20 --device cpu
"""

import numpy as np
import torch

import elodin_tpu_torch as el
from elodin_tpu_torch import frames

SIM_TIME_STEP = 1.0 / 60.0

LAT_DEG, LON_DEG, ALT_M = 34.72, -86.64, 180.5
WGS84_A_M = 6_378_137.0
WGS84_B_M = 6_356_752.314245
CUBE_SEPARATION_M = 1_500_000.0
ORBIT_RADIUS_M = WGS84_A_M + 1_200_000.0
ORBIT_PERIOD_S = 20.0
SPIN_RATE_RAD_S = float(np.radians(10.0))

ECEF_MARKERS = (
    ("ecef_equator_x_pos", (WGS84_A_M, 0.0, 0.0)),
    ("ecef_equator_y_pos", (0.0, WGS84_A_M, 0.0)),
    ("ecef_equator_x_neg", (-WGS84_A_M, 0.0, 0.0)),
    ("ecef_equator_y_neg", (0.0, -WGS84_A_M, 0.0)),
    ("ecef_north_pole", (0.0, 0.0, WGS84_B_M)),
    ("ecef_south_pole", (0.0, 0.0, -WGS84_B_M)),
)


def ecef_from_enu(east: float, north: float, up: float) -> np.ndarray:
    """ENU offset at the schematic origin -> ECEF, via the frames module
    (geodetic origin + R_ecef_ned rotation; NED = (n, e, -u))."""
    origin = frames.geodetic_to_ecef(
        np.radians(LAT_DEG), np.radians(LON_DEG), ALT_M
    )
    r = frames.ecef_to_ned(np.radians(LAT_DEG), np.radians(LON_DEG))
    ned = np.array([north, east, -up])
    return origin.numpy() + r.numpy().T @ ned


def _body(pos, angular_vel=None) -> el.Body:
    if angular_vel is None:
        angular_vel = np.zeros(3)
    return el.Body(
        world_pos=el.SpatialTransform(linear=np.asarray(pos)),
        world_vel=el.SpatialMotion(angular=np.asarray(angular_vel)),
        inertia=el.SpatialInertia(mass=1.0),
    )


@el.system
def orbit(tick: el.Query[el.SimulationTick],
          ts: el.Query[el.SimulationTimeStep],
          q: el.Query[el.WorldPos]) -> el.Query[el.WorldPos]:
    """Kinematic circular equatorial orbit (unused by default system();
    compose ``orbit | el.six_dof(sys=())`` to animate every body)."""
    theta = 2.0 * torch.pi * (tick[0] * ts[0]) / ORBIT_PERIOD_S

    def pose(pos):
        linear = ORBIT_RADIUS_M * torch.stack(
            [torch.cos(theta), torch.sin(theta), 0.0 * theta]
        )
        return el.SpatialTransform(angular=pos.angular(), linear=linear)

    return q.map(el.WorldPos, pose)


def world() -> el.World:
    w = el.World()
    spin = np.array([0.0, SPIN_RATE_RAD_S, 0.0])
    w.spawn(_body(np.zeros(3), spin), name="ned_origin")
    w.spawn(_body(np.array([CUBE_SEPARATION_M, 0.0, 0.0]), spin),
            name="enu_far_east")
    w.spawn(_body(ecef_from_enu(0.0, 0.0, CUBE_SEPARATION_M), spin),
            name="ecef_far_up")
    for name, pos in ECEF_MARKERS:
        w.spawn(
            el.Body(
                world_pos=el.SpatialTransform(linear=np.asarray(pos)),
                inertia=el.SpatialInertia(mass=1.0),
            ),
            name=name,
        )
    w.schematic(
        f"""
        coordinate frame=ENU lat={LAT_DEG} lon={LON_DEG} alt={ALT_M}
        viewport name=Viewport look_at="ned_origin.world_pos" show_grid=#true
        """
    )
    return w


def system() -> el.System:
    return el.six_dof(sys=())


if __name__ == "__main__":
    world().run(system(), simulation_rate=1.0 / SIM_TIME_STEP)
