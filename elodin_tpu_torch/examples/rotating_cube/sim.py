"""Rotating cube in torch (counterpart of ``examples/rotating-cube/sim.py``):
a constant spin about world +X, stepped by ``six_dof``, under a schematic
with an ENU geodetic origin so the editor's gauges map ``world_pos`` to
latitude, longitude and altitude.

    python -m elodin_tpu_torch.examples.rotating_cube.sim bench --ticks 20 --device cpu
"""

import math

import numpy as np

import elodin_tpu_torch as el

SIM_TIME_STEP = 1.0 / 120.0
SPIN_RATE_RAD_S = math.pi / 2.0  # quarter turn per second about +X

SCHEMATIC = """
coordinate frame=ENU lat=28.6084 lon=-80.6043 alt=3.0
hsplit {
    vsplit share=0.32 {
        geo_position_gauge name="GEO NED" eql="cube.world_pos" source="ENU" display="NED"
        component_monitor name="MONITOR world_pos" component_name="cube.world_pos"
    }
    tabs share=0.44 {
        viewport name=Viewport look_at="cube.world_pos" show_grid=#true
    }
    vsplit share=0.24 {
        orientation_gauge name="ATT NED" eql="cube.world_pos" source="ENU" display="NED"
        orientation_gauge name="ATT ECEF" eql="cube.world_pos" source="ENU" display="ECEF"
    }
}
object_3d eql="cube.world_pos" {
    cube size=0.5
}
"""


def world() -> el.World:
    w = el.World()
    w.spawn(
        el.Body(
            world_pos=el.SpatialTransform(
                angular=el.Quaternion.identity(),
                linear=np.array([0.0, 0.0, 1.0]),
            ),
            world_vel=el.SpatialMotion(
                angular=np.array([SPIN_RATE_RAD_S, 0.0, 0.0])
            ),
            inertia=el.SpatialInertia(1.0),
        ),
        name="Cube",
        id="cube",
    )
    w.schematic(SCHEMATIC)
    return w


def system() -> el.System:
    return el.six_dof(sys=())


if __name__ == "__main__":
    world().run(system(), simulation_rate=1.0 / SIM_TIME_STEP)
