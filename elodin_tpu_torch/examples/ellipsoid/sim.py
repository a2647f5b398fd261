"""Sensor-camera frustum and ellipsoid demo in torch (counterpart of
``examples/ellipsoid/sim.py``): a drone flies a Lissajous wobble path
inside an ellipsoid shell, and the sensor camera it carries is registered
for the editor, which draws its frustum.  The drone's pose is a function
of the tick, written by ``lissajous_path`` each tick.  (This module defines
``@el.system`` functions, so it must not use postponed annotations.)

    python -m elodin_tpu_torch.examples.ellipsoid.sim bench --ticks 20 --device cpu
"""

import typing as ty

import numpy as np
import torch

import elodin_tpu_torch as el

SIM_RATE = 120.0
SIM_TIME_STEP = 1.0 / SIM_RATE
SENSOR_CAMERA_FPS = SIM_RATE / 4.0
DRONE_NAME = "drone"
ELLIPSOID_SCALE = np.array([0.9, 0.9, 0.38])
DRONE_PATH_RADIUS = np.array([0.12, 0.08, 0.03])
DRONE_PATH_RATE = 0.35
DRONE_WOBBLE_RATE = 1.8


PathPhase = ty.Annotated[
    torch.Tensor, el.Component("path_phase", el.ComponentType(el.PrimitiveType.F64, ()))
]


@el.system
def lissajous_path(tick: el.Query[el.SimulationTick],
                   ts: el.Query[el.SimulationTimeStep],
                   q: el.Query[PathPhase, el.WorldPos]) -> el.Query[el.WorldPos]:
    """The drone's pose as a function of simulation time.  Only entities
    carrying ``path_phase`` (the drone) are driven."""
    t = tick[0] * ts[0]
    rx, ry, rz = (float(r) for r in DRONE_PATH_RADIUS)

    def pose(phase, _pos):
        angle = t * DRONE_PATH_RATE + phase
        wobble = t * DRONE_WOBBLE_RATE
        lin = torch.stack(
            [
                rx * torch.sin(angle),
                ry * torch.sin(angle * 0.7 + 0.8),
                rz * torch.sin(angle * 1.3),
            ]
        )
        roll = 0.55 * torch.sin(wobble)
        pitch = 0.38 * torch.sin(wobble * 0.8 + 0.4)
        yaw = angle + 0.6 * torch.sin(wobble * 0.55)
        quat = el.Quaternion.from_euler(torch.stack([roll, pitch, yaw]))
        return el.SpatialTransform(angular=quat, linear=lin)

    return q.map(el.WorldPos, pose)


@el.dataclass
class DronePath(el.Archetype):
    path_phase: PathPhase


def world() -> tuple[el.World, el.EntityId]:
    w = el.World()
    body = w.spawn(
        el.Body(
            world_pos=el.SpatialTransform(linear=np.zeros(3)),
            inertia=el.SpatialInertia(mass=1.0),
        ),
        name="ellipsoid",
    )
    drone = w.spawn(
        [
            el.Body(
                world_pos=el.SpatialTransform(linear=np.zeros(3)),
                inertia=el.SpatialInertia(mass=1.0),
            ),
            DronePath(path_phase=np.float64(0.0)),
        ],
        name=DRONE_NAME,
    )
    w.sensor_camera(
        entity=drone,
        name="scene_cam",
        width=128,
        height=128,
        fov=110.0,
        near=0.01,
        far=0.35,
        pos_offset=[0.0, -0.08, 0.08],
        rot_offset=[-5.4, 0.0, 90.0],
        format="rgba",
        fps=SENSOR_CAMERA_FPS,
        create_frustum=True,
    )
    w.schematic(
        f"""
        tabs {{
            hsplit name="Frustums" {{
                viewport name="Viewport Source" look_at="(0,0,0,0, 0,0,0)" create_frustum=#true show_grid=#true near=0.05 far=6.0
                viewport name="Target View" look_at="(0,0,0,0, 0,0,0)" show_frustums=#true show_grid=#true
                sensor_view "drone.scene_cam" name="Sensor Camera"
            }}
        }}
        object_3d eql="ellipsoid.world_pos" {{
            ellipsoid scale="({ELLIPSOID_SCALE[0]}, {ELLIPSOID_SCALE[1]}, {ELLIPSOID_SCALE[2]})" show_grid=#true
        }}
        """,
        "ellipsoid.kdl",
    )
    return w, body


def system() -> el.System:
    return lissajous_path | el.six_dof(sys=())


if __name__ == "__main__":
    w, _body = world()
    w.run(system(), simulation_rate=1.0 / SIM_TIME_STEP)
