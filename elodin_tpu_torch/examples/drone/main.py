"""EDU-450 quad-X drone with the whole sensor -> MEKF -> control loop
(counterpart of ``examples/drone/main.py``): a 300 Hz control loop over
a 900 Hz plant fast loop, three semi-implicit six-dof substeps a control
tick, flying an attitude test-point plan.  The flight software sees only
its sensors: the rate PID consumes the filtered, bias-drifting gyro and
the angle loop closes on the MEKF attitude estimate.

The JAX example's ``w.schematic`` (its viewer layout) is left out: the
port has no ``World.schematic``.  This module defines ``@el.system``
functions, so it must not use postponed annotations.
"""

import math

import numpy as np
import torch

import elodin_tpu_torch as el

from .._consts import const
from . import control as ctl
from . import filter as filt
from . import mekf, motors, params, shaping
from . import sensors as sn

SIMULATION_RATE = 300.0  # control rate; the plant substeps at 900 Hz
FAST_DT = 1.0 / 900.0
INNER_RUN_COUNT = 3
SIM_SECONDS = 30.0

MASS_KG = 1.0
INERTIA_DIAG = np.array([0.1, 0.1, 0.2])
DRAG_COEF = 0.2 * 0.5

# Attitude test points (t_s, roll, pitch, yaw_rate): hover, pitch step,
# roll step, mixed, hover.
PLAN = (
    (0.0, 0.0, 0.0, 0.0),
    (6.0, 0.0, 0.3, 0.0),
    (12.0, 0.3, 0.0, 0.0),
    (18.0, -0.2, -0.2, 0.3),
    (24.0, 0.0, 0.0, 0.0),
)

_GRAVITY = np.array([0.0, 0.0, -9.81])


@el.map
def gravity(inertia: el.Inertia, f: el.Force) -> el.Force:
    return f + el.SpatialForce(linear=const(_GRAVITY, inertia.inner) * inertia.mass())


@el.map
def drag(v: el.WorldVel, f: el.Force) -> el.Force:
    rel = -v.linear()
    return f + el.SpatialForce(linear=DRAG_COEF * rel * torch.linalg.norm(rel))


def make_flight_plan():
    ts = np.array([p[0] for p in PLAN])
    vals = np.array([[p[1], p[2], p[3]] for p in PLAN])

    @el.system
    def flight_plan(
        tick: el.Query[el.SimulationTick],
        dt: el.Query[el.SimulationTimeStep],
        q: el.Query[ctl.AngleDesired],
    ) -> el.Query[ctl.AngleDesired]:
        t = tick[0] * dt[0]
        idx = torch.clamp(torch.searchsorted(const(ts, t), t, right=True) - 1, 0, len(PLAN) - 1)
        return q.map(ctl.AngleDesired, lambda _a: const(vals, t)[idx])

    return flight_plan


def build_world(tilt_deg: float = 0.0, alt_m: float = 2.0) -> el.World:
    w = el.World()
    w.spawn(
        [
            el.Body(
                world_pos=el.SpatialTransform(
                    angular=el.Quaternion.from_axis_angle(
                        np.array([1.0, 0.0, 0.0]), math.radians(tilt_deg)
                    ),
                    linear=np.array([0.0, 0.0, alt_m]),
                ),
                inertia=el.SpatialInertia(MASS_KG, INERTIA_DIAG),
            ),
            motors.Motors(),
            sn.IMU(),
            mekf.MEKF(),
            ctl.AttitudeController(),
        ],
        name="drone",
    )
    return w


def build_system(noise: bool = True, flight_plan: bool = False) -> el.System:
    """The flight software at the control rate, then 3 fast-loop substeps
    of plant and sensors, then the MEKF's update."""
    sensor_sys = sn.make_systems(filt, noise=noise)
    fsw = ctl.make_systems(sn, mekf, motors, filt, shaping, params)
    effectors = gravity | drag | motors.wrench
    inner = (
        el.six_dof(FAST_DT, motors.response | effectors, integrator=el.Integrator.SemiImplicit)
        | sensor_sys
    )
    stack = fsw
    for _ in range(INNER_RUN_COUNT):
        stack = stack | inner
    stack = stack | mekf.make_update(sn)
    if flight_plan:
        stack = make_flight_plan() | stack
    return stack
