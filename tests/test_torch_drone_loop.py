"""The JAX package's behaviour gates of the drone (``tests/test_drone.py``),
run on the port on the CPU: the whole loop, noisy sensors -> MEKF ->
angle / rate cascade -> motors, recovers a 20-degree tilt and holds
altitude flying on the estimate; the magnetometer holds its sample at
100 Hz; the accel health score collapses under rotation.  The bounds are
the JAX tests'."""

import numpy as np
import pytest

import elodin_tpu_torch as el
from elodin_tpu_torch.examples.drone import filter as filt
from elodin_tpu_torch.examples.drone import main as d
from elodin_tpu_torch.examples.drone import mekf
from elodin_tpu_torch.examples.drone import sensors as sn
from torch_port_util import float_policy


@pytest.fixture(autouse=True)
def _f64():
    with float_policy("f64"):
        yield


def _read(ex, name):
    return np.asarray(ex.read_component(f"drone.{name}")).ravel()


def _static_rig(tilt_deg: float, noise: bool):
    w = el.World()
    w.spawn(
        [
            el.Body(
                world_pos=el.SpatialTransform(
                    angular=el.Quaternion.from_axis_angle(
                        np.array([1.0, 0.0, 0.0]), np.radians(tilt_deg))),
                inertia=el.SpatialInertia(1.0),
            ),
            sn.IMU(),
            mekf.MEKF(),
        ],
        name="drone",
    )
    ex = w.build(sn.make_systems(filt, noise=noise) | mekf.make_update(sn),
                 simulation_rate=300.0, device="cpu")
    ex.record_history = False
    return ex


def test_hover_under_estimation():
    w = d.build_world(tilt_deg=20.0)
    ex = w.build(d.build_system(noise=True), simulation_rate=d.SIMULATION_RATE, device="cpu")
    ex.record_history = False
    ex.run(int(6 * d.SIMULATION_RATE), show_progress=False)
    pos = _read(ex, "world_pos")
    err = np.degrees(float(_read(ex, "attitude_estimate_error")[0]))
    tilt = 2 * np.degrees(np.arccos(min(abs(pos[3]), 1.0)))
    assert tilt < 2.0, tilt
    assert abs(pos[6] - 2.0) < 0.15, pos[6]
    assert err < 2.0, err


def test_mag_sample_and_hold_rate():
    ex = _static_rig(0.0, noise=True)
    vals = []
    for _ in range(40):
        ex.run(1, show_progress=False)
        vals.append(tuple(_read(ex, "magnetometer")))
    changes = sum(1 for a, b in zip(vals, vals[1:]) if a != b)
    # a 100 Hz magnetometer on a 900 Hz fast loop (3 per 300 Hz control
    # tick) changes at most every 3rd control tick
    assert changes <= 14, changes
    # this rig samples once a tick, so the sensor tick reaches a multiple
    # of the 9-sample hold at ticks 9, 18, 27 and 36 (the JAX rig's count)
    assert changes == 4, changes


def test_accel_health_degrades_under_rotation():
    w = el.World()
    w.spawn(
        [
            el.Body(
                world_pos=el.SpatialTransform(),
                world_vel=el.SpatialMotion(angular=np.array([0.6, 0.0, 0.0])),
                inertia=el.SpatialInertia(1.0),
            ),
            sn.IMU(),
        ],
        name="drone",
    )
    ex = w.build(sn.make_systems(filt, noise=False), simulation_rate=300.0, device="cpu")
    ex.record_history = False
    ex.run(60, show_progress=False)
    assert float(_read(ex, "accel_health")[0]) < 0.05
