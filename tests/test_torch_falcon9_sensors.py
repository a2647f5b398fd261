"""The port's falcon9 sensor suite (``examples/falcon9/sensors.py`` and
``sim.sensor_suite``) against the JAX package's, on the CPU in f64.

Stated tolerances:

* ``build(None)`` (sensors on), 300 ticks through ``Exec`` in both
  packages: every sensor channel value by value at every tick, |Δ| ≤
  1e-12 of the sample's magnitude (the largest |x| of its vector, at
  least 1e-6: a small component of a vector carries the round-off of the
  whole, as the GPS velocity's east component does); the noise is JAX's
  to a few ulps (``tests/test_torch_threefry.py``);
  ``gps_count`` and ``radar_count`` exactly; every other column to max
  |Δ|/(1+|x|) ≤ 1e-10.
* ``noise`` against the JAX example's ``noise`` over counts and salts: 4
  ulps plus JAX's own erf_inv error against a correctly rounded one (as
  in ``tests/test_torch_threefry.py``); ``noise_streams`` equal to
  ``noise`` bit for bit, also under ``vmap``.
* ``tests/test_falcon9.py``'s four sensor gates, on the port's run.
* The mission without sensors is the mission with them, bit for bit, in
  every column both have (no system reads a sensor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from elodin_tpu_torch.examples.falcon9 import sensors as tsn
from elodin_tpu_torch.examples.falcon9 import sim as tsim
from elodin_tpu_torch.ops import threefry as tf
from torch_port_util import jax_falcon9, mixed_errs

jax.config.update("jax_enable_x64", True)

TICKS, LONG_TICKS = 300, 1000
SENSORS = ("imu_accel", "imu_gyro", "gps_timer", "gps_pos", "gps_vel", "gps_count",
           "radar_timer", "radar_range", "radar_count", "pressure_meas", "display_speed",
           "display_alt")


@pytest.fixture(scope="module")
def runs():
    """(JAX Exec after TICKS ticks, the port's Exec after LONG_TICKS), both
    with history."""
    jsim = jax_falcon9("sim")
    w, s = jsim.build(None)
    jexec = w.build(s, simulation_rate=jsim.SIM_RATE_HZ)
    jexec.run(TICKS)
    w, s = tsim.build(None)
    texec = w.build(s, simulation_rate=tsim.SIM_RATE_HZ, device="cpu")
    texec.run(LONG_TICKS)
    return jexec, texec


def _series(exec_, name, rows):
    comp, row = exec_._history.resolve(f"booster.{name}")
    return np.asarray(exec_._history.series(comp))[:rows, row]


def test_sensor_channels_match_jax_value_by_value(runs):
    jexec, texec = runs
    for name in SENSORS:
        ref = _series(jexec, name, TICKS + 1)
        ours = _series(texec, name, TICKS + 1)
        assert ours.shape == ref.shape, name
        if name in ("gps_count", "radar_count"):
            np.testing.assert_array_equal(ours, ref, err_msg=name)
            continue
        scale = np.abs(ref).reshape(len(ref), -1).max(axis=1)
        bound = 1e-12 * np.maximum(scale, 1e-6).reshape((-1,) + (1,) * (ref.ndim - 1))
        assert (np.abs(ours - ref) <= bound).all(), (name, np.abs(ours - ref).max())
    # the suite ran: GPS and radar fired
    assert _series(texec, "gps_count", TICKS + 1)[-1] > 60
    assert _series(texec, "radar_count", TICKS + 1)[-1] > 60


def test_every_other_column_matches_jax(runs):
    jexec, texec = runs
    ref = {k: np.asarray(jexec._history.series(k))[TICKS] for k in jexec.meta.components
           if k not in SENSORS}
    ours = {k: np.asarray(texec._history.series(k))[TICKS] for k in ref}
    errs = mixed_errs(ours, ref)
    assert max(errs.values()) <= 1e-10, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def test_noise_matches_jax():
    jsn = jax_falcon9("sensors")
    draw = jax.jit(jsn.noise, static_argnums=(1, 2, 3))
    for salt, shape, sigma in ((1, (3,), tsn.IMU_ACCEL_SIGMA), (5, (), tsn.RADAR_SIGMA_M),
                               (6, (4,), tsn.PRESSURE_SIGMA_PA)):
        for count in (0.0, 1.0, 2.0, 37.0, 299.0, 1000.0, 54321.0):
            ref = np.asarray(draw(jnp.float64(count), salt, shape, sigma))
            ours = tsn.noise(torch.tensor(count, dtype=torch.float64), salt, shape, sigma).numpy()
            # JAX's error against sqrt(2) erfinv of the same uniform
            key = tf.fold_in(tf.fold_in(tsn._KEY, salt), int(count))
            u = tf.uniform(key, shape, torch.float64, tf._lowest(torch.float64), 1.0).numpy()
            exact = sigma * np.sqrt(2.0) * scipy.special.erfinv(u)
            allowed = 4 * np.spacing(np.abs(ref)) + np.abs(ref - exact)
            assert (np.abs(ours - ref) <= allowed).all(), (salt, count)


def test_noise_streams_equal_noise_and_run_under_vmap():
    counts = torch.tensor([0.0, 3.0, 17.0, 250.0], dtype=torch.float64)
    tick = torch.tensor(1234, dtype=torch.int64)

    def streams(c):
        return tsn.noise_streams([(tick, 1, (3,), 0.02), (c, 3, (3,), 1.5), (c + 1.0, 5, (), 0.15),
                                  (tick, 6, (4,), 1e3)])

    def one_by_one(c):
        return [tsn.noise(tick, 1, (3,), 0.02), tsn.noise(c, 3, (3,), 1.5),
                tsn.noise(c + 1.0, 5, (), 0.15), tsn.noise(tick, 6, (4,), 1e3)]

    batched = torch.func.vmap(streams)(counts)
    for i, c in enumerate(counts):
        for a, b, v in zip(streams(c), one_by_one(c), batched):
            assert torch.equal(a, b) and torch.equal(v[i], a)


def _at(texec, tick, name):
    return _series(texec, name, tick + 1)[tick].ravel()


def test_imu_earth_rate_gyro_and_specific_force_on_pad(runs):
    _, texec = runs
    gyro, accel = _at(texec, 3, "imu_gyro"), _at(texec, 3, "imu_accel")
    assert abs(np.linalg.norm(gyro) - tsim.OMEGA_EARTH_RADPS) < 5 * tsn.IMU_GYRO_SIGMA
    assert np.linalg.norm(accel) < 5 * tsn.IMU_ACCEL_SIGMA + 1e-6


def test_imu_reads_thrust_specific_force_in_ascent(runs):
    _, texec = runs
    accel = _at(texec, LONG_TICKS, "imu_accel")
    thrust = float(_at(texec, LONG_TICKS, "thrust_total")[0])
    mass = float(_at(texec, LONG_TICKS, "inertia")[6])
    assert thrust > 5e6
    assert abs(accel[0] - thrust / mass) < 0.3
    assert abs(accel[1]) < 0.3 and abs(accel[2]) < 0.3


def test_gps_cadence_and_display_quantization(runs):
    _, texec = runs
    assert abs(float(_at(texec, 100, "gps_count")[0]) - 25.0) <= 1.0
    truth = tsim.to_enu(torch.tensor(_at(texec, 100, "world_pos")[4:7])).numpy()
    assert np.linalg.norm(_at(texec, 100, "gps_pos") - truth) < 25.0
    for name, step in (("display_speed", tsn.DISPLAY_SPEED_STEP),
                       ("display_alt", tsn.DISPLAY_ALT_STEP)):
        v = float(_at(texec, 100, name)[0])
        assert abs(v / step - round(v / step)) < 1e-9


def test_radar_sees_ground_nose_up_on_pad(runs):
    _, texec = runs
    rng = float(_at(texec, 100, "radar_range")[0])
    h_cg = float(tsim.to_enu(torch.tensor(_at(texec, 100, "world_pos")[4:7]))[2])
    assert rng > 0.0
    assert abs(rng - h_cg) < 2.0, (rng, h_cg)
    assert float(_at(texec, 100, "radar_count")[0]) > 0.0


def test_sensors_only_observe(runs):
    _, texec = runs
    ticks = 100
    w, s = tsim.build(None, sensors=False)
    plain = w.build(s, simulation_rate=tsim.SIM_RATE_HZ, device="cpu")
    plain.run(ticks)
    for k in plain.meta.components:
        np.testing.assert_array_equal(plain.column_array(k), texec._history.series(k)[ticks],
                                      err_msg=k)
