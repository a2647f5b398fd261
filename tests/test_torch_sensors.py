"""The port's sensor models (``elodin_tpu_torch.sensors``) against the JAX
package's (``elodin_tpu.sensors``), on the CPU.

Stated tolerances:

* ``coning_sculling_window`` and ``ConingScullingIntegrator`` on seeded
  windows (scalar dt, per-sample dt, f32 samples): ≤ 1e-14 of the output's
  scale (the scan's order of operations; the window's dt sum may round
  differently); the output dtype is JAX's.
* The JAX package's own sensor tests (``tests/test_core.py``: the static
  window, the coning correction beating naive averaging, f32 inputs, the
  IMU bias walk) hold on the port.
* ``imu_measure``, ``magnetometer_measure``, ``gps_measure`` and
  ``barometer_measure`` from the same key: within 4 ulps of each noise
  term (JAX's normals, ``tests/test_torch_threefry.py``) over the signal,
  ≤ 1e-15 of the output's scale.
"""

import jax
import jax.numpy as jnp
import numpy
import numpy as np
import pytest
import torch

from elodin_tpu import sensors as jsensors
from elodin_tpu_torch import sensors as tsensors
from elodin_tpu_torch import spatial as tspatial
from elodin_tpu_torch.ops import threefry as tf

jax.config.update("jax_enable_x64", True)


def _close(ours, ref, tol):
    ours, ref = np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= tol * max(1.0, np.abs(ref).max())


def _windows():
    rng = np.random.default_rng(3)
    gyro, accel = rng.normal(size=(8, 3)), rng.normal(size=(8, 3)) + [0, 0, 9.81]
    return gyro, accel, [1e-3, np.full(8, 1e-3), rng.uniform(1e-4, 2e-3, 8)]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_coning_sculling_window_matches_jax(which):
    gyro, accel, dts = _windows()
    dt = dts[which]
    jg, ja = jsensors.coning_sculling_window(gyro, accel, dt)
    tdt = dt if isinstance(dt, float) else torch.tensor(dt)
    tg, ta = tsensors.coning_sculling_window(torch.tensor(gyro), torch.tensor(accel), tdt)
    _close(tg, jg, 1e-14)
    _close(ta, ja, 1e-14)


def test_coning_sculling_window_f32_dtypes():
    gyro = np.full((16, 3), 0.01, dtype=np.float32)
    accel = np.tile(np.array([0, 0, 9.81], dtype=np.float32), (16, 1))
    dt32 = np.full(16, 1e-3, dtype=np.float32)
    for dt in (dt32, 1e-3):
        jg, ja = jsensors.coning_sculling_window(jnp.asarray(gyro), jnp.asarray(accel),
                                                 jnp.asarray(dt) if not isinstance(dt, float)
                                                 else dt)
        tg, ta = tsensors.coning_sculling_window(
            torch.tensor(gyro), torch.tensor(accel),
            torch.tensor(dt) if not isinstance(dt, float) else dt)
        assert str(tg.dtype).replace("torch.", "") == str(jg.dtype)
        assert torch.isfinite(tg).all() and torch.isfinite(ta).all()
        tol = 1e-6 if tg.dtype == torch.float32 else 1e-14
        _close(tg, jg, tol)
        _close(ta, ja, tol)


def test_coning_sculling_static():
    """Pure rotation about a fixed axis needs no coning correction."""
    n, dt = 8, 1e-3
    gyro = torch.tensor(np.tile([0.5, 0.0, 0.0], (n, 1)))
    accel = torch.tensor(np.tile([0.0, 0.0, 9.81], (n, 1)))
    g, a = tsensors.coning_sculling_window(gyro, accel, dt)
    numpy.testing.assert_allclose(g.numpy(), [0.5, 0, 0], atol=1e-12)
    assert abs(float(a[2]) - 9.81) < 1e-6


def test_coning_correction_improves_attitude():
    """Classic coning motion: naive averaging loses the net z-rotation; the
    Bortz correction recovers it (``tests/test_core.py``'s case)."""
    a_cone, w_cone, fs, n_total, window = 0.05, 200.0, 4000.0, 2000, 8
    dt = 1.0 / fs
    t = np.arange(n_total) * dt
    gyro = torch.tensor(np.stack([a_cone * w_cone * np.cos(w_cone * t),
                                  -a_cone * w_cone * np.sin(w_cone * t),
                                  np.zeros_like(t)], axis=1))
    accel = torch.zeros_like(gyro)
    q_true = tspatial.quat_identity()
    for i in range(n_total):
        q_true = tspatial.quat_integrate_body(q_true, gyro[i] * dt)

    def integrate(correct: bool):
        q = tspatial.quat_identity()
        for s in range(0, n_total, window):
            chunk = gyro[s:s + window]
            if correct:
                g_avg, _ = tsensors.coning_sculling_window(chunk, accel[s:s + window], dt)
            else:
                g_avg = chunk.mean(dim=0)
            q = tspatial.quat_integrate_body(q, g_avg * window * dt)
        return q

    err_naive = 1 - abs(float(torch.dot(integrate(False), q_true)))
    err_corr = 1 - abs(float(torch.dot(integrate(True), q_true)))
    assert err_corr < err_naive * 0.85, (err_naive, err_corr)


def test_integrator_push_emit_matches_jax():
    rng = np.random.default_rng(5)
    jint, tint = jsensors.ConingScullingIntegrator(4), tsensors.ConingScullingIntegrator(4)
    emitted = 0
    for i in range(19):
        g, a = rng.normal(size=3), rng.normal(size=3)
        dt = 0.0 if i == 5 else (0.2 if i == 9 else 1e-3 * (1 + i % 3))
        jout = jint.push(g, a, dt)
        tout = tint.push(torch.tensor(g), torch.tensor(a), dt)
        assert (jout is None) == (tout is None)
        if jout is not None:
            emitted += 1
            _close(tout[0], jout[0], 1e-14)
            _close(tout[1], jout[1], 1e-14)
    assert emitted == 4  # 17 accepted samples, one emit every 4


def test_imu_measure_matches_jax():
    spec = tsensors.ImuSpec()
    assert spec == tsensors.ImuSpec(**jsensors.ImuSpec().__dict__)
    jkey, tkey = jax.random.key(11), tf.key(11)
    omega, accel = np.array([0.01, -0.02, 0.3]), np.array([0.1, 0.0, 9.81])
    gb, ab = np.array([1e-4, 0, -1e-4]), np.array([0.0, 2e-3, 0.0])
    for dt in (1e-2, 1.0 / 300.0):
        jout = jsensors.imu_measure(jkey, jsensors.ImuSpec(), omega, accel, gb, ab, dt)
        tout = tsensors.imu_measure(tkey, spec, *map(torch.tensor, (omega, accel, gb, ab)), dt)
        for o, r in zip(tout, jout):
            _close(o, r, 1e-15)


def test_imu_model_bias_walk():
    """``tests/test_core.py``'s IMU case on the port: noisy but bounded, a
    slow bias walk."""
    key, spec = tf.key(0), tsensors.ImuSpec()
    gb = ab = torch.zeros(3, dtype=torch.float64)
    meas = []
    for _ in range(200):
        key, k = tf.split(key, 2).unbind(-2)
        g, a, gb, ab = tsensors.imu_measure(
            k, spec, torch.zeros(3, dtype=torch.float64),
            torch.tensor([0.0, 0.0, 9.81]), gb, ab, 1e-2)
        meas.append(g.numpy())
    m = np.stack(meas)
    assert 0 < m.std() < 0.1
    assert np.abs(gb.numpy()).max() < 0.01


def test_magnetometer_gps_barometer_match_jax():
    jkey, tkey = jax.random.key(4), tf.key(4)
    field = np.array([2.1e4, -3.0e3, 4.2e4])
    soft, hard = np.eye(3) * 1.02 + 0.01, np.array([120.0, -40.0, 15.0])
    for kwargs in ({}, {"hard_iron": hard}, {"hard_iron": hard, "soft_iron": soft}):
        _close(tsensors.magnetometer_measure(tkey, torch.tensor(field), 100.0, **kwargs),
               jsensors.magnetometer_measure(jkey, field, 100.0, **kwargs), 1e-15)
    pos, vel = np.array([1.1e6, -4.8e6, 3.9e6]), np.array([7.5e3, 1.0, -20.0])
    for o, r in zip(tsensors.gps_measure(tkey, torch.tensor(pos), torch.tensor(vel)),
                    jsensors.gps_measure(jkey, pos, vel)):
        _close(o, r, 1e-15)
    _close(tsensors.barometer_measure(tkey, 350.0, 0.5, 2.0),
           jsensors.barometer_measure(jkey, 350.0, 0.5, 2.0), 1e-15)
    alts = np.array([10.0, 200.0, 3000.0])
    _close(tsensors.barometer_measure(tkey, torch.tensor(alts)),
           jsensors.barometer_measure(jkey, alts), 1e-15)


def test_measures_run_under_vmap():
    """One draw per key under vmap equals a loop over the keys."""
    keys = tf.split(tf.key(9), 5)
    pos = torch.tensor(np.random.default_rng(0).normal(size=(5, 3)))
    vel = torch.zeros(5, 3, dtype=torch.float64)
    batched = torch.func.vmap(tsensors.gps_measure)(keys, pos, vel)
    for i in range(5):
        one = tsensors.gps_measure(keys[i], pos[i], vel[i])
        assert torch.equal(batched[0][i], one[0]) and torch.equal(batched[1][i], one[1])
