"""The rest of the port's ``adcs`` (``triad``, ``ukf``, ``magical``,
``magkal``), the new ``ops.smallalg`` functions and ``gravity.j2``
against the JAX package's, on the same inputs, on the CPU in f64; and the
spawn of component values that are plain tensors.

Stated tolerances (max |Δ| / max |ref|):

* ``cholesky_lower`` / ``cholesky_upper`` (with and without jitter),
  ``psd_solve`` with jitter, ``psd_inv``, ``inv_3x3``: ≤ 1e-12 (~1e-16
  seen; the sums' order differs from XLA's reductions in the last bit);
  ``psd_solve`` with jitter 0 is bitwise the call without it, and a
  jitter equals adding it to the diagonal first, bitwise.
* ``triad`` (``tests/test_adcs.py``'s golden DCM and rotations): ≤ 1e-12
  against JAX, and the JAX test's own gates.
* the UKF: sigma points and weights ≤ 1e-12 and the golden values; 50
  updates of the linear tracker from the same noise, state and covariance
  ≤ 1e-10, and the JAX test's gate.
* ``magical_calibrate``: m, T, h ≤ 1e-12 (~5e-16 seen), the same flag.
* ``MagKal``, 300 updates from the same readings: the estimate ≤ 1e-10
  (~2e-13 seen) and the covariance ≤ 1e-8 (~3e-10 seen: the covariance
  shrinks by 10 orders over the run, and its smallest entries carry the
  rounding), and the JAX test's functional gate.
* ``J2.force`` / ``compute_field`` at LEO radii, batched and single: ≤
  1e-14.
"""

import typing as ty
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import elodin_tpu_torch as el
from elodin_tpu import adcs as jadcs
from elodin_tpu.adcs import magkal as jmagkal
from elodin_tpu.gravity.j2 import J2 as JJ2
from elodin_tpu.ops import smallalg as jsa
from elodin_tpu.spatial import quat_from_axis_angle, quat_inverse, quat_rotate
from elodin_tpu_torch import adcs as tadcs
from elodin_tpu_torch.gravity import J2
from elodin_tpu_torch.ops import smallalg as tsa
from torch_port_util import rel_err

jax.config.update("jax_enable_x64", True)


def _t(x):
    return torch.tensor(np.asarray(x))


def _spd(rng, batch, n):
    m = rng.standard_normal((batch, n, n))
    return m @ m.transpose(0, 2, 1) + 0.1 * np.eye(n)


# ---------------------------------------------------------------------------
# ops.smallalg
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 6, 9])
@pytest.mark.parametrize("jitter", [0.0, 1e-3])
def test_cholesky_factors(n, jitter):
    a = _spd(np.random.default_rng(n), 4, n)
    ref_l = jsa.cholesky_lower(jnp.asarray(a), jitter)
    low = tsa.cholesky_lower(_t(a), jitter)
    assert rel_err(low, ref_l) <= 1e-12
    assert torch.equal(torch.triu(low, 1), torch.zeros_like(low))
    assert rel_err(tsa.cholesky_upper(_t(a), jitter), jsa.cholesky_upper(jnp.asarray(a), jitter)) <= 1e-12
    assert torch.equal(vmap(lambda x: tsa.cholesky_lower(x, jitter))(_t(a)), low)


@pytest.mark.parametrize("n", [3, 4, 6])
def test_psd_solve_jitter_and_psd_inv(n):
    rng = np.random.default_rng(10 + n)
    a, b = _spd(rng, 3, n), rng.standard_normal((3, n, 2))
    assert rel_err(tsa.psd_solve(_t(a), _t(b), 1e-4), jsa.psd_solve(jnp.asarray(a), jnp.asarray(b), 1e-4)) <= 1e-12
    # the jitter is added to the diagonal, and 0 adds nothing
    jittered = _t(a + 1e-4 * np.eye(n))
    assert torch.equal(tsa.psd_solve(_t(a), _t(b), 1e-4), tsa.psd_solve(jittered, _t(b)))
    assert torch.equal(tsa.psd_solve(_t(a), _t(b), 0.0), tsa.psd_solve(_t(a), _t(b)))
    for jitter in (0.0, 1e-4):
        ours = tsa.psd_inv(_t(a), jitter)
        assert rel_err(ours, jsa.psd_inv(jnp.asarray(a), jitter)) <= 1e-12
        assert torch.equal(vmap(lambda x: tsa.psd_inv(x, jitter))(_t(a)), ours)


def test_inv_3x3():
    m = np.random.default_rng(3).standard_normal((8, 3, 3))
    ours = tsa.inv_3x3(_t(m))
    assert rel_err(ours, jsa.inv_3x3(jnp.asarray(m))) <= 1e-12
    assert rel_err(ours, np.linalg.inv(m)) <= 1e-12
    assert torch.equal(vmap(tsa.inv_3x3)(_t(m)), ours)


# ---------------------------------------------------------------------------
# triad
# ---------------------------------------------------------------------------


def _triad_inputs(axis, ang):
    q = quat_from_axis_angle(np.array(axis), ang)
    ref_a, ref_b = np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0])
    qi = quat_inverse(q)
    return qi, (np.array(quat_rotate(qi, ref_a)), np.array(quat_rotate(qi, ref_b)), ref_a, ref_b)


def test_triad_golden():
    _, args = _triad_inputs([0.0, 0.0, 1.0], np.pi / 4)
    dcm = tadcs.triad(*args).numpy()
    s = np.sqrt(2) / 2
    np.testing.assert_allclose(dcm, [[s, s, 0.0], [-s, s, 0.0], [0.0, 0.0, 1.0]], atol=1e-10)
    assert rel_err(dcm, jadcs.triad(*args)) <= 1e-12


@pytest.mark.parametrize("axis", [[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]])
def test_triad_recovers_rotation(axis):
    qis, inputs = zip(*(_triad_inputs(axis, ang) for ang in np.linspace(-2.0, 2.0, 9)))
    batched = [np.stack(x) for x in zip(*inputs)]
    dcm = tadcs.triad(*batched).numpy()
    assert rel_err(dcm, jadcs.triad(*batched)) <= 1e-12
    for k, qi in enumerate(qis):
        assert rel_err(tadcs.triad(*inputs[k]), dcm[k]) <= 1e-15
        for v in ([1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [1.0, 0, 1.0]):
            v = np.array(v)
            np.testing.assert_allclose(dcm[k] @ v, np.asarray(quat_rotate(qi, v)), atol=1e-5)


# ---------------------------------------------------------------------------
# UKF
# ---------------------------------------------------------------------------


def test_ukf_sigma_points_and_weights_golden():
    cfg = tadcs.MerweConfig(3, 1.0, 2.0, 2.0)
    jcfg = jadcs.MerweConfig(3, 1.0, 2.0, 2.0)
    points = cfg.sigma_points(_t([0.0, 1.0, 0.0]), torch.eye(3, dtype=torch.float64))
    s = 2.23606798
    expected = np.array([[0.0, 1.0, 0.0], [s, 1.0, 0.0], [0.0, 1.0 + s, 0.0], [0.0, 1.0, s],
                         [-s, 1.0, 0.0], [0.0, 1.0 - s, 0.0], [0.0, 1.0, -s]])
    np.testing.assert_allclose(points.numpy(), expected, atol=1e-7)
    assert rel_err(points, jcfg.sigma_points(jnp.asarray([0.0, 1.0, 0.0]), jnp.eye(3))) <= 1e-12
    cfg1 = tadcs.MerweConfig(3, 1.0, 1.0, 2.0)
    assert cfg1.lambda_ == 2.0
    np.testing.assert_allclose(cfg1.mean_weights().numpy(), [0.4, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1])
    np.testing.assert_allclose(cfg.covariance_weights().numpy(),
                               [2.4, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1])
    assert rel_err(cfg.covariance_weights(), jcfg.covariance_weights()) <= 1e-15
    assert cfg == tadcs.MerweConfig(3, 1.0, 2.0, 2.0) and hash(cfg) == hash(tadcs.MerweConfig(3, 1.0, 2.0, 2.0))


def test_ukf_transforms_match_jax():
    rng = np.random.default_rng(4)
    pts, ptz = rng.standard_normal((7, 3)), rng.standard_normal((7, 2))
    mw, cw = rng.uniform(0.05, 0.3, 7), rng.uniform(0.05, 0.3, 7)
    x, cov = tadcs.unscented_transform(_t(pts), _t(mw), _t(cw))
    jx, jcov = jadcs.unscented_transform(jnp.asarray(pts), jnp.asarray(mw), jnp.asarray(cw))
    assert rel_err(x, jx) <= 1e-12 and rel_err(cov, jcov) <= 1e-12
    z, _ = tadcs.unscented_transform(_t(ptz), _t(mw), _t(cw))
    assert rel_err(tadcs.cross_covar(x, z, _t(pts), _t(ptz), _t(cw)),
                   jadcs.cross_covar(jx, jnp.asarray(z.numpy()), jnp.asarray(pts), jnp.asarray(ptz),
                                     jnp.asarray(cw))) <= 1e-12
    q = 0.01 * np.eye(3)
    ours = tadcs.predict(_t(pts), lambda p: 2.0 * p, _t(mw), _t(cw), _t(q))
    ref = jadcs.predict(jnp.asarray(pts), lambda p: 2.0 * p, jnp.asarray(mw), jnp.asarray(cw),
                        jnp.asarray(q))
    for o, r in zip(ours, ref):
        assert rel_err(o, r) <= 1e-12
    ours = tadcs.innovate(_t(pts), _t([1.0]), lambda p, zz: p[:1] * zz, _t(mw), _t(cw), _t(q[:1, :1]))
    ref = jadcs.innovate(jnp.asarray(pts), jnp.asarray([1.0]), lambda p, zz: p[:1] * zz,
                         jnp.asarray(mw), jnp.asarray(cw), jnp.asarray(q[:1, :1]))
    for o, r in zip(ours, ref):
        assert rel_err(o, r) <= 1e-12


def test_ukf_linear_tracking():
    """``tests/test_adcs.py``'s tracker: the same 50 noisy readings through
    both packages."""
    dt = 0.1

    def states(pkg, asarray):
        return pkg.UkfState(x_hat=asarray([0.0, 1.0]), covar=asarray(np.eye(2)),
                            prop_covar=asarray(np.eye(2) * 1e-4), noise_covar=asarray(np.eye(1) * 1e-2),
                            config=pkg.MerweConfig(2, 1.0, 2.0, 1.0))

    ours = states(tadcs, _t)
    ref = states(jadcs, jnp.asarray)
    true_x, true_v = 0.0, 0.7
    rng = np.random.default_rng(1)
    for _ in range(50):
        true_x += dt * true_v
        z = np.array([true_x + rng.normal(0, 0.1)])
        ours = ours.update(z, lambda x: torch.stack([x[0] + dt * x[1], x[1]]), lambda x, _z: x[:1])
        ref = ref.update(jnp.asarray(z), lambda x: jnp.asarray([x[0] + dt * x[1], x[1]]),
                         lambda x, _z: x[:1])
    assert rel_err(ours.x_hat, ref.x_hat) <= 1e-10 and rel_err(ours.covar, ref.covar) <= 1e-10
    assert abs(float(ours.x_hat[1]) - true_v) < 0.05


# ---------------------------------------------------------------------------
# magnetometer calibration
# ---------------------------------------------------------------------------


def test_magical_synthetic():
    rng = np.random.default_rng(2)
    n = 64
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t_true = np.diag([1.2, 0.9, 1.1])
    h_true = np.array([0.3, -0.2, 0.5])
    y = dirs @ t_true.T + h_true
    m, t, h, done = tadcs.magical_calibrate(y)
    jm, jt, jh, jdone = jadcs.magical_calibrate(y)
    assert done.dtype == torch.bool and bool(done) == bool(jdone) is True
    for o, r in ((m, jm), (t, jt), (h, jh)):
        assert rel_err(o, r) <= 1e-12
    np.testing.assert_allclose(h.numpy(), h_true, atol=2e-2)
    np.testing.assert_allclose(t.numpy() @ t.numpy().T, t_true @ t_true.T, atol=5e-2)
    # a latch that never sets: the last iterate, as in the JAX package
    noisy = y + rng.normal(0, 0.05, y.shape)
    m, t, h, done = tadcs.magical_calibrate(noisy, iterations=4)
    jm, jt, jh, jdone = jadcs.magical_calibrate(noisy, iterations=4)
    assert not bool(done) and not bool(jdone)
    for o, r in ((m, jm), (t, jt), (h, jh)):
        assert rel_err(o, r) <= 1e-12


def test_magkal_synthetic():
    """300 readings through both packages (the JAX filter's update jitted:
    the same arithmetic as its eager update, compiled once), then the JAX
    test's functional gate on the port's estimate."""
    rng = np.random.default_rng(5)
    b_true = np.array([12.0, -7.0, 4.0])
    d_true = np.array([[0.02, 0.005, 0.0], [0.005, -0.015, 0.002], [0.0, 0.002, 0.01]])
    fields, readings = [], []
    for _ in range(300):
        direction = rng.normal(size=3)
        direction /= np.linalg.norm(direction)
        fields.append(45.0 * direction)
        readings.append((np.eye(3) + d_true) @ fields[-1] + b_true)

    @jax.jit
    def jax_update(state, z, b_ref):
        meas = (jnp.sum(z * z) - jnp.sum(b_ref * b_ref))[None]
        return state.update(meas, lambda x: x, lambda x, _z: jmagkal.measure(x, z))

    kal, ref = tadcs.MagKal(device="cpu"), jadcs.MagKal().state
    for z, field in zip(readings, fields):
        kal = kal.update(z, field)
        ref = jax_update(ref, jnp.asarray(z), jnp.asarray(field))
    assert rel_err(kal.state.x_hat, ref.x_hat) <= 1e-10
    assert rel_err(kal.state.covar, ref.covar) <= 1e-8
    d_hat, h_hat = kal.d_hat.numpy(), kal.h_hat.numpy()
    inv = np.linalg.inv(np.eye(3) + d_hat)
    for field, z in zip(fields[::25], readings[::25]):
        corrected = inv @ (z - h_hat)
        cos = corrected @ field / (np.linalg.norm(corrected) * np.linalg.norm(field))
        assert cos > 1.0 - 6e-3, cos
    np.testing.assert_allclose(h_hat, b_true, atol=0.8)


# ---------------------------------------------------------------------------
# gravity.j2
# ---------------------------------------------------------------------------


def test_j2_matches_jax():
    rng = np.random.default_rng(7)
    r = rng.standard_normal((16, 3))
    r = r / np.linalg.norm(r, axis=1, keepdims=True) * rng.uniform(6.6e6, 4.2e7, (16, 1))
    mass = rng.uniform(1.0, 500.0, 16)
    ours, ref = J2().force(_t(r), _t(mass)), JJ2().force(jnp.asarray(r), jnp.asarray(mass))
    assert rel_err(ours, ref) <= 1e-14
    assert rel_err(J2().compute_field(r[:, 0], r[:, 1], r[:, 2], mass), ref) <= 1e-14
    assert rel_err(J2().force(r[3], 2.5), JJ2().force(jnp.asarray(r[3]), 2.5)) <= 1e-14
    assert rel_err(J2().force(r, 2.5), JJ2().force(jnp.asarray(r), 2.5)) <= 1e-14
    # over the pole the oblateness weakens the point-mass pull, along z
    pole = J2().force(_t([0.0, 0.0, 7e6]), 1.0).numpy()
    assert pole[0] == pole[1] == 0.0 and -3.986004418e14 / 7e6**2 < pole[2] < 0.0


# ---------------------------------------------------------------------------
# component values that are plain tensors (entity._leaf)
# ---------------------------------------------------------------------------

Gain = ty.Annotated[torch.Tensor, el.Component("gain", el.ComponentType.F64)]
Weights = ty.Annotated[torch.Tensor, el.Component(
    "weights", el.ComponentType(el.PrimitiveType.F64, (32, 9)))]
Y = ty.Annotated[torch.Tensor, el.Component("y", el.ComponentType.F64)]


@dataclass
class TensorFields(el.Archetype):
    gain: Gain
    weights: Weights


def test_spawn_takes_plain_tensor_values():
    """``Tensor.inner`` is a method: a plain tensor must not be unwrapped
    as the spatial classes are."""
    w_value = torch.arange(288, dtype=torch.float64).reshape(32, 9)
    w = el.World()
    w.spawn(TensorFields(torch.tensor(0.5, dtype=torch.float64), w_value), "a")
    w.spawn(el.C(Y, torch.tensor(7.0)), "b")
    meta, cols = w.snapshot()
    np.testing.assert_array_equal(cols["weights"], w_value.numpy()[None])
    assert cols["gain"].tolist() == [0.5] and cols["y"].tolist() == [7.0]
    assert meta.components["weights"].ty.shape == (32, 9)
