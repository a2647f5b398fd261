"""The port's drone (``elodin_tpu_torch.examples.drone``) and the pieces it
needs (``ops.fastrand``, the new ``spatial`` functions) against the JAX
package's, on the CPU in f64.

Stated tolerances:

* ``fastrand.hash_u32``: bit for bit, ticks 1-1200, salts 450 and 7.
  ``uniform``: bit for bit.  ``normal``: ≤ 1e-15 absolute (libm's
  ``log`` / ``sin`` / ``cos`` may round the last bit differently).
* ``skew``, ``quat_to_mat3``, ``quat_from_mat3``, ``quat_integrate_body``
  and the ``Quaternion`` methods ``from_rot_mat``, ``integrate_body``,
  ``angular_distance``, ``to_mat3``: ≤ 1e-15 max |Δ| / max |ref| (the same
  IEEE operations).
* Every function of ``shaping``, the filters, ``_inv3``: ≤ 1e-12 max |Δ| /
  max |ref|, under ``vmap`` over 64 seeded inputs (transcendental functions
  may round the last bit differently).  ``normalize_angle``
  (``torch.remainder`` for ``jnp.mod``) and the module constants
  (``_Q_DISCRETE``, the motor geometry, the accel limits, the filter
  coefficients): bit for bit.
* One call of each system from a shared state, the JAX drone 6.8 s into
  its flight plan: ≤ 1e-12 in max |Δ| / (1 + |x|) per column.
* The whole drone, 300 ticks through ``Exec``, every column of every
  history row, max |Δ| / (1 + |x|): ≤ 1e-12 with ``noise=False``; ≤ 1e-9
  with ``noise=True`` (measured 7.1e-11 in ``rate_pid_state``: the
  normals' last-bit differences pass through the PID's derivative, a
  difference over one control step, 300x).
* The CSV gate: all 33 files of the re-exported baseline
  (``regress.REEXPORTED``), vector cells included, within abs or rel 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import elodin_tpu_torch as tel
from elodin_tpu import spatial as jspatial
from elodin_tpu.ops import fastrand as jfastrand
from elodin_tpu_torch import regress
from elodin_tpu_torch import spatial as tspatial
from elodin_tpu_torch.examples.drone import control as tctl
from elodin_tpu_torch.examples.drone import filter as tfilt
from elodin_tpu_torch.examples.drone import main as td
from elodin_tpu_torch.examples.drone import mekf as tmekf
from elodin_tpu_torch.examples.drone import motors as tmotors
from elodin_tpu_torch.examples.drone import params as tparams
from elodin_tpu_torch.examples.drone import shaping as tshp
from elodin_tpu_torch.ops import fastrand as tfastrand
from torch_port_util import call_once, float_policy, jax_example, mixed_errs, rel_err

TICKS = 300


def jd():
    return jax_example("drone", "main")


@pytest.fixture(autouse=True)
def _f64():
    with float_policy("f64"):
        yield


def _t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# fastrand
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("salt", [450, 7])
def test_fastrand_is_bit_exact(salt):
    ticks = np.arange(1, 1201, dtype=np.float64)
    ref = np.asarray(jax.vmap(lambda t: jfastrand.hash_u32(t, salt, 6))(jnp.asarray(ticks)))
    ours = vmap(lambda t: tfastrand.hash_u32(t, salt, 6))(_t(ticks))
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.int64))
    u_ref = np.asarray(jax.vmap(lambda t: jfastrand.uniform(t, salt, (5,)))(jnp.asarray(ticks)))
    np.testing.assert_array_equal(vmap(lambda t: tfastrand.uniform(t, salt, (5,)))(_t(ticks)),
                                  u_ref)
    n_ref = np.asarray(jax.vmap(lambda t: jfastrand.normal(t, salt, (4, 3)))(jnp.asarray(ticks)))
    n_ours = vmap(lambda t: tfastrand.normal(t, salt, (4, 3)))(_t(ticks)).numpy()
    assert np.abs(n_ours - n_ref).max() <= 1e-15
    # an unbatched call and an odd count (the Box-Muller pair is cut)
    one = tfastrand.normal(torch.tensor(17.0, dtype=torch.float64), salt, (3,)).numpy()
    assert np.abs(one - np.asarray(jfastrand.normal(jnp.float64(17.0), salt, (3,)))).max() <= 1e-15


# ---------------------------------------------------------------------------
# spatial
# ---------------------------------------------------------------------------


def test_new_spatial_functions():
    rng = np.random.default_rng(21)
    q = rng.standard_normal((64, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.standard_normal((64, 3)) * 0.1
    pairs = {
        "skew": (tspatial.skew(_t(v)), jspatial.skew(jnp.asarray(v))),
        "to_mat3": (tspatial.quat_to_mat3(_t(q)), jspatial.quat_to_mat3(jnp.asarray(q))),
        "integrate_body": (tspatial.quat_integrate_body(_t(q), _t(v)),
                           jspatial.quat_integrate_body(jnp.asarray(q), jnp.asarray(v))),
    }
    mats = np.asarray(jspatial.quat_to_mat3(jnp.asarray(q)))
    pairs["from_mat3"] = (tspatial.quat_from_mat3(_t(mats)), jspatial.quat_from_mat3(jnp.asarray(mats)))
    tq, jq = tel.Quaternion.from_array(_t(q)), jspatial.Quaternion.from_array(jnp.asarray(q))
    tq2 = tel.Quaternion.from_array(_t(np.roll(q, 1, axis=0)))
    jq2 = jspatial.Quaternion.from_array(jnp.asarray(np.roll(q, 1, axis=0)))
    pairs["Quaternion.from_rot_mat"] = (tel.Quaternion.from_rot_mat(_t(mats)).inner,
                                        jspatial.Quaternion.from_rot_mat(jnp.asarray(mats)).inner)
    pairs["Quaternion.integrate_body"] = (tq.integrate_body(_t(v)).inner,
                                          jq.integrate_body(jnp.asarray(v)).inner)
    pairs["Quaternion.angular_distance"] = (tq.angular_distance(tq2), jq.angular_distance(jq2))
    pairs["Quaternion.to_mat3"] = (tq.to_mat3(), jq.to_mat3())
    for name, (ours, ref) in pairs.items():
        assert rel_err(ours, ref) <= 1e-15, name
    # the rotation-matrix round trip, up to the quaternion's sign
    back = tspatial.quat_from_mat3(tspatial.quat_to_mat3(_t(q))).numpy()
    assert np.abs(np.abs((back * q).sum(1)) - 1.0).max() <= 1e-12
    # a component annotated with a spatial class takes that class's type
    assert tel.Component.of(tctl.AttTarget).ty == tel.ComponentType.Quaternion


# ---------------------------------------------------------------------------
# shaping, filters, constants
# ---------------------------------------------------------------------------


def _shaping_inputs():
    rng = np.random.default_rng(31)
    q = rng.standard_normal((64, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.standard_normal((64, 4))
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    # near-identity and exactly-equal pairs: the small-angle branches
    q2[:4] = q[:4]
    q2[4:8] = q[4:8] + 1e-8
    q2[4:8] /= np.linalg.norm(q2[4:8], axis=1, keepdims=True)
    q[8] = [0.0, 0.0, 0.0, -1.0]
    w3 = rng.standard_normal((64, 3))
    ang = rng.uniform(-10.0, 10.0, (64, 3))
    ang[:3, 0] = [math.pi, -math.pi, 3 * math.pi]
    acc = rng.uniform(0.5, 20.0, (64, 3))
    return q, q2, w3, ang, acc


def test_every_shaping_function():
    js = jax_example("drone", "shaping", key="jax_drone_shaping")
    q, q2, w3, ang, acc = _shaping_inputs()
    TQ, JQ = tel.Quaternion.from_array, jspatial.Quaternion.from_array
    dt, tc = tctl.CTRL_DT, tparams.ATC_INPUT_TC
    cases = {
        "quat_to_euler": (lambda m, Q, a: m.quat_to_euler(Q(a[0])), [q]),
        "euler_to_quat": (lambda m, Q, a: m.euler_to_quat(a[0]).inner, [ang]),
        "quat_to_axis_angle": (lambda m, Q, a: m.quat_to_axis_angle(Q(a[0])), [q]),
        "quat_dist": (lambda m, Q, a: m.quat_dist(Q(a[0]), Q(a[1])), [q, q2]),
        "angular_to_euler_rate": (lambda m, Q, a: m.angular_to_euler_rate(Q(a[0]), a[1]), [q, w3]),
        "euler_to_angular_rate": (lambda m, Q, a: m.euler_to_angular_rate(Q(a[0]), a[1]), [q, w3]),
        "sqrt_controller": (lambda m, Q, a: m.sqrt_controller(a[0], 1.0 / tc, a[1], dt),
                            [ang, acc]),
        "shape_rate": (lambda m, Q, a: m.shape_rate(a[0], a[1], a[2], dt, 0.0), [w3, ang, acc]),
        "shape_rate_tc": (lambda m, Q, a: m.shape_rate(a[0], a[1], a[2], dt, tc), [w3, ang, acc]),
        "shape_angle": (lambda m, Q, a: m.shape_angle(a[0], a[1], a[2], dt, tc), [ang, w3, acc]),
        "angular_to_euler_accel_limit": (
            lambda m, Q, a: m.angular_to_euler_accel_limit(Q(a[0]), a[1]), [q, acc]),
        "tilt_heading_error": (
            lambda m, Q, a: m.tilt_heading_error(Q(a[0]), Q(a[1]))[0], [q, q2]),
        "tilt_angle": (lambda m, Q, a: m.tilt_heading_error(Q(a[0]), Q(a[1]))[1], [q, q2]),
    }
    for name, (fn, args) in cases.items():
        ref = jax.vmap(lambda *a: fn(js, JQ, a))(*[jnp.asarray(x) for x in args])
        ours = vmap(lambda *a: fn(tshp, TQ, a))(*[_t(x) for x in args])
        assert torch.isfinite(ours).all(), name
        assert rel_err(ours, ref) <= 1e-12, (name, rel_err(ours, ref))
    wrapped = np.concatenate([ang.ravel(), np.linspace(-20, 20, 1001), [np.pi, -np.pi, 0.0]])
    np.testing.assert_array_equal(tshp.normalize_angle(_t(wrapped)).numpy(),
                                  np.asarray(js.normalize_angle(jnp.asarray(wrapped))))


def test_filters():
    jf = jax_example("drone", "filter", key="jax_drone_filter")
    x = np.random.default_rng(41).standard_normal((200, 3))
    for cutoff in (10.0, np.array([20.0, 0.0, 2.5])):
        ours_f, ref_f = tfilt.LPF(cutoff, 300.0), jf.LPF(cutoff, 300.0)
        np.testing.assert_array_equal(ours_f.alpha, np.asarray(ref_f.alpha))
        y_o, y_r = torch.zeros(3, dtype=torch.float64), jnp.zeros(3)
        for xi in x:
            y_o, y_r = ours_f.apply(y_o, _t(xi)), ref_f.apply(y_r, jnp.asarray(xi))
        assert rel_err(y_o, y_r) <= 1e-12
    ours_b, ref_b = tfilt.BiquadLPF(40.0, 900.0), jf.BiquadLPF(40.0, 900.0)
    assert ours_b.a == ref_b.a and ours_b.b == ref_b.b
    d_o, d_r = torch.zeros((4, 3), dtype=torch.float64), jnp.zeros((4, 3))
    for xi in x:
        d_o, d_r = ours_b.apply(d_o, _t(xi)), ref_b.apply(d_r, jnp.asarray(xi))
    assert rel_err(d_o, d_r) <= 1e-12
    with pytest.raises(ValueError):
        tfilt.BiquadLPF(0.0, 900.0)


def test_constants_and_inv3():
    j = jd()
    np.testing.assert_array_equal(tmekf._Q_DISCRETE, np.asarray(j.mekf._Q_DISCRETE))
    np.testing.assert_array_equal(tmotors.MOTOR_POS, np.asarray(j.motors.MOTOR_POS))
    np.testing.assert_array_equal(tparams.accel_limits_rad_s2(),
                                  np.asarray(j.params.accel_limits_rad_s2()))
    assert tctl.THRUST_ERROR_ANGLE == float(j.ctl.THRUST_ERROR_ANGLE)
    m = np.random.default_rng(51).standard_normal((64, 3, 3))
    s = m @ m.transpose(0, 2, 1) + np.eye(3)
    ours = vmap(tmekf._inv3)(_t(s))
    ref = jax.vmap(j.mekf._inv3)(jnp.asarray(s))
    assert rel_err(ours, ref) <= 1e-12


# ---------------------------------------------------------------------------
# the systems, one call each, and the whole drone
# ---------------------------------------------------------------------------


def _systems(m, noise=True):
    """name -> the drone's systems of the module set ``m`` (the JAX example
    or the port)."""
    sensor = m.sn.make_systems(m.filt, noise=noise)
    fsw = m.ctl.make_systems(m.sn, m.mekf, m.motors, m.filt, m.shaping, m.params)
    out = {"imu_sample": sensor, "mekf_update": m.mekf.make_update(m.sn),
           "control": fsw, "response": m.motors.response, "wrench": m.motors.wrench,
           "gravity": m.gravity, "drag": m.drag, "flight_plan": m.make_flight_plan(),
           "substep": m.el.six_dof(m.FAST_DT, m.motors.response | m.gravity | m.drag
                                   | m.motors.wrench,
                                   integrator=m.el.Integrator.SemiImplicit) | sensor}
    out.update({f"fsw.{s.name}": s for s in fsw.systems})
    return out


class _PortModules:
    """The port's drone modules under the JAX example's names."""

    def __init__(self):
        from elodin_tpu_torch.examples.drone import sensors

        self.sn, self.filt, self.ctl, self.mekf, self.motors = sensors, tfilt, tctl, tmekf, tmotors
        self.shaping, self.params, self.el = tshp, tparams, tel
        self.gravity, self.drag, self.make_flight_plan = td.gravity, td.drag, td.make_flight_plan
        self.FAST_DT = td.FAST_DT


def test_one_call_of_each_system_from_a_shared_state():
    j = jd()
    jw, tw = j.build_world(tilt_deg=10.0), td.build_world(tilt_deg=10.0)
    jmeta, jcols = jw.snapshot()
    tmeta, tcols = tw.snapshot()
    assert list(tcols) == list(jcols) and tmeta.entity_names == jmeta.entity_names
    for k, v in jcols.items():
        np.testing.assert_array_equal(tcols[k], np.asarray(v), err_msg=k)
    # the shared state: the JAX drone 6.8 s into the flight plan
    jex = jw.build(j.build_system(flight_plan=True), simulation_rate=td.SIMULATION_RATE)
    jex.record_history = False
    jex.run(2050)  # past the first plan step (6 s), into the pitch step
    state = {k: np.array(v) for k, v in jex.cols.items()}
    state["angle_desired"][:] = 0.0  # for the flight plan to write
    jsys, tsys = _systems(j), _systems(_PortModules())
    assert set(jsys) == set(tsys)
    for name in jsys:
        ref, ours = call_once(jsys[name], tsys[name], jmeta, tmeta, state)
        errs = mixed_errs(ours, ref)
        assert max(errs.values()) <= 1e-12, (name, sorted(errs.items(), key=lambda kv: -kv[1])[:3])
        changed = [k for k in ref if not np.array_equal(ref[k], state[k])]
        assert changed, name  # each system writes something


@pytest.fixture(scope="module")
def runs():
    """{noise: (JAX Exec, port Exec)}, 300 ticks each with history."""
    out = {}
    with float_policy("f64"):
        j = jd()
        for noise in (True, False):
            jex = j.build_world().build(j.build_system(noise=noise),
                                        simulation_rate=j.SIMULATION_RATE)
            jex.run(TICKS)
            tex = td.build_world().build(td.build_system(noise=noise),
                                         simulation_rate=td.SIMULATION_RATE, device="cpu")
            tex.run(TICKS, show_progress=False)
            out[noise] = (jex, tex)
    return out


@pytest.mark.parametrize("noise,tol", [(False, 1e-12), (True, 1e-9)])
def test_whole_drone_300_ticks(runs, noise, tol):
    jex, tex = runs[noise]
    assert tex.tick() == TICKS
    assert list(tex.meta.components) == list(jex.meta.components)
    hist_o = {k: tex._history.series(k) for k in tex.meta.components}
    hist_r = {k: np.asarray(jex._history.series(k)) for k in jex.meta.components}
    errs = mixed_errs(hist_o, hist_r)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert np.isfinite(hist_o["world_pos"]).all()


def test_quaternion_components_round_trip_as_xyzw(runs):
    jex, tex = runs[True]
    for name in ("drone.attitude_estimate", "drone.attitude_target"):
        q = tex.read_component(name)
        assert q.shape == (4,) and abs(np.linalg.norm(q) - 1.0) <= 1e-12
        np.testing.assert_allclose(q, np.asarray(jex.read_component(name)), rtol=0, atol=1e-12)
    # identity at tick 0 is [0, 0, 0, 1]
    np.testing.assert_array_equal(tex._history.series("attitude_target")[0, 0], [0, 0, 0, 1])


def test_drone_passes_the_csv_gate_on_the_cpu():
    exec_, wall, n, worst = regress.check("drone", device="cpu")
    assert exec_.tick() == regress.TICKS and n == 33 and worst <= 1e-4
