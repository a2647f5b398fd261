"""The port's cube-sat (``elodin_tpu_torch.examples.cube_sat``) and the
pieces it needs (``ops.smallalg.psd_solve``, ``adcs.mekf``, ``adcs.lqr``,
``gravity.egm08``) against the JAX package's, on the CPU in f64.

Stated tolerances:

* ``psd_solve`` on seeded SPD inputs (3x3 to 6x6, batched and under
  ``vmap``): ≤ 1e-12 max |Δ| / max |ref|.
* The adcs MEKF functions (``calculate_covariance``,
  ``propagate_quaternion``, ``propagate_state_covariance``, ``Mekf.new``,
  ``estimate_attitude``, ``reset_if_invalid``) and ``yang_lqr_control``:
  ≤ 1e-12 max |Δ| / max |ref|; the example's ``_Q`` and ``_YQY`` bit for
  bit (≤ 1e-15 asked).
* ``EGM08.acceleration`` at 64 random LEO positions and on the z-axis:
  ≤ 1e-12 max |Δ| / max |ref|; the vendored coefficients array for array,
  bit for bit.
* One call of each system from a shared state (the JAX cube-sat after 60
  ticks), and the whole cube-sat, 120 ticks through ``Exec``, every column
  of every history row: ≤ 1e-12 in max |Δ| / (1 + |x|) (measured ~2e-15:
  the same algebra, with libm and reductions rounding the last bit).
* The CSV gate: the 56 files of the re-exported baseline, within abs or
  rel 1e-4 (``tests/test_torch_verify.py`` holds the re-exports to the
  JAX examples' exports).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from elodin_tpu.adcs import lqr as jlqr
from elodin_tpu.adcs import mekf as jmekf
from elodin_tpu.gravity import egm08 as jegm08
from elodin_tpu.gravity import egm08_coeffs as jcoeffs
from elodin_tpu.ops import smallalg as jsmallalg
from elodin_tpu_torch import regress
from elodin_tpu_torch.adcs import lqr as tlqr
from elodin_tpu_torch.adcs import mekf as tmekf
from elodin_tpu_torch.examples.cube_sat import main as tc
from elodin_tpu_torch.gravity import egm08 as tegm08
from elodin_tpu_torch.gravity import egm08_coeffs as tcoeffs
from elodin_tpu_torch.ops import smallalg as tsmallalg
from torch_port_util import call_once, float_policy, jax_example, mixed_errs, rel_err

TICKS = 120


def jc():
    return jax_example("cube-sat", "main")


@pytest.fixture(autouse=True)
def _f64():
    with float_policy("f64"):
        yield


def _t(x):
    return torch.tensor(np.asarray(x))


def _spd(rng, batch, n):
    m = rng.standard_normal((batch, n, n))
    return m @ m.transpose(0, 2, 1) + 0.1 * np.eye(n)


# ---------------------------------------------------------------------------
# psd_solve, the adcs library, EGM08
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 6])
def test_psd_solve(n):
    rng = np.random.default_rng(n)
    a, b = _spd(rng, 32, n), rng.standard_normal((32, n, 6))
    ref = jsmallalg.psd_solve(jnp.asarray(a), jnp.asarray(b))
    assert rel_err(tsmallalg.psd_solve(_t(a), _t(b)), ref) <= 1e-12
    assert rel_err(vmap(tsmallalg.psd_solve)(_t(a), _t(b)), ref) <= 1e-12
    # it solves: a x = b
    x = tsmallalg.psd_solve(_t(a), _t(b)).numpy()
    assert np.abs(a @ x - b).max() <= 1e-9 * np.abs(b).max() * np.linalg.cond(a).max()


def _mekf_inputs(rng, batch=16):
    q = rng.standard_normal((batch, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    omega = rng.standard_normal((batch, 3))
    omega[:2] = [[0.0, 0.0, 0.0], [1e-7, 0.0, 0.0]]  # the small-rate branches
    p = _spd(rng, batch, 6) * 0.01
    return q, omega, p


def test_adcs_mekf_functions():
    rng = np.random.default_rng(7)
    q, omega, p = _mekf_inputs(rng)
    dt = tc.SIM_TIME_STEP
    sg, sb = np.array([0.01, 0.02, 0.03]), np.array([0.004, 0.005, 0.006])
    q_ref = jmekf.calculate_covariance(sg, sb, dt)
    np.testing.assert_array_equal(tmekf.calculate_covariance(sg, sb, dt).numpy(), np.asarray(q_ref))
    yqy = np.asarray(jmekf.Mekf.new(sg, sb, dt).yqy)
    np.testing.assert_array_equal(tmekf.Mekf.new(sg, sb, dt).yqy.numpy(), yqy)
    assert rel_err(tmekf.propagate_quaternion(_t(q), _t(omega), dt),
                   jmekf.propagate_quaternion(jnp.asarray(q), jnp.asarray(omega), dt)) <= 1e-12
    # the JAX function broadcasts only one sample at a time: both under vmap
    assert rel_err(
        vmap(lambda p_, o: tmekf.propagate_state_covariance(p_, o, _t(yqy), dt))(_t(p), _t(omega)),
        jax.vmap(lambda p_, o: jmekf.propagate_state_covariance(p_, o, jnp.asarray(yqy), dt))(
            jnp.asarray(p), jnp.asarray(omega))) <= 1e-12
    bodies = [rng.standard_normal((16, 3)) for _ in range(2)]
    refs = [rng.standard_normal((16, 3)) for _ in range(2)]
    bias = rng.standard_normal((16, 3)) * 0.01

    def states(pkg, arr):
        return pkg.Mekf(q_hat=arr(q), b_hat=arr(bias), p=arr(p), omega=arr(omega),
                        yqy=arr(yqy), dt=dt)

    def update(pkg, vm, arr):
        def one(q_, b_, p_, o_, b0, b1, r0, r1):
            m = pkg.Mekf(q_hat=q_, b_hat=b_, p=p_, omega=o_, yqy=arr(yqy), dt=dt)
            m = m.estimate_attitude([b0, b1], [r0, r1], [0.02, 0.03])
            return m.q_hat, m.b_hat, m.p, m.omega

        return vm(one)(*[arr(x) for x in (q, bias, p, omega, *bodies, *refs)])

    ours = update(tmekf, vmap, _t)
    ref = update(jmekf, jax.vmap, jnp.asarray)
    for f, o, r in zip(("q_hat", "b_hat", "p", "omega"), ours, ref):
        assert rel_err(o, r) <= 1e-12, f
    with pytest.raises(ValueError):
        states(tmekf, _t).estimate_attitude([_t(bodies[0])] * 2, [_t(refs[0])] * 2, [0.02])
    # reset_if_invalid: a NaN in one sample's covariance resets that sample
    p_bad = p.copy()
    p_bad[3, 2, 2] = np.nan
    bad = tmekf.Mekf(_t(q), _t(bias), _t(p_bad), _t(omega), _t(yqy), dt).reset_if_invalid()
    jbad = jmekf.Mekf(jnp.asarray(q), jnp.asarray(bias), jnp.asarray(p_bad), jnp.asarray(omega),
                      jnp.asarray(yqy), dt).reset_if_invalid()
    for f in ("q_hat", "b_hat", "p", "omega"):
        np.testing.assert_array_equal(getattr(bad, f).numpy(), np.asarray(getattr(jbad, f)))
    np.testing.assert_array_equal(bad.p[3].numpy(), np.eye(6))
    # a pytree node, as the JAX class is
    leaves, spec = torch.utils._pytree.tree_flatten(states(tmekf, _t))
    assert len(leaves) == 5 and torch.utils._pytree.tree_unflatten(leaves, spec).dt == dt


def test_yang_lqr():
    rng = np.random.default_rng(9)
    att = rng.standard_normal((32, 4))
    att /= np.linalg.norm(att, axis=1, keepdims=True)
    goal = rng.standard_normal((32, 4))
    goal /= np.linalg.norm(goal, axis=1, keepdims=True)
    omega = rng.standard_normal((32, 3))
    args = (np.array([0.13, 0.10, 0.05]), np.full(3, 5.0), np.full(3, 5.0), np.full(3, 8.0))
    d, k = tlqr.lqr_control_mats(*args)
    jd_, jk = jlqr.lqr_control_mats(*args)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd_))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    ours = tlqr.yang_lqr_control(_t(att), _t(omega), _t(goal), d, k)
    ref = jlqr.yang_lqr_control(jnp.asarray(att), jnp.asarray(omega), jnp.asarray(goal), jd_, jk)
    assert rel_err(ours, ref) <= 1e-12
    assert rel_err(tlqr.YangLQR(*args).control(_t(att), _t(omega), _t(goal)), ref) <= 1e-12


def test_egm08():
    for l in (8, 16):
        for ours, ref in zip(tcoeffs.vendored(l), jcoeffs.vendored(l)):
            np.testing.assert_array_equal(ours, ref)
    for ours, ref in zip(tcoeffs.kaula_extend(*tcoeffs.vendored(12)),
                         jcoeffs.kaula_extend(*jcoeffs.vendored(12))):
        np.testing.assert_array_equal(ours, ref)
    assert tcoeffs._LOW_DEGREE == jcoeffs._LOW_DEGREE
    rng = np.random.default_rng(11)
    d = rng.standard_normal((64, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = d * rng.uniform(6.6e6, 7.4e6, (64, 1))
    r[0] = [0.0, 0.0, 7.0e6]  # over the pole: the m = 0 amplitude
    ours_m, ref_m = tegm08.EGM08(16), jegm08.EGM08(16)
    assert ours_m.field_provenance == ref_m.field_provenance == "vendored-low-degree"
    ours = ours_m.acceleration(_t(r))
    ref = ref_m.acceleration(jnp.asarray(r))
    assert torch.isfinite(ours).all() and rel_err(ours, ref) <= 1e-12
    f = ours_m.compute_field(_t(r[5, 0]), _t(r[5, 1]), _t(r[5, 2]), torch.tensor(2.8252, dtype=torch.float64))
    jf = ref_m.compute_field(r[5, 0], r[5, 1], r[5, 2], 2.8252)
    assert rel_err(f, jf) <= 1e-12
    # the central term dominates: |a| ~ mu / r^2 within J2's share
    mag = np.linalg.norm(ours.numpy(), axis=1)
    mu_r2 = ours_m.mu_earth / np.linalg.norm(r, axis=1) ** 2
    assert np.abs(mag / mu_r2 - 1.0).max() < 3e-3


def test_egm08_reads_coefficient_files_only_from_a_given_directory(tmp_path):
    c, s = tcoeffs.vendored(20)
    c[3, 1] *= 2.0
    np.save(tmp_path / "C_normal.npy", c)
    np.save(tmp_path / "S_normal.npy", s)
    m = tegm08.EGM08(4, cache_directory=str(tmp_path))
    assert m.field_provenance == "file" and m.c_bar[3, 1] == c[3, 1]
    ref = jegm08.EGM08(4, cache_directory=str(tmp_path))
    r = np.array([[6.9e6, 1.0e5, 2.0e6]])
    assert rel_err(m.acceleration(_t(r)), ref.acceleration(jnp.asarray(r))) <= 1e-12
    assert tegm08.EGM08(4).field_provenance == "vendored-low-degree"


# ---------------------------------------------------------------------------
# the example: constants, snapshot, one call of each system, the whole run
# ---------------------------------------------------------------------------


def test_constants_snapshot_and_names():
    j = jc()
    np.testing.assert_array_equal(tc._Q, np.asarray(j._Q))
    np.testing.assert_array_equal(tc._YQY, np.asarray(j._YQY))
    np.testing.assert_array_equal(tc._d, np.asarray(j._d))
    np.testing.assert_array_equal(tc._k, np.asarray(j._k))
    assert tc.velocity == float(j.velocity)
    jmeta, jcols = j.build_world().snapshot()
    tmeta, tcols = tc.build_world().snapshot()
    assert list(tcols) == list(jcols)
    assert tmeta.entity_names == jmeta.entity_names
    assert tmeta.comp_entities == jmeta.comp_entities
    for k, v in jcols.items():
        assert tcols[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(tcols[k], np.asarray(v), err_msg=k)


_SYSTEMS = ("sun_pos", "sun_sensor", "sun_sensor_value", "fake_magnetometer_ref",
            "fake_magnetometer_body", "gyro_omega", "kalman_filter", "control",
            "actuator_allocator", "saturate_force", "rw_effector", "gravity_effector",
            "earth_point")


def test_one_call_of_each_system_from_a_shared_state():
    j = jc()
    jw, tw = j.build_world(), tc.build_world()
    jmeta, _ = jw.snapshot()
    tmeta, _ = tw.snapshot()
    jex = jw.build(j.build_system(), simulation_rate=1.0 / j.SIM_TIME_STEP)
    jex.record_history = False
    jex.run(60)
    state = {k: np.array(v) for k, v in jex.cols.items()}
    # readings that one system call would leave as they are, moved so that
    # each system writes something new
    state["css_reading"][:] = 0.0
    state["mag_ref"] *= 2.0
    systems = {name: (getattr(j, name), getattr(tc, name)) for name in _SYSTEMS}
    systems["six_dof"] = (j.build_system(), tc.build_system())
    for name, (jsys, tsys) in systems.items():
        ref, ours = call_once(jsys, tsys, jmeta, tmeta, state)
        errs = mixed_errs(ours, ref)
        assert max(errs.values()) <= 1e-12, (name, sorted(errs.items(), key=lambda kv: -kv[1])[:3])
        assert any(not np.array_equal(ref[k], state[k]) for k in ref), name


@pytest.fixture(scope="module")
def runs():
    """(JAX Exec, port Exec), 120 ticks each with history."""
    with float_policy("f64"):
        j = jc()
        jex = j.build_world().build(j.build_system(), simulation_rate=1.0 / j.SIM_TIME_STEP)
        jex.run(TICKS)
        tex = tc.build_world().build(tc.build_system(), simulation_rate=1.0 / tc.SIM_TIME_STEP,
                                     device="cpu")
        tex.run(TICKS, show_progress=False)
    jex.flush_telemetry()
    tex.flush_telemetry()  # the tests read the private history directly
    return jex, tex


def test_whole_cube_sat_120_ticks(runs):
    jex, tex = runs
    assert tex.tick() == TICKS
    hist_o = {k: tex._history.series(k) for k in tex.meta.components}
    hist_r = {k: np.asarray(jex._history.series(k)) for k in jex.meta.components}
    errs = mixed_errs(hist_o, hist_r)
    assert max(errs.values()) <= 1e-12, sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    for name in ("ore_sat.att_est", "ore_sat.goal"):
        q = tex.read_component(name)
        assert q.shape == (4,) and abs(np.linalg.norm(q) - 1.0) <= 1e-12, name


def test_cube_sat_detumbles_and_estimates():
    """The JAX package's gate (``tests/test_examples.py``), 1200 ticks."""
    exec_ = tc.build_world().build(tc.build_system(), simulation_rate=1.0 / tc.SIM_TIME_STEP,
                                   device="cpu")
    exec_.record_history = False  # the JAX test reads the history's last row
    exec_.run(1200)  # 10 seconds
    r = float(exec_.read_component("ore_sat.radius")[0])
    np.testing.assert_allclose(r, tc.radius, rtol=1e-3)
    q_est = exec_.read_component("ore_sat.att_est")
    q_true = exec_.read_component("ore_sat.world_pos")[:4]
    dot = abs(float(np.dot(q_est, q_true)))
    assert dot > 0.95, f"MEKF estimate diverged: |<q_est,q_true>| = {dot}"


def test_cube_sat_passes_the_csv_gate_on_the_cpu():
    exec_, wall, n, worst = regress.check("cube-sat", device="cpu")
    assert exec_.tick() == regress.TICKS and n == 56 and worst <= 1e-6
