"""The port's falcon9 model functions, ``ops.interp``, ``frames`` and
``Quaternion`` against the JAX package's, on seeded random inputs.

Each JAX function runs under ``jax.vmap`` on JAX's CPU backend in f64, its
port under ``torch.func.vmap`` on the same numpy draws.  Stated tolerance:
max |Δ| / max |ref| ≤ 1e-12 per output (the same arithmetic in IEEE f64;
the packages' transcendental functions and small reductions may round
differently in the last bit).  The ZEM/ZEV replay is a closed loop of
1200 steps, so round-off compounds through it: ≤ 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from elodin_tpu import frames as jframes
from elodin_tpu import spatial as jsp
from elodin_tpu_torch import frames as tframes
from elodin_tpu_torch import spatial as tsp
from elodin_tpu_torch.examples.falcon9 import aero as taero
from elodin_tpu_torch.examples.falcon9 import atmosphere as tatm
from elodin_tpu_torch.examples.falcon9 import propulsion as tprop
from elodin_tpu_torch.examples.falcon9 import rcs as trcs
from elodin_tpu_torch.examples.falcon9 import zemzev as tzem
from elodin_tpu_torch.ops.interp import interp
from torch_port_util import float_policy, jax_falcon9, rel_err

TOL = 1e-12
N = 257

jatm = jax_falcon9("atmosphere")
jprop = jax_falcon9("propulsion")
jrcs = jax_falcon9("rcs")
jaero = jax_falcon9("aero")
jzem = jax_falcon9("zemzev")


@pytest.fixture(autouse=True)
def _f64():
    with float_policy("f64"):
        yield


def _rng(seed):
    return np.random.default_rng(seed)


def _check(jfn, tfn, *args, tol=TOL, batched=True):
    """``jfn`` and ``tfn`` on the same numpy ``args``; every output leaf
    within ``tol``.  Returns the worst error."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.tensor(np.asarray(a)) for a in args]
    ref = (jax.vmap(jfn) if batched else jfn)(*jargs)
    ours = (vmap(tfn) if batched else tfn)(*targs)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    our_leaves = torch.utils._pytree.tree_flatten(ours)[0]
    assert len(ref_leaves) == len(our_leaves)
    worst = 0.0
    for o, r in zip(our_leaves, ref_leaves):
        r = np.asarray(r)
        assert tuple(o.shape) == r.shape and o.dtype == torch.float64
        err = rel_err(o, r)
        assert err <= tol, err
        worst = max(worst, err)
    return worst


# -- atmosphere -------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["pressure", "temperature", "density", "speed_of_sound"])
def test_atmosphere(fn):
    # every layer, the layer bases themselves, below the floor and above the top
    h = np.concatenate([_rng(1).uniform(-500.0, 130_000.0, N), jatm._LAYERS[:, 0],
                        [0.0, 84_852.0, 250_000.0, 300_000.0]])
    _check(getattr(jatm, fn), getattr(tatm, fn), h)


# -- propulsion -------------------------------------------------------------------


def test_propulsion_thrust_flow_and_actuators():
    r = _rng(2)
    u, p = r.uniform(0, 1.1, N), r.uniform(0, 1.2e5, N)
    _check(jprop.engine_thrust_per_engine, tprop.engine_thrust_per_engine, u, p)
    lit, thr = r.uniform(0, 9, N), r.uniform(0, 1, N)
    _check(jprop.cluster_mdot, tprop.cluster_mdot, lit, thr)
    _check(jprop.split_mdot, tprop.split_mdot, r.uniform(0, 2500, N))
    x, cmd = r.uniform(-0.1, 0.1, (N, 2)), r.uniform(-0.2, 0.2, (N, 2))
    _check(lambda x, c: jprop.actuator_step(x, c, 0.01, 0.03, 0.35, -0.087, 0.087),
           lambda x, c: tprop.actuator_step(x, c, 0.01, 0.03, 0.35, -0.087, 0.087), x, cmd)
    _check(lambda x, c: jprop.actuator_step(x, c, 0.01, 0.007, lo=0.0, hi=1.0),
           lambda x, c: tprop.actuator_step(x, c, 0.01, 0.007, lo=0.0, hi=1.0), x, cmd)


def test_propulsion_mass_props_and_tanks():
    r = _rng(3)
    lox, rp1, upper = r.uniform(0, 2.8e5, N), r.uniform(0, 1.2e5, N), r.uniform(0, 1.2e5, N)
    _check(jprop.stack_mass_props, tprop.stack_mass_props, lox, rp1, upper)
    p, m, mdot = r.uniform(1e5, 4e5, N), r.uniform(0, 2.8e5, N), r.uniform(0, 2000, N)
    infill, vent = r.uniform(0, 1, N), r.uniform(0, 1, N)
    _check(lambda *a: jprop.tank_pressure_step(a[0], a[1], a[2], jprop.V_TANK_LOX_M3,
                                               jprop.RHO_LOX, a[3], a[4], 0.01),
           lambda *a: tprop.tank_pressure_step(a[0], a[1], a[2], tprop.V_TANK_LOX_M3,
                                               tprop.RHO_LOX, a[3], a[4], 0.01),
           p, m, mdot, infill, vent)
    acc = r.uniform(-5, 40, N)
    _check(lambda *a: jprop.inlet_pressure(a[0], a[1], jprop.RHO_RP1, 3.0, a[2], a[3]),
           lambda *a: tprop.inlet_pressure(a[0], a[1], tprop.RHO_RP1, 3.0, a[2], a[3]),
           p, m, acc, mdot)


# -- rcs ---------------------------------------------------------------------------


def test_rcs():
    r = _rng(4)
    levels, cg = r.uniform(0, 1, (N, 8)), r.uniform(15, 30, N)
    _check(jrcs.rcs_wrench, trcs.rcs_wrench, levels, cg)
    _check(jrcs.effectiveness_matrix, trcs.effectiveness_matrix, cg)
    # commands from below the minimum-impulse floor to saturation, both signs
    torque = r.normal(size=(N, 3)) * np.exp(r.uniform(0, 14, (N, 1)))
    _check(jrcs.allocate_torque, trcs.allocate_torque, torque, cg)
    np.testing.assert_array_equal(trcs._MASKS, np.asarray(jrcs._MASKS))


# -- aero and interp ------------------------------------------------------------------


def test_interp_matches_jnp_interp():
    r = _rng(5)
    xp = np.array([0.0, 0.6, 0.9, 0.9, 1.5, 2.0, 2.0, 2.0, 3.0])  # duplicate knots: steps
    fp = r.normal(size=xp.shape)
    x = np.concatenate([r.uniform(-1, 4, N), xp, [-np.inf, np.inf]])
    _check(lambda v: jnp.interp(v, xp, fp),
           lambda v: interp(v, torch.as_tensor(xp), torch.as_tensor(fp)), x, batched=False)
    # under vmap, on one segment and its clamped ends
    _check(lambda v: jnp.interp(v, xp[:2], fp[:2]),
           lambda v: interp(v, torch.as_tensor(xp[:2]), torch.as_tensor(fp[:2])), x)


def test_aero_tables_and_wrenches():
    r = _rng(6)
    mach, qbar, cg = r.uniform(0, 12, N), r.uniform(0, 8e4, N), r.uniform(15, 30, N)
    for table in ("CA_ASCENT", "CA_DESCENT", "CN_CROSS", "CN_DELTA_FIN"):
        _check(lambda m: jaero.mach_lookup(getattr(jaero, table), m),
               lambda m: taero.mach_lookup(getattr(taero, table), m), mach)
    v = r.normal(size=(N, 3)) * 300.0
    w = r.normal(size=(N, 3)) * 0.1
    scale = r.uniform(0.8, 1.2, N)
    _check(lambda *a: jaero.body_aero_wrench(a[0], a[1], a[2], a[3], a[4], a[5]),
           lambda *a: taero.body_aero_wrench(a[0], a[1], a[2], a[3], a[4], a[5]),
           v, mach, qbar, cg, w, scale)
    _check(jaero.config_blend, taero.config_blend, v[:, 0])
    _check(jaero.plume_dominance, taero.plume_dominance, r.uniform(0, 7e6, N), qbar)
    fins = r.uniform(-0.35, 0.35, (N, 4))
    _check(jaero.fin_wrench, taero.fin_wrench, fins, mach, qbar, cg)
    _check(jaero.fin_mix, taero.fin_mix, r.normal(size=(N, 3)))
    _check(jaero.fin_torque_authority, taero.fin_torque_authority, mach, qbar + 1.0, cg)


# -- zemzev ----------------------------------------------------------------------------


def test_zemzev_law():
    r = _rng(7)
    alt, vdown = r.uniform(-5, 3000, N), r.uniform(-2, 300, N)
    _check(jzem.t_go_hoverslam, tzem.t_go_hoverslam, alt, vdown)
    pos = r.normal(size=(N, 3)) * [300.0, 300.0, 0.0] + np.stack(
        [np.zeros(N), np.zeros(N), alt], axis=1)
    vel = r.normal(size=(N, 3)) * [20.0, 20.0, 80.0]
    up = np.array([0.0, 0.0, 1.0])
    t_go = r.uniform(0.5, 80, N)
    commit = r.uniform(size=N) > 0.7
    _check(lambda p, v, t, c: jzem.accel_cmd(p, v, jnp.asarray(up), t, c),
           lambda p, v, t, c: tzem.accel_cmd(p, v, torch.as_tensor(up), t, c),
           pos, vel, t_go, commit)
    _check(lambda p, v: jzem.step(p, v, jnp.asarray(up), 0.05),
           lambda p, v: tzem.step(p, v, torch.as_tensor(up), 0.05), pos, vel)


@pytest.mark.parametrize("start", ["recorded_ignition", "near_deck"])
def test_zemzev_replay(start):
    """The recorded bad ignition state, 60 s into the burn; and a state
    8 m above the deck, through touchdown and the frozen steps after."""
    if start == "recorded_ignition":
        r0, v0 = jzem.ignition_state()
        tr0, tv0 = tzem.ignition_state()
        np.testing.assert_array_equal(tr0.numpy(), np.asarray(r0))
        np.testing.assert_array_equal(tv0.numpy(), np.asarray(v0))
        n_steps = 1200
    else:
        r0, v0 = jnp.asarray([-5.0, 2.0, 8.0]), jnp.asarray([0.5, 0.2, -3.0])
        tr0, tv0 = torch.tensor(np.asarray(r0)), torch.tensor(np.asarray(v0))
        n_steps = 300
    ref = jzem.replay.__wrapped__(r0, v0, n_steps, 0.05)  # n_steps static
    ours = tzem.replay(tr0, tv0, n_steps, 0.05)
    for o, ref_leaf in zip(ours, ref):
        assert rel_err(o, np.asarray(ref_leaf)) <= 1e-9
    if start == "near_deck":
        # touched down: the crossing is interpolated onto the deck
        assert abs(float(ours[0][2])) < 1e-9 and abs(float(ref[0][2])) < 1e-9


# -- frames -------------------------------------------------------------------------------


def test_frames():
    r = _rng(8)
    lat, lon, alt = r.uniform(-1.5, 1.5, N), r.uniform(-np.pi, np.pi, N), r.uniform(-100, 4e5, N)
    _check(jframes.ecef_to_ned, tframes.ecef_to_ned, lat, lon, batched=False)
    _check(jframes.ned_to_ecef, tframes.ned_to_ecef, lat, lon, batched=False)
    _check(jframes.geodetic_to_ecef, tframes.geodetic_to_ecef, lat, lon, alt, batched=False)
    ecef = np.asarray(jframes.geodetic_to_ecef(lat, lon, alt))
    _check(jframes.ecef_to_geodetic, tframes.ecef_to_geodetic, ecef, batched=False)
    # numpy and Python numbers in, f64 tensors out
    out = tframes.geodetic_to_ecef(0.5, np.float64(-1.4), 3)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64 and out.shape == (3,)


# -- Quaternion ----------------------------------------------------------------------------


def _quat_args(seed):
    r = _rng(seed)
    return (r.normal(size=(N, 4)), r.normal(size=(N, 4)), r.normal(size=(N, 3)) * 5,
            r.normal(size=(N, 7)), r.normal(size=(N, 6)))


def test_quaternion_algebra():
    a, b, v, _, _ = _quat_args(9)
    ops = {
        "normalize": lambda m, q, _p, _v: m.Quaternion(q).normalize().inner,
        "inverse": lambda m, q, _p, _v: m.Quaternion(q).inverse().inner,
        "conjugate": lambda m, q, _p, _v: m.Quaternion(q).conjugate().inner,
        "mul": lambda m, q, p, _v: (m.Quaternion(q) * m.Quaternion(p)).inner,
        "add": lambda m, q, p, _v: (m.Quaternion(q) + m.Quaternion(p)).inner,
        "rotate": lambda m, q, _p, vec: m.Quaternion(q) @ vec,
        "inverse_rotate": lambda m, q, _p, vec: m.Quaternion(q).inverse() @ vec,
    }
    for op in ops.values():
        _check(lambda q, p, vec: op(jsp, q, p, vec), lambda q, p, vec: op(tsp, q, p, vec),
               a, b, v)


def test_quaternion_on_spatial_values():
    a, _, _, tf, mo = _quat_args(10)
    for cls in ("SpatialTransform", "SpatialMotion", "SpatialForce"):
        arr = tf if cls == "SpatialTransform" else mo

        def op(m, q, x, cls=cls):
            return (m.Quaternion(q) @ getattr(m, cls).from_array(x)).inner

        _check(lambda q, x: op(jsp, q, x), lambda q, x: op(tsp, q, x), a, arr)


def test_axis_angle_and_transform_angular():
    r = _rng(11)
    axis, angle, lin = r.normal(size=(N, 3)), r.uniform(-7, 7, N), r.normal(size=(N, 3))
    _check(lambda x, t: jsp.Quaternion.from_axis_angle(x, t).inner,
           lambda x, t: tsp.Quaternion.from_axis_angle(x, t).inner, axis, angle)
    _check(lambda x, t: jsp.quat_from_axis_angle(x, t),
           lambda x, t: tsp.quat_from_axis_angle(x, t), axis, angle)
    _check(lambda x, t: jsp.SpatialTransform.from_axis_angle(x, t).inner,
           lambda x, t: tsp.SpatialTransform.from_axis_angle(x, t).inner, axis, angle)

    def build(m, x, t, p):
        tr = m.SpatialTransform(angular=m.Quaternion.from_axis_angle(x, t), linear=p)
        return tr.inner, tr.angular().inner

    _check(lambda *z: build(jsp, *z), lambda *z: build(tsp, *z), axis, angle, lin)
    q = tsp.SpatialTransform(angular=tsp.Quaternion.identity()).angular()
    assert isinstance(q, tsp.Quaternion)
    np.testing.assert_array_equal(q.inner.numpy(), [0.0, 0.0, 0.0, 1.0])
