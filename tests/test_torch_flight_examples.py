"""The port's last four core-API examples against the JAX package's: frames,
rocket-barrowman, crazyflie-edu and rc-jet (``elodin_tpu_torch/examples/
{frames,rocket_barrowman,crazyflie_edu,rc_jet}`` against ``examples/...``).

Per example, on the CPU in f64:

* ``world()``'s snapshot equals the JAX package's bit for bit;
* both packages run ``World.build`` → ``Exec.run`` from the same world and
  every float column agrees to max |Δ| / max |ref| ≤ 1e-10, each channel
  group of a transform or motion against its own scale;
* the JAX test's own asserts (``tests/test_examples.py``) hold on the
  port's run, at the JAX test's depths; crazyflie-edu's lab and rc-jet's
  mission are flown here to t = 8 s and t = 10 s, and whole, with every
  gate, in ``tests/test_torch_crazyflie_lab.py`` and
  ``tests/test_torch_rc_jet_mission.py``.

The comparison runs where the JAX package's own result is reproducible to
well under 1e-10.  Its tick is one XLA program, and XLA contracts a
multiply and an add into one FMA; with FMAs off
(``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``) the JAX package's own result
moves by 2.8e-11 at 400 ticks of rocket-barrowman and 5.4e-9 at 1200 (its
angle of attack is an ``arccos`` near 1, which magnifies a last-bit
difference ~1e8 times), and crazyflie-edu's angular channels at 1000
ticks of its vertical climb are FMA residue (~1e-17 rad/s against an
exact 0 without FMAs; 4.2e-8 in its torque at 8500, a difference of
nearly equal motor torques on the ground).  So rocket-barrowman is
compared at 300 ticks and crazyflie-edu at 2000 and 4000, and the JAX
tests' gates run on the port's whole flights; frames and rc-jet agree
at every depth.
"""

import contextlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elodin_tpu_torch.examples.crazyflie_edu import config as tcfg
from elodin_tpu_torch.examples.crazyflie_edu import sim as tcf
from elodin_tpu_torch.examples.frames import main as tfr
from elodin_tpu_torch.examples.rc_jet import sim as trj
from elodin_tpu_torch.examples.rocket_barrowman import barrowman as tbar
from elodin_tpu_torch.examples.rocket_barrowman import main as trb
from elodin_tpu_torch.spatial import quat_rotate
from test_torch_core_examples import TOL, _hold_columns, _snapshot_bitwise
from torch_port_util import float_policy, jax_example, rel_err

RB_TICKS, RB_COMPARE_TICKS = 1200, 300
CF_GATES = (1000, 4000)  # t = 2 s and 8 s of the lab (t = 17 s: test_torch_crazyflie_lab.py)
CF_COMPARE_TICKS = (2000, 4000)
RJ_COMPARE_TICKS = 2400  # t = 10 s, the JAX test's first gate


@contextlib.contextmanager
def _path_restored():
    """rocket-barrowman's JAX main puts its directory on ``sys.path``
    itself: keep it from outliving the load."""
    saved = list(sys.path)
    try:
        yield
    finally:
        sys.path[:] = saved


def _jax(example):
    with _path_restored():
        if example == "frames":
            return jax_example("frames", "main")
        if example == "rocket-barrowman":
            bar = jax_example("rocket-barrowman", "barrowman")
            return jax_example("rocket-barrowman", "main", modules={"barrowman": bar})
        if example == "crazyflie-edu":
            cfg = jax_example("crazyflie-edu", "config")
            return jax_example("crazyflie-edu", "sim", modules={"config": cfg})
        return jax_example("rc-jet", "sim")


def _build_both(tworld, tsys, jworld, jsys, rate):
    _snapshot_bitwise(tworld, jworld)
    return (tworld.build(tsys, simulation_rate=rate, device="cpu"),
            jworld.build(jsys, simulation_rate=rate))


def _worlds(example):
    j = _jax(example)
    if example == "frames":
        return tfr.build_two_body()[0], j.build_two_body()[0]
    t = {"rocket-barrowman": trb, "crazyflie-edu": tcf, "rc-jet": trj}[example]
    return t.world(), j.world()


@pytest.mark.parametrize("example", ["frames", "rocket-barrowman", "crazyflie-edu", "rc-jet"])
def test_world_snapshot_is_jax_bitwise(example):
    with float_policy("f64"):
        _snapshot_bitwise(*_worlds(example))


def test_module_constants_equal_jax():
    jrb, jcf, jrj = _jax("rocket-barrowman"), _jax("crazyflie-edu"), _jax("rc-jet")
    assert (trb.S_REF, trb.MARGIN_CAL, trb.AERO.cna, trb.AERO.xcp) == (
        jrb.S_REF, jrb.MARGIN_CAL, jrb.AERO.cna, jrb.AERO.xcp)
    np.testing.assert_array_equal(trb.WIND, np.asarray(jrb.WIND))
    assert trj.MAX_DEFLECT_RAD == float(jrj.MAX_DEFLECT_RAD)
    np.testing.assert_array_equal(trj.INERTIA, np.asarray(jrj.INERTIA))
    # the JAX autopilot's table, as it builds it each call
    mission = np.asarray(jnp.asarray([[m[0], m[1], jnp.radians(m[2])] for m in jrj.MISSION]))
    np.testing.assert_array_equal(trj._MISSION_T, mission[:, 0])
    np.testing.assert_array_equal(trj._MISSION_ALT_HDG, mission[:, 1:])
    jcfg = jax_example("crazyflie-edu", "config")
    for name in ("MOTOR_POS", "MOTOR_YAW_SIGN", "INERTIA", "HOVER_OMEGA_RADPS", "ARM_M",
                 "HOVER_THRUST_PER_MOTOR_N", "SIM_TIME_STEP"):
        np.testing.assert_array_equal(getattr(tcfg, name), getattr(jcfg, name), err_msg=name)
    np.testing.assert_array_equal(tcfg.mixing_matrix(), jcfg.mixing_matrix())
    np.testing.assert_array_equal(tcf._MIX, jcf._MIX)
    np.testing.assert_array_equal(tcf.WAYPOINTS, jcf.WAYPOINTS)


# -- frames --------------------------------------------------------------------------------


@pytest.mark.parametrize("frame", ["ENU", "NED"])
def test_frames_drop_matches_jax(frame):
    jfr = _jax("frames")
    with float_policy("f64"):
        z, jz = tfr.run_drop(frame, device="cpu"), jfr.run_drop(frame)
    assert z.shape == jz.shape == (121,)
    assert rel_err(z, jz) <= TOL
    # the JAX test's asserts (tests/test_examples.py:234-240)
    assert (z[-1] < z[0]) if frame == "ENU" else (z[-1] > z[0])


def test_frames_regression():
    """tests/test_examples.py:234-246 on the port, the two-body orbit held
    against the JAX package's over its 600 ticks."""
    jfr = _jax("frames")
    with float_policy("f64"):
        z_enu = tfr.run_drop("ENU", device="cpu")
        z_ned = tfr.run_drop("NED", device="cpu")
        assert z_enu[-1] < z_enu[0] and z_ned[-1] > z_ned[0]
        np.testing.assert_allclose(z_enu, -z_ned, atol=1e-12)
        w, s = tfr.build_two_body()
        jw, js = jfr.build_two_body()
        ex, jex = _build_both(w, s, jw, js, tfr.SIM_RATE)
        ex.run(600)
        jex.run(600)
    _hold_columns(ex, jex)
    names = ["a.world_pos", "b.world_pos", "a.world_vel", "b.world_vel"]
    e, je = tfr.total_energy(ex.history(names)), jfr.total_energy(jex.history(names))
    assert abs(e[-1] - e[0]) / abs(e[0]) < 1e-6
    assert rel_err(e, je) <= TOL


# -- rocket-barrowman ----------------------------------------------------------------------


def test_barrowman_prediction():
    """tests/test_examples.py:517-548 on the port's copy, every number
    equal to the JAX example's."""
    jbar = _jax("rocket-barrowman").solve.__globals__
    assert tbar.NoseCone(0.6, "conical").cna() == 2.0
    assert abs(tbar.NoseCone(0.6, "conical").xcp() - 0.4) < 1e-12
    assert abs(tbar.NoseCone(0.5, "ogive").xcp() - 0.233) < 1e-12
    d = 0.1
    assert tbar.Transition(1.0, 0.1, d, 0.06, d).cna() < 0
    assert tbar.Transition(1.0, 0.1, d, 0.14, d).cna() > 0
    base = dict(position=1.2, n=4, root_chord=0.12, tip_chord=0.06,
                span=0.11, sweep=0.06, body_radius=0.05, d_ref=0.1)
    small = tbar.FinSet(**base)
    big = tbar.FinSet(**{**base, "span": 0.16})
    assert big.cna() > small.cna() > 0

    comps, d_ref, xcg = tbar.calisto()
    aero = tbar.solve(comps)
    assert aero.xcp > 1.0
    margin = tbar.static_margin(aero, xcg, d_ref)
    assert 1.0 < margin < 4.0, margin

    jcomps, jd_ref, jxcg = jbar["calisto"]()
    jaero = jbar["solve"](jcomps)
    assert (d_ref, xcg) == (jd_ref, jxcg)
    assert (aero.cna, aero.xcp, aero.parts) == (jaero.cna, jaero.xcp, jaero.parts)
    assert margin == jbar["static_margin"](jaero, jxcg, jd_ref)
    for c, jc in zip(comps, jcomps):
        assert (c.cna(), c.xcp()) == (jc.cna(), jc.xcp())
    for cls, args in (("NoseCone", (0.5, "parabolic")), ("Transition", (1.0, 0.1, d, 0.14, d)),
                      ("FinSet", tuple(base.values()))):
        assert getattr(tbar, cls)(*args).cna() == jbar[cls](*args).cna()
        assert getattr(tbar, cls)(*args).xcp() == jbar[cls](*args).xcp()
    with pytest.raises(ValueError, match="unstable"):
        tbar.solve([tbar.Transition(1.0, 0.1, d, 0.06, d)])


def test_rocket_barrowman_stable_flight():
    """Both packages to ``RB_COMPARE_TICKS``, held; then the JAX test's
    gates (tests/test_examples.py:551-568) on the port's 1200 ticks."""
    jrb = _jax("rocket-barrowman")
    with float_policy("f64"):
        ex, jex = _build_both(trb.world(), trb.system(), jrb.world(), jrb.system(),
                              1.0 / trb.SIM_TIME_STEP)
        ex.record_history = jex.record_history = False
        ex.run(RB_COMPARE_TICKS)
        jex.run(RB_COMPARE_TICKS)
        _hold_columns(ex, jex)
        ex.run(RB_TICKS - RB_COMPARE_TICKS)
    pos = np.asarray(ex.read_component("calisto.world_pos")).ravel()
    vel = np.asarray(ex.read_component("calisto.world_vel")).ravel()
    assert pos[6] > 300.0, pos  # well off the pad
    nose = quat_rotate(torch.as_tensor(pos[:4]), torch.tensor([0.0, 0.0, 1.0],
                                                              dtype=torch.float64)).numpy()
    v = vel[3:] / np.linalg.norm(vel[3:])
    angle = np.degrees(np.arccos(np.clip(nose @ v, -1, 1)))
    assert angle < 25.0, angle


# -- crazyflie-edu -------------------------------------------------------------------------


def test_crazyflie_edu_lab_flight():
    """The lab to t = 8 s on the port with the JAX test's first two gates
    (tests/test_examples.py:571-588), held against the JAX package's at
    ``CF_COMPARE_TICKS``."""
    jcf = _jax("crazyflie-edu")
    with float_policy("f64"):
        ex, jex = _build_both(tcf.world(), tcf.system(), jcf.world(), jcf.system(),
                              tcf.SIM_RATE_HZ)
        ex.record_history = jex.record_history = False

        def pos():
            return np.asarray(ex.read_component("crazyflie.world_pos")).ravel()[4:]

        for tick in sorted(set(CF_GATES) | set(CF_COMPARE_TICKS)):
            ex.run(tick - ex.tick())
            if tick in CF_COMPARE_TICKS:
                jex.run(tick - jex.tick())
                _hold_columns(ex, jex)
            p = pos()
            if tick == 1000:  # t=2s: hovering at the first waypoint
                assert abs(p[2] - 0.6) < 0.05, p
            elif tick == 4000:  # t=8s: corner (0.6, 0.6)
                assert abs(p[0] - 0.6) < 0.05 and abs(p[1] - 0.6) < 0.05, p


# -- rc-jet --------------------------------------------------------------------------------


def test_rc_jet_autopilot_mission():
    """Both packages to t = 10 s, held, and the JAX test's first gate
    (tests/test_examples.py:623-636) on the port's run."""
    jrj = _jax("rc-jet")
    with float_policy("f64"):
        ex, jex = _build_both(trj.world(), trj.system(), jrj.world(), jrj.system(),
                              trj.SIM_RATE_HZ)
        ex.record_history = jex.record_history = False

        def state():
            pos = np.asarray(ex.read_component("bdx.world_pos")).ravel()
            vel = np.asarray(ex.read_component("bdx.world_vel")).ravel()
            ab = np.degrees(np.asarray(ex.read_component("bdx.alpha_beta")).ravel())
            hdg = np.degrees(np.arctan2(vel[4], vel[3]))
            return pos[6], np.linalg.norm(vel[3:]), hdg, ab

        ex.run(RJ_COMPARE_TICKS)
        jex.run(RJ_COMPARE_TICKS)
        _hold_columns(ex, jex)
        alt, spd, hdg, _ = state()
        assert abs(alt - 120.0) < 10.0 and abs(hdg - 90.0) < 2.0, (alt, hdg)
