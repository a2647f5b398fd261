"""The core-API examples of the port against the JAX package's: rotating-cube,
geo-frames, ellipsoid, covariance-ellipsoids, sensor-camera and voyager
(``elodin_tpu_torch/examples/...`` against ``examples/...``, loaded
through ``torch_port_util.jax_example``; apollo-lander is
``tests/test_torch_apollo_lander.py``).

Per example, on the CPU in f64:

* ``world()``'s snapshot equals the JAX package's bit for bit;
* both packages run ``World.build`` → ``Exec.run`` to the JAX test's own
  depth (``tests/test_examples.py``), voyager to a cut depth, and every
  float column agrees to max |Δ| / max |ref| ≤ 1e-10, each channel group
  of a transform or motion against its own scale;
* the JAX test's own asserts hold on the port's run.
"""

import math

import numpy as np

from elodin_tpu_torch import interop
from torch_port_util import float_policy, jax_example, rel_err

TOL = 1e-10


def _snapshot_bitwise(tworld, jworld):
    tmeta, tcols = tworld.snapshot()
    jmeta, jcols = jworld.snapshot()
    assert tmeta.comp_entities == jmeta.comp_entities
    assert tmeta.entity_names == jmeta.entity_names
    assert {n: m.metadata for n, m in tmeta.components.items()} == {
        n: m.metadata for n, m in jmeta.components.items()}
    assert tcols.keys() == jcols.keys()
    for name, ref in jcols.items():
        assert tcols[name].dtype == ref.dtype, name
        np.testing.assert_array_equal(tcols[name], ref, err_msg=name)


def _run_both(tworld, tsys, jworld, jsys, rate, ticks):
    """Both packages from the same world, ``ticks`` ticks each; every float
    column held to ``TOL``, the rest equal.  Returns (port, JAX) Execs."""
    with float_policy("f64"):
        _snapshot_bitwise(tworld, jworld)
        texec = tworld.build(tsys, simulation_rate=rate, device="cpu")
        jexec = jworld.build(jsys, simulation_rate=rate)
        texec.run(ticks)
        jexec.run(ticks)
    _hold_columns(texec, jexec)
    return texec, jexec


def _hold_columns(texec, jexec):
    ours = interop.columns_to_numpy(texec.cols, texec.meta)
    assert int(texec.tick()) == int(jexec.tick())
    for name in jexec.meta.components:
        ref = np.asarray(jexec.column_array(name))
        if ref.dtype.kind == "f":
            assert rel_err(ours[name], ref) <= TOL, name
        else:
            np.testing.assert_array_equal(ours[name], ref, err_msg=name)


def test_rotating_cube_quarter_turn():
    from elodin_tpu_torch.examples.rotating_cube import sim

    jsim = jax_example("rotating-cube", "sim")
    ex, _ = _run_both(sim.world(), sim.system(), jsim.world(), jsim.system(),
                      1.0 / sim.SIM_TIME_STEP, 120)
    # tests/test_examples.py:319-328 on the port's run
    q = np.asarray(ex.read_component("cube.world_pos"))
    assert abs(abs(q[0]) - math.sin(math.pi / 4)) < 1e-4
    assert abs(q[3] - math.cos(math.pi / 4)) < 1e-4
    assert np.allclose(q[4:], [0.0, 0.0, 1.0])


def test_geo_frames_markers_and_enu():
    from elodin_tpu_torch.examples.geo_frames import sim

    jsim = jax_example("geo-frames", "sim")
    ex, _ = _run_both(sim.world(), sim.system(), jsim.world(), jsim.system(), 60.0, 30)
    # tests/test_examples.py:331-340
    pole = np.asarray(ex.read_component("ecef_north_pole.world_pos"))
    assert abs(pole[6] - 6356752.314245) < 1.0
    up = sim.ecef_from_enu(0.0, 0.0, 1000.0)
    origin = sim.ecef_from_enu(0.0, 0.0, 0.0)
    assert abs(np.linalg.norm(up - origin) - 1000.0) < 1e-6
    np.testing.assert_array_equal(up, jsim.ecef_from_enu(0.0, 0.0, 1000.0))


def test_geo_frames_orbit_matches_jax():
    """The kinematic orbit the default system leaves out."""
    import elodin_tpu_torch as tel
    from elodin_tpu_torch.examples.geo_frames import sim

    jsim = jax_example("geo-frames", "sim")
    _run_both(sim.world(), sim.orbit | tel.six_dof(sys=()), jsim.world(),
              jsim.orbit | jsim.el.six_dof(sys=()), 60.0, 30)


def test_ellipsoid_drone_path_and_camera():
    from elodin_tpu_torch.examples.ellipsoid import sim

    jsim = jax_example("ellipsoid", "sim")
    w, _body = sim.world()
    ex, _ = _run_both(w, sim.system(), jsim.world()[0], jsim.system(), sim.SIM_RATE, 240)
    # tests/test_examples.py:343-356
    drone = np.asarray(ex.read_component("drone.world_pos"))
    shell = np.asarray(ex.read_component("ellipsoid.world_pos"))
    assert np.all(np.isfinite(drone))
    assert abs(drone[4]) <= sim.DRONE_PATH_RADIUS[0] + 1e-9
    assert np.allclose(shell[4:], 0.0)
    assert any("scene_cam" in k for k in w.assets)
    assert ex.schematic_content == w.schematic_content


def test_covariance_ellipsoids_agree():
    from elodin_tpu_torch.examples.covariance_ellipsoids import main as sim

    jsim = jax_example("covariance-ellipsoids", "main")
    ex, _ = _run_both(sim.world(), sim.system(), jsim.world(), jsim.system(), sim.SIM_RATE, 97)
    # tests/test_examples.py:460-475
    packed_l = np.asarray(ex.read_component("cholesky.cholesky_factor"))
    packed_cov = np.asarray(ex.read_component("covariance.error_covariance"))
    L = np.zeros((3, 3))
    L[np.tril_indices(3)] = packed_l
    cov = np.zeros((3, 3))
    cov[np.tril_indices(3)] = packed_cov
    cov = cov + np.tril(cov, -1).T
    np.testing.assert_allclose(L @ L.T, cov, atol=1e-12)
    assert np.all(np.linalg.eigvalsh(cov) > 0)


def test_sensor_camera_room():
    from elodin_tpu_torch.examples.sensor_camera import main as sim

    jsim = jax_example("sensor-camera", "main")
    w = sim.world()
    ex, _ = _run_both(w, sim.system(), jsim.world(), jsim.system(),
                      1.0 / sim.SIM_TIME_STEP, 600)
    # tests/test_examples.py:502-515
    for i in range(8):
        p = np.asarray(ex.read_component(f"ball_{i}.world_pos"))[4:]
        assert np.all(np.abs(p[:2]) <= sim.BOUNDARY + 1e-6), (i, p)
        assert sim.BALL_RADIUS - 1e-6 <= p[2] <= 2 * sim.BOUNDARY + 1e-6, (i, p)
    cams = [k for k in w.assets if "cam" in k]
    assert len(cams) == 2
    assert w.assets == jsim.world().assets


def test_voyager_transfer_matches_jax():
    """2000 hour-long ticks (83 days of the transfer) in both packages, cut
    from the JAX test's four years: the probe is still on its bound
    transfer orbit, and Jupiter on its circle."""
    from elodin_tpu_torch.examples.voyager import main as sim

    jsim = jax_example("voyager", "main")
    w, sysm = sim.build()
    jw, jsys = jsim.build()
    ex, _ = _run_both(w, sysm, jw, jsys, sim.SIMULATION_RATE_HZ, 2000)
    pos = np.asarray(ex.read_component("voyager.world_pos")).ravel()[4:]
    vel = np.asarray(ex.read_component("voyager.world_vel")).ravel()[3:]
    assert -160e6 < sim.specific_energy(pos, vel) < -100e6  # a bound transfer orbit
    jup = np.asarray(ex.read_component("jupiter.world_pos")).ravel()[4:]
    assert abs(np.linalg.norm(jup) / sim.AU - 5.203) < 1e-6
