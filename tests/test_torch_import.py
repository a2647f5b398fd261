"""The port stands alone: importing it loads no JAX, and importing its
kernel modules needs neither nvcc nor a GPU."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "elodin_tpu_torch",
    "elodin_tpu_torch.interop",
    "elodin_tpu_torch.models",
    "elodin_tpu_torch.ops.sixdof_kernel",
    "elodin_tpu_torch.ops._build",
    "elodin_tpu_torch.ops.interp",
    "elodin_tpu_torch.frames",
    "elodin_tpu_torch.monte_carlo",
    "elodin_tpu_torch.examples.falcon9.sim",
    "elodin_tpu_torch.examples.falcon9.batched",
    "elodin_tpu_torch.examples.three_body.main",
    "elodin_tpu_torch.examples.rocket.main",
    "elodin_tpu_torch.examples.rocket.batched",
    "elodin_tpu_torch.examples.monte_carlo.sim",
    "elodin_tpu_torch.examples.monte_carlo.batched",
    "elodin_tpu_torch.examples.drone.main",
    "elodin_tpu_torch.examples.drone.params",
    "elodin_tpu_torch.examples.drone.filter",
    "elodin_tpu_torch.examples.drone.motors",
    "elodin_tpu_torch.examples.drone.shaping",
    "elodin_tpu_torch.examples.drone.sensors",
    "elodin_tpu_torch.examples.drone.mekf",
    "elodin_tpu_torch.examples.drone.control",
    "elodin_tpu_torch.examples.cube_sat.main",
    "elodin_tpu_torch.ops.fastrand",
    "elodin_tpu_torch.ops.smallalg",
    "elodin_tpu_torch.adcs",
    "elodin_tpu_torch.adcs.mekf",
    "elodin_tpu_torch.adcs.lqr",
    "elodin_tpu_torch.gravity",
    "elodin_tpu_torch.gravity.egm08",
    "elodin_tpu_torch.gravity.egm08_coeffs",
    "elodin_tpu_torch.verify",
    "elodin_tpu_torch.regress",
    "elodin_tpu_torch.ops.threefry",
    "elodin_tpu_torch.linalg",
    "elodin_tpu_torch.sensors",
    "elodin_tpu_torch.examples.ball.sim",
    "elodin_tpu_torch.examples.linalg.main",
    "elodin_tpu_torch.examples.stablehlo.sim",
    "elodin_tpu_torch.examples.falcon9.sensors",
    "elodin_tpu_torch.step_context",
    "elodin_tpu_torch.tick_metrics",
    "elodin_tpu_torch.lockstep",
    "elodin_tpu_torch.cli",
    "elodin_tpu_torch.__main__",
    "elodin_tpu_torch.monte_carlo.campaign",
    "elodin_tpu_torch.monte_carlo.calibrate",
    "elodin_tpu_torch.examples.monte_carlo.main",
    "elodin_tpu_torch.examples.betaflight_sitl.main",
    "elodin_tpu_torch.examples.betaflight_sitl.controller",
    "elodin_tpu_torch.diff",
    "elodin_tpu_torch.torchsim",
    "elodin_tpu_torch.examples.orbit_retarget.main",
    "elodin_tpu_torch.examples.neural_hover.main",
    "elodin_tpu_torch.examples.cube_sat_pysim.main",
    "elodin_tpu_torch.adcs.triad",
    "elodin_tpu_torch.adcs.ukf",
    "elodin_tpu_torch.adcs.magical",
    "elodin_tpu_torch.adcs.magkal",
    "elodin_tpu_torch.gravity.j2",
    "elodin_tpu_torch.parallel",
    "elodin_tpu_torch.parallel.mesh",
    "elodin_tpu_torch.parallel.dryrun",
    "elodin_tpu_torch.kdl",
    "elodin_tpu_torch.schematic",
    "elodin_tpu_torch.examples.falcon9.main",
    "elodin_tpu_torch.examples.rotating_cube.sim",
    "elodin_tpu_torch.examples.geo_frames.sim",
    "elodin_tpu_torch.examples.ellipsoid.sim",
    "elodin_tpu_torch.examples.covariance_ellipsoids.main",
    "elodin_tpu_torch.examples.sensor_camera.main",
    "elodin_tpu_torch.examples.voyager.main",
    "elodin_tpu_torch.examples.apollo_lander.main",
    "elodin_tpu_torch.examples.n_body.main",
    "elodin_tpu_torch.examples.n_body.batched",
    "elodin_tpu_torch.wmm",
    "elodin_tpu_torch.examples.frames.main",
    "elodin_tpu_torch.examples.rocket_barrowman.barrowman",
    "elodin_tpu_torch.examples.rocket_barrowman.main",
    "elodin_tpu_torch.examples.crazyflie_edu.config",
    "elodin_tpu_torch.examples.crazyflie_edu.sim",
    "elodin_tpu_torch.examples.crazyflie_edu.main",
    "elodin_tpu_torch.examples.rc_jet.sim",
    "elodin_tpu_torch.examples.rc_jet.main",
    "elodin_tpu_torch.db",
    "elodin_tpu_torch.db.__main__",
    "elodin_tpu_torch.db.server",
    "elodin_tpu_torch.db.follow",
    "elodin_tpu_torch.db.framing",
    "elodin_tpu_torch.db.eql",
    "elodin_tpu_torch.db.export",
    "elodin_tpu_torch.db.downsample",
    "elodin_tpu_torch.native",
    "elodin_tpu_torch.plotline",
    "elodin_tpu_torch.status",
    "elodin_tpu_torch.db.mirror",
    "elodin_tpu_torch.db.ws",
    "elodin_tpu_torch.db.webui",
    "elodin_tpu_torch.db.scenemath",
    "elodin_tpu_torch.db.video",
    "elodin_tpu_torch.db.export_mcap",
    "elodin_tpu_torch.db.assets",
    "elodin_tpu_torch.testing",
    "elodin_tpu_torch.s10",
    "elodin_tpu_torch.examples.db_client.main",
    "elodin_tpu_torch.examples.logstream.main",
    "elodin_tpu_torch.examples.video_stream.main",
    "elodin_tpu_torch.examples.udp_component_broadcast.broadcast",
    "elodin_tpu_torch.examples.udp_component_broadcast.receive",
    "elodin_tpu_torch.fsw",
    "elodin_tpu_torch.fsw_services",
    "elodin_tpu_torch.rtsp",
    "elodin_tpu_torch.msp_osd",
    "elodin_tpu_torch.inscribe",
    "elodin_tpu_torch.utils",
    "elodin_tpu_torch.utils.glbgen",
]


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_loads_no_jax():
    proc = _run(
        f"import sys, importlib\nfor m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'elodin_tpu.')) or m == 'elodin_tpu')\n"
        "print(bad); sys.exit(1 if bad else 0)")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_names_jax_or_the_jax_package():
    """No module of the port and no line of ``chip_smoke.py`` imports JAX or
    anything under ``elodin_tpu`` (not even a module there that imports no
    JAX: importing any ``elodin_tpu.*`` runs the package's ``__init__``).
    ``component_broadcast_pb2.py`` is generated protobuf code."""
    import re

    pat = re.compile(r"^\s*(?:import\s+(?:jax|jaxlib|elodin_tpu)\b(?!_torch)"
                     r"|from\s+(?:jax|jaxlib|elodin_tpu)\b(?!_torch)[\w.]*\s+import)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "elodin_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 150
    bad = [f"{os.path.relpath(f, REPO)}:{k}: {line.strip()}"
           for f in files for k, line in enumerate(open(f, encoding="utf-8"), 1)
           if pat.match(line)]
    assert not bad, bad


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    """Where the toolkit is missing the build fails with a message that
    says so (it never falls back to anything)."""
    from elodin_tpu_torch.ops import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_path_follows_source_hash():
    from elodin_tpu_torch.ops import _build

    path = _build.library_path("sixdof_rk4")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("sixdof_rk4-") and path.suffix == ".so"
    assert path == _build.library_path("sixdof_rk4")
