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
