"""The check that a run loaded neither JAX nor the JAX package compares
top-level names whole."""

import subprocess
import sys

import pytest

from benchmark.harness import nojax
from benchmark.harness.spec import ROOT


@pytest.mark.parametrize("names, found", [
    (["elodin_tpu_torch", "elodin_tpu_torch.ops.pairwise", "torch", "numpy"], []),
    (["elodin_tpu_torch.models", "elodin_tpu.ops"], ["elodin_tpu"]),
    (["elodin_tpu"], ["elodin_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["elodin", "jaxtyping", "elodin_tpu_torchx"], ["elodin"]),
])
def test_top_level_names_compared_whole(names, found):
    assert nojax.forbidden_modules(names) == found


def test_the_harness_and_the_port_load_no_jax():
    """What a run imports (the harness, both entry drivers, the port's
    models and kernels' wrappers) leaves no forbidden module behind."""
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from benchmark.harness import runner, spec, nojax\n"
            "for name in ('leo6dof.rollout-8k', 'nbody.fold-8k'):\n"
            "    cell = spec.cell(name); cell.entry(); cell.reference()\n"
            "import elodin_tpu_torch, elodin_tpu_torch.models.nbody, elodin_tpu_torch.ops.sixdof_kernel\n"
            "print(nojax.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
