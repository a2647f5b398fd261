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
    """What a run imports (the harness, the entry and the reference of every
    cell in BENCHMARK.json, the module its ``system`` names, the port and
    its kernels' wrappers) leaves no forbidden module behind."""
    code = ("import importlib, sys; sys.path.insert(0, sys.argv[1])\n"
            "from benchmark.harness import runner, spec, nojax\n"
            "for w in spec.load_benchmark()['workloads']:\n"
            "    cell = spec.cell(w['name']); cell.entry(); cell.reference()\n"
            "    if 'system' in cell.traffic:\n"
            "        importlib.import_module(cell.traffic['system'].split(':')[0])\n"
            "import elodin_tpu_torch, elodin_tpu_torch.ops.sixdof_kernel\n"
            "print(nojax.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
