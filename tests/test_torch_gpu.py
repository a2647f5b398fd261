"""The CUDA kernels of the port on the card (``gpu`` marker).

These tests skip where there is no CUDA device; on a machine with one (and
nvcc) they build ``ops/csrc/sixdof_rk4.cu`` and
``ops/csrc/pairwise_gravity.cu`` and hold each kernel to its plain PyTorch
version.  This file imports no JAX, so it runs where only
the port is installed:

    python -m pytest tests/test_torch_gpu.py -q -m gpu

Stated tolerances for the rollout, max |Δ| / max |ref| per channel group:
f32 ≤ 1e-4 (rounding order, FMA contraction and rsqrtf's 2-ulp error
compound over 50 ticks); f64 ≤ 1e-12 (the same algebra in IEEE f64).
"""

import numpy as np
import pytest
import torch

from elodin_tpu_torch.examples.falcon9 import batched as f9
from elodin_tpu_torch.models.nbody import G, build_nbody
from elodin_tpu_torch.models.sixdof_batch import batched_sixdof_init
from elodin_tpu_torch.ops import pairwise as pw
from elodin_tpu_torch.ops import sixdof_kernel as sk
from torch_port_util import rel_err

DT = 1.0 / 120.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-12)])
def test_kernel_matches_plain_version(cuda, n, dtype, tol):
    cols = batched_sixdof_init(n, seed=1)
    before = sk.LAUNCHES
    ours = sk.sixdof_rollout(*cols, DT, 50, device=cuda, dtype=dtype)
    assert sk.LAUNCHES == before + 1
    ref = sk.sixdof_rollout_reference(*cols, DT, 50, device=cuda, dtype=dtype)
    assert ours[0].device.type == "cuda" and ours[0].dtype == dtype
    assert rel_err(ours[0], ref[0]) <= tol and rel_err(ours[1], ref[1]) <= tol


@pytest.mark.gpu
def test_zero_ticks_and_empty_batch(cuda):
    cols = batched_sixdof_init(33, seed=2)
    pos, vel = sk.sixdof_rollout(*cols, DT, 0, device=cuda, dtype=torch.float64)
    np.testing.assert_array_equal(pos.cpu().numpy(), cols[0])
    np.testing.assert_array_equal(vel.cpu().numpy(), cols[1])
    empty = [c[:0] for c in cols]
    pos, vel = sk.sixdof_rollout(*empty, DT, 5, device=cuda, dtype=torch.float32)
    assert pos.shape == (0, 7) and vel.shape == (0, 6)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    u = torch.zeros(sk.N_STATE, 8, device=cuda)
    par = torch.ones(sk.N_PARAM, 8, device=cuda)
    with pytest.raises(TypeError):
        sk._rollout_cuda(u.half(), par.half(), DT, 1)
    with pytest.raises(ValueError):
        sk._rollout_cuda(u[:, ::2], par[:, ::2], DT, 1)  # non-contiguous
    with pytest.raises(ValueError):
        sk._rollout_cuda(u, par[:, :4], DT, 1)
    with pytest.raises(ValueError):
        sk._rollout_cuda(u.cpu(), par.cpu(), DT, 1)


# ---------------------------------------------------------------------------
# all-pairs gravity (ops/csrc/pairwise_gravity.cu)
#
# Stated tolerances, max |Δ| / max |ref| over the (N, 3) accelerations:
# f32 ≤ 1e-4 (one running sum over j against the plain version's chunked
# sums, rsqrtf's 2-ulp error); f64 ≤ 1e-12 (the same algebra in IEEE f64).
# ---------------------------------------------------------------------------


def _nbody_inputs(n, device, dtype):
    _, cols = build_nbody(n, seed=3).snapshot()
    pos = torch.as_tensor(cols["world_pos"][:, 4:], device=device, dtype=dtype)
    mass = torch.as_tensor(cols["inertia"][:, 6], device=device, dtype=dtype)
    return pos.contiguous(), mass.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 4099])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-12)])
def test_pairwise_kernel_matches_plain_version(cuda, n, dtype, tol):
    pos, mass = _nbody_inputs(n, cuda, dtype)
    before = pw.LAUNCHES
    ours = pw.pairwise_gravity(pos, mass, g=G)
    assert pw.LAUNCHES == before + 1
    ref = pw.pairwise_gravity_reference(pos, mass, g=G)
    assert ours.device.type == "cuda" and ours.dtype == dtype
    assert rel_err(ours, ref) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-12)])
def test_pairwise_kernel_softened_cloud(cuda, dtype, tol):
    """A unit cloud with eps = 0.1, two coincident bodies and a zero mass."""
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(300, 3)) * 10
    pos[7] = pos[3]
    mass = rng.uniform(1, 5, 300)
    mass[11] = 0.0
    pos = torch.as_tensor(pos, device=cuda, dtype=dtype)
    mass = torch.as_tensor(mass, device=cuda, dtype=dtype)
    for eps in (0.1, 0.0):
        ours = pw.pairwise_gravity(pos, mass, g=1.0, eps=eps)
        ref = pw.pairwise_gravity_reference(pos, mass, g=1.0, eps=eps)
        assert torch.isfinite(ours).all()
        assert rel_err(ours, ref) <= tol


@pytest.mark.gpu
def test_pairwise_kernel_empty_and_contract(cuda):
    before = pw.LAUNCHES
    out = pw.pairwise_gravity(torch.zeros(0, 3, device=cuda),
                              torch.zeros(0, device=cuda))
    assert out.shape == (0, 3) and pw.LAUNCHES == before
    pos = torch.zeros(8, 3, device=cuda)
    mass = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        pw._pairwise_gravity_cuda(pos.half(), mass.half(), 1.0, 0.0)
    with pytest.raises(TypeError):
        pw._pairwise_gravity_cuda(pos, mass.double(), 1.0, 0.0)
    with pytest.raises(ValueError):
        pw._pairwise_gravity_cuda(pos.T.contiguous().T, mass, 1.0, 0.0)
    with pytest.raises(ValueError):
        pw._pairwise_gravity_cuda(pos[:, :2], mass, 1.0, 0.0)
    with pytest.raises(ValueError):
        pw._pairwise_gravity_cuda(pos.cpu(), mass.cpu(), 1.0, 0.0)
    assert pw.LAUNCHES == before


# ---------------------------------------------------------------------------
# the falcon9 campaign (BatchedCampaign, eager PyTorch ops, no hand kernel)
#
# Stated tolerance, f64: ≤ 1e-9 per channel group (``state_errors``) after
# 100 ticks: the card's transcendental functions and reductions round
# differently from the CPU's in the last bit.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_falcon9_campaign_on_the_card_matches_the_cpu(cuda):
    runs = {}
    for device in (cuda, "cpu"):
        campaign, _ = f9.make_campaign(64, seed=0, device=device)
        result = campaign.run(100, history_every=50, history_components=f9.HISTORY_COMPONENTS,
                              until=f9.until_down)
        assert result.ticks == 100 and campaign.gated_runs == 20
        runs[str(device)] = result
    gpu, cpu = runs[str(cuda)], runs["cpu"]
    assert gpu.final["world_pos"].device.type == "cuda"
    ours = {k: gpu.column(k) for k in gpu.final}
    ref = {k: cpu.column(k) for k in cpu.final}
    for k in ours:
        assert np.isfinite(ours[k].astype(np.float64)).all(), k
    np.testing.assert_array_equal(ours["tick"], ref["tick"])
    np.testing.assert_array_equal(ours["phase"], ref["phase"])
    errs = f9.state_errors(ours, ref)
    assert max(errs.values()) <= 1e-9, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    np.testing.assert_array_equal(gpu.history["world_pos"][-1], ours["world_pos"])
