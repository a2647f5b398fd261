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

from elodin_tpu_torch import verify
from elodin_tpu_torch.examples.falcon9 import batched as f9
from elodin_tpu_torch.examples.monte_carlo import batched as landing
from elodin_tpu_torch.examples.rocket import batched as rocket_batched
from elodin_tpu_torch.examples.three_body import main as three_body
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


def _cloud(n, seed, device, dtype):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 10
    mass = rng.uniform(1, 5, n)
    return (torch.as_tensor(pos, device=device, dtype=dtype),
            torch.as_tensor(mass, device=device, dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 127, 129, 300, 1000, 4099])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-12)])
def test_pairwise_kernel_at_plan_boundaries(cuda, n, dtype, tol):
    """Sizes where the launch plan's rows, slices or cluster change."""
    pos, mass = _cloud(n, n, cuda, dtype)
    for eps in (0.0, 0.1):
        ours = pw.pairwise_gravity(pos, mass, g=1.0, eps=eps)
        ref = pw.pairwise_gravity_reference(pos, mass, g=1.0, eps=eps)
        assert torch.isfinite(ours).all()
        if n == 1:
            assert torch.equal(ours, torch.zeros_like(ours))
        else:
            assert rel_err(ours, ref) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pairwise_kernel_exact_zero_cases(cuda, dtype):
    """d2 == 0 at a body on the origin against the tail slots, at coincident
    bodies and at a zero mass: the remap keeps every sum finite and equal
    to the plain version's."""
    pos, mass = _cloud(1000, 5, cuda, dtype)
    pos[0] = 0.0
    pos[9] = pos[4]
    pos[500:503] = pos[600]
    mass[11] = 0.0
    ours = pw.pairwise_gravity(pos, mass, g=1.0)
    ref = pw.pairwise_gravity_reference(pos, mass, g=1.0)
    assert torch.isfinite(ours).all()
    assert rel_err(ours, ref) <= {torch.float32: 1e-4, torch.float64: 1e-12}[dtype]
    # coincident bodies add exactly zero to each other, so bodies 500-502
    # feel the same sum, to the bit
    assert torch.equal(ours[500], ours[501]) and torch.equal(ours[501], ours[502])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pairwise_kernel_is_bitwise_deterministic(cuda, dtype):
    pos, mass = _nbody_inputs(4099, cuda, dtype)
    first = pw.pairwise_gravity(pos, mass, g=G)
    for _ in range(3):
        assert torch.equal(pw.pairwise_gravity(pos, mass, g=G), first)


@pytest.mark.gpu
def test_pairwise_kernel_alignment_and_refused_plans(cuda):
    pos, mass = _cloud(300, 6, cuda, torch.float32)
    with pytest.raises(ValueError, match="aligned"):
        pw._pairwise_gravity_cuda(pos[1:], mass[1:], 1.0, 0.0)
    # the public entry point copies a misaligned view
    out = pw.pairwise_gravity(pos[1:], mass[1:], g=1.0)
    assert rel_err(out, pw.pairwise_gravity_reference(pos[1:], mass[1:], 1.0)) <= 1e-4
    before = pw.LAUNCHES
    for plan in (pw.Plan(48, 1, 1, 512), pw.Plan(32, 3, 1, 512), pw.Plan(32, 1, 9, 64),
                 pw.Plan(32, 1, 1, 100), pw.Plan(32, 1, 1, 64)):
        with pytest.raises(RuntimeError, match="cudaError"):
            pw._pairwise_gravity_cuda(pos, mass, 1.0, 0.0, plan)
    assert pw.LAUNCHES == before


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


# ---------------------------------------------------------------------------
# the rocket, landing and three-body examples (eager PyTorch ops, no hand
# kernel)
#
# Stated tolerance, f64: ≤ 1e-9 per channel group after the run, the
# landed and soft flags identical; verify_trajectory's allclose(1e-6,
# 1e-6), the card against the CPU.
# ---------------------------------------------------------------------------


def _campaign_errors(gpu, cpu):
    out = {}
    for k in cpu.final:
        r = cpu.column(k)
        if r.dtype.kind == "f":
            out[k] = rel_err(gpu.column(k), r)
        else:
            np.testing.assert_array_equal(gpu.column(k), r, err_msg=k)
    return out


@pytest.mark.gpu
def test_rocket_campaign_on_the_card_matches_the_cpu(cuda):
    results = {str(d): rocket_batched.make_campaign(64, device=d).run(120) for d in (cuda, "cpu")}
    gpu, cpu = results[str(cuda)], results["cpu"]
    assert gpu.final["world_pos"].device.type == "cuda"
    errs = _campaign_errors(gpu, cpu)
    assert max(errs.values()) <= 1e-9, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.gpu
def test_landing_campaign_on_the_card_matches_the_cpu(cuda):
    results = {}
    for d in (cuda, "cpu"):
        campaign, _ = landing.make_campaign(256, seed=3, device=d)
        results[str(d)] = campaign.run(2400)
    gpu, cpu = results[str(cuda)], results["cpu"]
    ours, ref = landing.scores(gpu), landing.scores(cpu)
    np.testing.assert_array_equal(ours["landed"], ref["landed"])
    np.testing.assert_array_equal(ours["soft"], ref["soft"])
    assert ours["landed"].mean() > 0.9
    errs = _campaign_errors(gpu, cpu)
    assert max(errs.values()) <= 1e-9, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.gpu
def test_verify_trajectory_three_body_card_vs_cpu(cuda):
    report = verify.verify_trajectory(three_body.build_world(), three_body.build_system(),
                                      ticks=100, simulation_rate=120.0)
    assert report["_summary"]["devices"] == ["cpu", "cuda"]
    assert report["_summary"]["metric_rel"] <= 1e-12


# ---------------------------------------------------------------------------
# the drone and the cube-sat (eager PyTorch ops, no hand kernel)
#
# Stated tolerance, f64: verify_trajectory's allclose(1e-6, 1e-6), the card
# against the CPU, 100 ticks, and the CSV gate on the card (abs or rel 1e-4
# against the re-exported baselines).
# ---------------------------------------------------------------------------


def _drone_and_cube_sat():
    from elodin_tpu_torch.examples.cube_sat import main as cube_sat
    from elodin_tpu_torch.examples.drone import main as drone

    return {"drone": drone, "cube-sat": cube_sat}


@pytest.mark.gpu
@pytest.mark.parametrize("example", ["drone", "cube-sat"])
def test_verify_trajectory_drone_and_cube_sat_card_vs_cpu(cuda, example):
    from elodin_tpu_torch import regress

    mod = _drone_and_cube_sat()[example]
    before = (sk.LAUNCHES, pw.LAUNCHES)
    report = verify.verify_trajectory(mod.build_world(), mod.build_system(), ticks=100,
                                      simulation_rate=regress.simulation_rate(mod))
    assert report["_summary"]["devices"] == ["cpu", "cuda"]
    assert report["_summary"]["max_excess"] <= 1e-6
    assert (sk.LAUNCHES, pw.LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("example", ["drone", "cube-sat"])
def test_csv_gate_on_the_card(cuda, example):
    from elodin_tpu_torch import regress

    exec_, _, n, worst = regress.check(example, device="cuda")
    assert exec_.cols["world_pos"].device.type == "cuda" and exec_.tick() == regress.TICKS
    assert n == {"drone": 33, "cube-sat": 56}[example] and worst <= 1.0


# ---------------------------------------------------------------------------
# JAX's threefry, the ball, linalg and stablehlo examples, the falcon9
# sensors and checkpoints (eager PyTorch ops, no hand kernel)
#
# Stated tolerance: threefry words and uniforms bit for bit, the card
# against the CPU; normals within 3 ulps in f32 and 8 in f64 (the card's
# erfinv is CUDA's, documented at 2 and 5 ulps; the CPU's is within 1 and 3
# ulps of a correctly rounded one); the CSV gate on the card (abs or
# rel 1e-4 against scripts/baseline); falcon9 with sensors,
# verify_trajectory's allclose(1e-6, 1e-6) and max |Δ|/(1+|x|) ≤ 1e-6 under
# f64 and the mixed policy; checkpoints bitwise.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 20170814, 2**32 + 5, -7])
def test_threefry_on_the_card_matches_the_cpu(cuda, seed):
    from elodin_tpu_torch.ops import threefry as tf

    def draws(device):
        key = tf.key(torch.tensor(seed, dtype=torch.int64, device=device))
        data = torch.tensor([-1, 0, 6, 2**31 - 1], dtype=torch.int32, device=device)
        return ([key, tf.fold_in(key, data), tf.split(key, 4), tf.bits(key, (4099,)),
                 *tf.bits(key, (4099,), 64), tf.uniform(key, (4099,), torch.float32),
                 tf.uniform(key, (4099,), torch.float64)],
                [tf.normal(key, (4099,), dtype) for dtype in (torch.float32, torch.float64)])

    (words, normals), (ref_words, ref_normals) = draws(cuda), draws("cpu")
    for ours, ref in zip(words, ref_words):
        assert torch.equal(ours.cpu(), ref)
    for ours, ref in zip(normals, ref_normals):
        ulp = torch.as_tensor(np.spacing(np.abs(ref.numpy())))
        bound = {torch.float32: 3, torch.float64: 8}[ref.dtype]
        assert ((ours.cpu() - ref).abs() <= bound * ulp).all()


@pytest.mark.gpu
@pytest.mark.parametrize("example", ["ball", "linalg", "stablehlo"])
def test_baselined_examples_csv_gate_on_the_card(cuda, example):
    from elodin_tpu_torch import regress

    before = (sk.LAUNCHES, pw.LAUNCHES)
    exec_, _, n, worst = regress.check(example, device="cuda")
    assert exec_.cols["tick"].device.type == "cuda" and exec_.tick() == regress.TICKS
    assert n == {"ball": 9, "linalg": 10, "stablehlo": 6}[example] and worst <= 1.0
    assert (sk.LAUNCHES, pw.LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["f64", "mixed"])
def test_falcon9_with_sensors_card_vs_cpu(cuda, policy):
    import elodin_tpu_torch as el
    from elodin_tpu_torch import _config
    from elodin_tpu_torch.examples.falcon9 import sim

    prev = _config._FLOAT_POLICY
    el.set_float_policy(policy)
    try:
        world, system = sim.build(None)
        report = verify.verify_trajectory(world, system, ticks=100,
                                          simulation_rate=sim.SIM_RATE_HZ)
    finally:
        el.set_float_policy(prev)
    assert report["_summary"]["metric_rel"] <= 1e-6


@pytest.mark.gpu
def test_checkpoint_restore_on_the_card(cuda, tmp_path):
    from elodin_tpu_torch.examples.stablehlo import sim

    exec_ = sim.build_world().build(sim.build_system(), device="cuda")
    exec_._history.max_bytes = 2000  # spill, so restore cuts spilled chunks
    exec_._history._spool_dir = str(tmp_path / "spool")
    exec_.run(30)
    first = {k: v.clone() for k, v in exec_.cols.items()}
    exec_.save_checkpoint(tmp_path / "state.npz")
    exec_.restore(10)
    exec_.run(20)
    assert all(torch.equal(first[k], exec_.cols[k]) for k in first)
    exec_.run(5)
    exec_.load_checkpoint(tmp_path / "state.npz")
    assert all(torch.equal(first[k], exec_.cols[k]) for k in first)
