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
from elodin_tpu_torch.ops import _build
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


# every block size the launcher takes: one thread a body whatever the plan
K1_PLANS = range(sk.MIN_THREADS, sk.MAX_THREADS + 1, 32)
K1_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


def _k1_groups_rel(ours, ref):
    """max |Δ| / max |ref| over the channel groups of a (13, N) state."""
    return max(rel_err(ours[a:b].flatten(), ref[a:b].flatten())
               for a, b in ((0, 4), (4, 7), (7, 10), (10, 13)))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 32, 33, 127, 129, 8192, 32768, 32769, 131072])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_every_plan_is_bitwise_one_result(cuda, n, dtype):
    """Every block size the launcher takes gives the same bits, within the
    gate of the plain version; a repeat launch is bitwise."""
    u, par = sk.pack_state(*batched_sixdof_init(n, seed=6), device=cuda, dtype=dtype)
    ref = sk._rollout_reference(u, par, DT, 10)
    first = sk._rollout_cuda(u, par, DT, 10)
    assert torch.isfinite(first).all()
    assert _k1_groups_rel(first, ref) <= K1_TOL[dtype]
    for threads in K1_PLANS:
        assert torch.equal(sk._rollout_cuda(u, par, DT, 10, threads), first), threads
    assert torch.equal(sk._rollout_cuda(u, par, DT, 10), first)


@pytest.mark.gpu
def test_kernel_refuses_a_plan_outside_its_limits(cuda):
    u, par = sk.pack_state(*batched_sixdof_init(64, seed=7), device=cuda, dtype=torch.float32)
    before = sk.LAUNCHES
    for threads in (0, 16, 48, 100, 288, 512, 1024, -32):
        with pytest.raises(RuntimeError, match="cudaError"):
            sk._rollout_cuda(u, par, DT, 2, threads)
    assert sk.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_body_at_rest_gets_exactly_zero_drag(cuda, dtype, monkeypatch):
    """v = 0 gives |v| = 0 * rsqrt(min normal), an exact zero drag and no
    NaN.  With gravity, thrust and torque off, a body at rest stays exactly
    where it is, in the kernel as in the plain version; with them on, it is
    finite and within the gate."""
    pos, vel, inertia = batched_sixdof_init(64, seed=8)
    vel = np.zeros_like(vel)
    u, par = sk.pack_state(pos, vel, inertia, device=cuda, dtype=dtype)
    ours = sk._rollout_cuda(u, par, DT, 20)
    assert torch.isfinite(ours).all()
    assert _k1_groups_rel(ours, sk._rollout_reference(u, par, DT, 20)) <= K1_TOL[dtype]
    for name in ("MU", "THRUST", "TORQUE"):
        monkeypatch.setattr(sk.model, name, 0.0)
    for out in (sk._rollout_cuda(u, par, DT, 20), sk._rollout_reference(u, par, DT, 20)):
        assert torch.isfinite(out).all()
        assert torch.equal(out[4:], u[4:])  # position, angular and linear velocity


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("radius", [4e8, 1e10, 1e12])
def test_kernel_body_far_out_matches_the_plain_version(cuda, dtype, radius):
    """Far from the planet (|r| up to 1e12 m, g ~ 1e-10 m/s^2) the fast
    reciprocal square root keeps the gravity within the gate."""
    pos, vel, inertia = batched_sixdof_init(256, seed=9)
    pos[:, 4:] *= radius / np.linalg.norm(pos[:, 4:], axis=1, keepdims=True)
    u, par = sk.pack_state(pos, vel, inertia, device=cuda, dtype=dtype)
    ours = sk._rollout_cuda(u, par, DT, 50)
    assert torch.isfinite(ours).all()
    assert _k1_groups_rel(ours, sk._rollout_reference(u, par, DT, 50)) <= K1_TOL[dtype]


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


# ---------------------------------------------------------------------------
# the sim's entry points: lockstep sessions, the telemetry pump, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("hold", [1, 4])
def test_lockstep_session_on_the_card_matches_the_cpu(cuda, hold):
    from elodin_tpu_torch.examples.betaflight_sitl import main as sitl

    sessions = {dev: sitl.build(dev).lockstep_session(sitl.SEND, sitl.RECV, hold_ticks=hold)
                for dev in ("cuda", "cpu")}
    for cmd in np.random.default_rng(3).uniform(0.0, 20.0, 50):
        outs = {}
        for dev, session in sessions.items():
            session.cmd_bufs["thrust_cmd"][0] = cmd
            outs[dev] = session.tick()
        np.testing.assert_allclose(outs["cuda"], outs["cpu"], rtol=0, atol=1e-12)
    assert sessions["cuda"].exec.cols["z_pos"].device.type == "cuda"


@pytest.mark.gpu
def test_telemetry_pump_on_the_card_matches_the_synchronous_path(cuda, tmp_path):
    from elodin_tpu_torch.examples.cube_sat import main as cube

    hist = {}
    for sync in (False, True):
        exec_ = cube.build_world().build(cube.build_system(), simulation_rate=120.0,
                                         device="cuda")
        exec_._sync_history = sync
        exec_._history.max_bytes = 16 << 10
        exec_._history._spool_dir = str(tmp_path / f"spool{sync}")
        exec_.run(40)
        exec_.flush_telemetry()
        h = exec_._history
        hist[sync] = (list(h.times), {k: h.series(k) for k in exec_.meta.components})
    assert hist[False][0] == hist[True][0]
    for k, ref in hist[True][1].items():
        np.testing.assert_array_equal(hist[False][1][k], ref, err_msg=k)


@pytest.mark.gpu
def test_cli_bench_on_the_card_in_a_subprocess(cuda):
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "elodin_tpu_torch.examples.stablehlo.sim", "bench", "--ticks",
         "50", "--device", "cuda"], cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "real_time_factor:" in proc.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [None, 6])
def test_orbit_gradient_on_the_card_matches_the_cpu(cuda, remat):
    """A value and gradient through 60 ticks of orbit-retarget, the card
    against the CPU, to 1e-9 relative; remat gives the plain values."""
    from elodin_tpu_torch.examples.orbit_retarget import main as orbit

    out = {}
    for dev in ("cpu", "cuda"):
        loss = orbit.make_loss(60, remat, dev)
        v0 = torch.tensor([0.1, 1.0, 0.05], dtype=torch.float64, device=dev, requires_grad=True)
        val = loss(v0)
        (g,) = torch.autograd.grad(val, v0)
        assert g.device.type == dev
        out[dev] = (val.item(), g.cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-9)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-9)


@pytest.mark.gpu
def test_kernels_refuse_an_input_that_requires_grad_on_the_card(cuda):
    cols = batched_sixdof_init(64, seed=1)
    vel = torch.tensor(cols[1], device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        sk.sixdof_rollout(cols[0], vel, cols[2], DT, 5, device=cuda, dtype=torch.float64)
    before = sk.LAUNCHES
    with torch.no_grad():
        sk.sixdof_rollout(cols[0], vel, cols[2], DT, 5, device=cuda, dtype=torch.float64)
    assert sk.LAUNCHES == before + 1
    pos = torch.randn(300, 3, dtype=torch.float64, device=cuda, requires_grad=True)
    mass = torch.ones(300, dtype=torch.float64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward pass"):
        pw.pairwise_gravity(pos, mass)
    (g,) = torch.autograd.grad(pw.pairwise_gravity(pos, mass, use_kernel=False).sum(), pos)
    assert torch.isfinite(g).all()


# ---------------------------------------------------------------------------
# the split over cards (parallel/mesh.py): the sharded kernels and the
# sharded falcon9 campaign on a mesh of repeated entries of one card, and
# on every visible card.  Stated tolerances: K1 sharded bitwise; K2 sharded
# against one call and against the plain version ≤ 1e-4 (f32) and ≤ 1e-12
# (f64) in max |Δ| / max |ref|; a K2 row block that starts at a multiple of
# 32 R rows bitwise the whole call's rows under the same plan; the campaign
# sharded against unsharded bitwise.
# ---------------------------------------------------------------------------


def _card_mesh(devices):
    from elodin_tpu_torch.parallel import make_mesh

    return make_mesh(devices=devices)


def _every_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more CUDA cards")
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sixdof_rollout_sharded_on_one_card(cuda, dtype):
    cols = batched_sixdof_init(4099, seed=4)
    single = sk.sixdof_rollout(*cols, DT, 50, device=cuda, dtype=dtype)
    before = sk.LAUNCHES
    shard = sk.sixdof_rollout_sharded(*cols, DT, 50, _card_mesh(["cuda:0"] * 4), dtype=dtype)
    assert sk.LAUNCHES == before + 4
    for a, b in zip(shard, single):
        assert a.device == b.device and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-12)])
def test_pairwise_gravity_sharded_on_one_card(cuda, dtype, tol):
    pos, mass = _nbody_inputs(4099, cuda, dtype)
    one = pw.pairwise_gravity(pos, mass, g=G)
    ref = pw.pairwise_gravity_reference(pos, mass, g=G)
    before = pw.LAUNCHES
    shard = pw.pairwise_gravity_sharded(pos, mass, _card_mesh(["cuda:0"] * 4), g=G)
    assert pw.LAUNCHES == before + 4
    assert shard.shape == one.shape and shard.device == one.device
    assert rel_err(shard, one) <= tol and rel_err(shard, ref) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pairwise_row_block_is_the_whole_call_under_one_plan(cuda, dtype):
    pos, mass = _nbody_inputs(4099, cuda, dtype)
    plan = pw._launch_plan(4099, _build.sm_count(pos.device.index))
    whole = pw._pairwise_gravity_cuda(pos, mass, G, 0.0, plan)
    step = 32 * plan.r
    for row0, rows in ((0, 4099), (0, 1), (step, 1000), (32 * step, 4099 - 32 * step),
                       (4096, 3)):
        block = pw._pairwise_gravity_cuda(pos, mass, G, 0.0, plan, row0, rows)
        assert torch.equal(block, whole[row0:row0 + rows]), (row0, rows)
    assert torch.equal(pw.pairwise_gravity(pos, mass, g=G), whole)
    before = pw.LAUNCHES
    for row0, rows in ((-1, 2), (4000, 100)):
        with pytest.raises(ValueError, match="row block"):
            pw._pairwise_gravity_cuda(pos, mass, G, 0.0, plan, row0, rows)
    assert pw._pairwise_gravity_cuda(pos, mass, G, 0.0, plan, 7, 0).shape == (0, 3)
    assert pw.LAUNCHES == before


@pytest.mark.gpu
def test_falcon9_campaign_sharded_on_one_card(cuda):
    """16 missions x 40 ticks over 4 shards of one card against the
    unsharded campaign."""
    plain, _ = f9.make_campaign(16, seed=1, device=cuda)
    ref = plain.run(40, until=f9.until_down)
    shard, _ = f9.make_campaign(16, seed=1, mesh=_card_mesh(["cuda:0"] * 4))
    out = shard.run(40, until=f9.until_down)
    assert out.ticks == ref.ticks == 40 and shard.gated_runs == plain.gated_runs
    for k in ref.final:
        np.testing.assert_array_equal(out.column(k), ref.column(k), err_msg=k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-12)])
def test_sharded_kernels_over_every_card(cuda, dtype, tol):
    devices = _every_card()
    mesh = _card_mesh(devices)
    cols = batched_sixdof_init(4099, seed=5)
    single = sk.sixdof_rollout(*cols, DT, 50, device=cuda, dtype=dtype)
    shard = sk.sixdof_rollout_sharded(*cols, DT, 50, mesh, dtype=dtype)
    for a, b in zip(shard, single):
        assert torch.equal(a.to(b.device), b)
    pos, mass = _nbody_inputs(4099, cuda, dtype)
    ref = pw.pairwise_gravity_reference(pos, mass, g=G)
    got = pw.pairwise_gravity_sharded(pos, mass, mesh, g=G)
    assert rel_err(got.to(ref.device), ref) <= tol


@pytest.mark.gpu
def test_dryrun_multichip_on_the_cards(cuda):
    from elodin_tpu_torch.parallel.dryrun import dryrun_multichip

    assert dryrun_multichip(4, devices=["cuda:0"] * 4)["falcon9_ticks"] == 4
    if torch.cuda.device_count() >= 2:
        dryrun_multichip(torch.cuda.device_count())


@pytest.mark.gpu
def test_gather_onto_the_host_waits_for_the_cards(cuda):
    """Shards written behind a long kernel, read on the host at once
    (``np.asarray`` of a placed column): each copy lands before the host
    reads it, where a non-blocking copy to the host would hand back memory
    still being written.  A first read fills torch's cache of page-locked
    host buffers, as a long run has: a fresh buffer's allocation waits for
    the card and would hide the fault."""
    from elodin_tpu_torch.parallel import NamedSharding, put_global

    placed = put_global(NamedSharding(_card_mesh(["cuda:0"] * 4), ("dp",)),
                        torch.zeros(4 << 20, dtype=torch.float64))
    for _ in range(2):
        np.asarray(placed)
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)  # a kernel that spins ~0.6 s, queued ahead of the writes
    for k, s in enumerate(placed.shards):
        s.fill_(k + 1.0)
    np.testing.assert_array_equal(np.asarray(placed), np.repeat(np.arange(1.0, 5.0), 1 << 20))


# -- the mesh across processes on one card: gloo, staged through the host ---------------


def _launch_on_card(target, tmp_path, monkeypatch, n=2):
    """``target`` of ``tests/torch_ranks.py`` in ``n`` new ranks that share
    ``cuda:0`` over gloo (NCCL refuses two ranks on one card)."""
    import os

    from elodin_tpu_torch.parallel import distributed

    tests = os.path.dirname(os.path.abspath(__file__))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (tests, os.environ.get("PYTHONPATH")) if p))
    return distributed.launch(target, [["cuda:0"]] * n, backend="gloo",
                              kwargs={"out_dir": str(tmp_path)}, timeout=600)


@pytest.mark.gpu
def test_ep_staged_through_the_host_on_one_card(cuda, tmp_path, monkeypatch):
    """Two ranks on ``cuda:0``: the ``ep = 2`` six-dof step bitwise equal to
    one process on the card, n-body through ``Exec`` on K2's row blocks (one
    launch a tick in each rank) within 1e-12 of one process's K2 calls."""
    import torch_ranks as ranks
    from elodin_tpu_torch.interop import columns_from_numpy
    from elodin_tpu_torch.models import build_batched_sixdof, build_nbody_system
    from elodin_tpu_torch.system import build_step

    meta = _launch_on_card("torch_ranks:ep_world", tmp_path, monkeypatch)
    data = [dict(np.load(tmp_path / f"ep_rank{r}.npz")) for r in range(2)]
    assert {m["transport"] for m in meta} == {"gloo, staged through the host"}
    assert [m["launches"] for m in meta] == [{"kernel": ranks.NBODY_TICKS, "dense": 0}] * 2
    world, system = build_batched_sixdof(64)
    wmeta, cols = world.snapshot()
    ref = build_step(wmeta, system)(columns_from_numpy(cols, wmeta, cuda))
    for rank, d in enumerate(data):
        got = d[f"sixdof/world_pos/0"]
        np.testing.assert_array_equal(got, ref["world_pos"][32 * rank:32 * rank + 32].cpu())
    exec_ = build_nbody(ranks.NBODY_BODIES, seed=2).build(
        build_nbody_system(60.0), simulation_rate=1 / 60.0, device=cuda)
    exec_.run(ranks.NBODY_TICKS)
    for k in ("world_pos", "world_vel", "force"):
        assert rel_err(data[0][f"kernel/{k}"], exec_.column_array(k)) <= 1e-12, k


@pytest.mark.gpu
def test_campaigns_a_process_on_one_card(cuda, tmp_path, monkeypatch):
    """The ``until=`` and ``every`` joins and falcon9 (16 x 40) over two ranks
    on ``cuda:0``, bitwise equal to one process on the card."""
    import torch_ranks as ranks

    meta = _launch_on_card("torch_ranks:campaigns", tmp_path, monkeypatch)
    one, one_meta = ranks.campaign_runs(device=cuda)
    campaign, _ = f9.make_campaign(ranks.F9_SAMPLES, seed=ranks.F9_SEED, device=cuda)
    ref = campaign.run(ranks.F9_TICKS, until=f9.until_down)
    for r, m in enumerate(meta):
        joins = dict(np.load(tmp_path / f"joins_rank{r}.npz"))
        final = dict(np.load(tmp_path / f"rank{r}.npz"))
        a, b = m["samples"]
        assert m["until_ticks"] == one_meta["until_ticks"] == 9
        assert m["gated_runs"] == one_meta["gated_runs"] == 8
        np.testing.assert_array_equal(joins["until/count"], one["until/count"][a:b])
        np.testing.assert_array_equal(joins["every/escalated"], one["every/escalated"][a:b])
        assert m["falcon9"]["ticks"] == ref.ticks and m["falcon9"]["gated_runs"] == 8
        for k in ref.final:
            np.testing.assert_array_equal(final[k], ref.column(k)[a:b], err_msg=k)


@pytest.mark.gpu
def test_multihost_dryrun_on_one_card(cuda):
    from elodin_tpu_torch.parallel import dryrun_multihost

    ranks = dryrun_multihost.launch(2, 1, ep=2, device="cuda:0", backend="gloo")
    assert [r["mesh"] for r in ranks] == [{"dp": 1, "ep": 2}] * 2
    assert all(r["devices"] == ["cuda:0"] for r in ranks)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4), (np.float64, 1e-12)])
def test_nbody_batched_runner_on_k2(cuda, dtype, tol):
    """``examples/n_body/batched.run`` at 1024 bodies x 5 ticks: one K2
    launch a timed tick, and the final columns within the K2 gates of the
    same runner on the dense edge fold."""
    from elodin_tpu_torch.examples.n_body import batched

    ours, ref = {}, {}
    out = batched.run(1024, 5, dtype=dtype, device="cuda", stats=ours)
    batched.run(1024, 5, use_kernel=False, dtype=dtype, device="cuda", stats=ref)
    assert ours["launches"] == 5 and ref["launches"] == 0
    assert np.isfinite(out["momentum_drift_rel"])
    for name in ("world_pos", "world_vel"):
        assert rel_err(ours["final"][name], ref["final"][name]) <= tol, name


@pytest.mark.gpu
def test_core_example_on_the_card_matches_its_cpu(cuda):
    """The sensor-camera room, 240 ticks in f64, card against CPU at 1e-9;
    its schematic and cameras carried onto the card's ``Exec``."""
    from elodin_tpu_torch import _config
    from elodin_tpu_torch.examples.sensor_camera import main as sim
    from elodin_tpu_torch.interop import columns_to_numpy

    _config.set_float_policy("f64")
    runs = {}
    for device in ("cuda", "cpu"):
        w = sim.world()
        exec_ = w.build(sim.system(), simulation_rate=1.0 / sim.SIM_TIME_STEP, device=device)
        exec_.run(240)
        assert exec_.schematic_content == w.schematic_content
        assert sorted(k for k in w.assets if "cam" in k) == ["ball_0.scene_cam",
                                                             "ball_1.thermal_cam"]
        runs[device] = columns_to_numpy(exec_.cols, exec_.meta)
    for name, ref in runs["cpu"].items():
        if ref.dtype.kind == "f":
            assert rel_err(runs["cuda"][name], ref) <= 1e-9, name
        else:
            np.testing.assert_array_equal(runs["cuda"][name], ref, err_msg=name)


def _flight_example(name):
    """(world, system, rate) of one of the last four core-API examples."""
    from elodin_tpu_torch.examples.crazyflie_edu import sim as cf
    from elodin_tpu_torch.examples.frames import main as fr
    from elodin_tpu_torch.examples.rc_jet import sim as rj
    from elodin_tpu_torch.examples.rocket_barrowman import main as rb

    return {"frames-two-body": lambda: (*fr.build_two_body(), fr.SIM_RATE),
            "rocket-barrowman": lambda: (rb.world(), rb.system(), 1.0 / rb.SIM_TIME_STEP),
            "crazyflie-edu": lambda: (cf.world(), cf.system(), cf.SIM_RATE_HZ),
            "rc-jet": lambda: (rj.world(), rj.system(), rj.SIM_RATE_HZ)}[name]()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["frames-two-body", "rocket-barrowman", "crazyflie-edu",
                                  "rc-jet"])
def test_flight_example_on_the_card_matches_its_cpu(cuda, name):
    """120 ticks in f64 through ``World.build`` → ``Exec.run``, card
    against CPU at 1e-9 per channel group."""
    from elodin_tpu_torch import _config
    from elodin_tpu_torch.interop import columns_to_numpy

    prev = _config._FLOAT_POLICY
    _config.set_float_policy("f64")
    try:
        runs = {}
        for device in ("cuda", "cpu"):
            world, system, rate = _flight_example(name)
            exec_ = world.build(system, simulation_rate=rate, device=device)
            exec_.run(120)
            runs[device] = columns_to_numpy(exec_.cols, exec_.meta)
    finally:
        _config.set_float_policy(prev)
    for col, ref in runs["cpu"].items():
        if ref.dtype.kind == "f":
            assert np.isfinite(runs["cuda"][col]).all(), col
            assert rel_err(runs["cuda"][col], ref) <= 1e-9, col
        else:
            np.testing.assert_array_equal(runs["cuda"][col], ref, err_msg=col)


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["ENU", "NED"])
def test_frames_drop_on_the_card(cuda, frame):
    from elodin_tpu_torch import _config
    from elodin_tpu_torch.examples.frames import main as fr

    prev = _config._FLOAT_POLICY
    _config.set_float_policy("f64")
    try:
        z = {d: fr.run_drop(frame, device=d) for d in ("cuda", "cpu")}
    finally:
        _config.set_float_policy(prev)
    assert rel_err(z["cuda"], z["cpu"]) <= 1e-12


@pytest.mark.gpu
def test_wmm_on_the_card_matches_its_cpu(cuda):
    """``field_ned`` on a 32 x 32 grid (1024 points, both poles) at sea
    level, card against CPU within 1e-12 of max |B|; the result stays on
    the card, whose tables are copied there once."""
    from elodin_tpu_torch import wmm

    lat = torch.linspace(-np.pi / 2, np.pi / 2, 32, dtype=torch.float64)
    lon = torch.linspace(-np.pi, np.pi, 33, dtype=torch.float64)[:-1]
    grid_lat, grid_lon = (g.reshape(-1) for g in torch.meshgrid(lat, lon, indexing="ij"))
    ours = wmm.field_ned(grid_lat.to(cuda), grid_lon.to(cuda), 0.0, 2022.5)
    assert ours.device.type == "cuda" and ours.shape == (1024, 3)
    assert wmm._tables(ours.device) is wmm._tables(ours.device)
    ref = wmm.field_ned(grid_lat, grid_lon, 0.0, 2022.5)
    assert rel_err(ours, ref) <= 1e-12
    for o, r in zip(wmm.declination_inclination(grid_lat.to(cuda), grid_lon.to(cuda), 0.0),
                    wmm.declination_inclination(grid_lat, grid_lon, 0.0)):
        assert rel_err(o, r) <= 1e-12


@pytest.mark.gpu
def test_served_nbody_on_k2(cuda, tmp_path):
    """``chip_smoke.py`` phase 39 (a) at 64 bodies: n-body on K2, f64,
    built with ``db_path`` and served; ``Exec.run(20)`` launches K2 20
    times and K1 never, and a client reads every body's ``world_pos`` and
    ``world_vel``, 21 rows each, bitwise the ``Exec``'s history, again
    after a reopen."""
    import elodin_tpu_torch.db as edb
    from elodin_tpu_torch import _config
    from elodin_tpu_torch.db.server import serve_exec
    from elodin_tpu_torch.models.nbody import build_system

    prev = _config._FLOAT_POLICY
    _config.set_float_policy("f64")
    try:
        exec_ = build_nbody(64, seed=2).build(build_system(60.0, use_kernel=True), device="cuda",
                                              simulation_rate=1.0 / 60.0,
                                              db_path=str(tmp_path / "db"))
        server = serve_exec(exec_, "127.0.0.1:0")
        try:
            before = pw.LAUNCHES, sk.LAUNCHES
            exec_.run(20)
            assert (pw.LAUNCHES - before[0], sk.LAUNCHES - before[1]) == (20, 0)
            exec_.flush_telemetry()
            client = edb.Client.connect(f"127.0.0.1:{server.port}")
            read = {}
            for q in exec_._history.column_names():
                comp, row = exec_._history.resolve(q)
                if comp not in ("world_pos", "world_vel"):
                    continue
                ts, vals = client.time_series(q)
                want = exec_._history.series(comp)[:, row]
                assert len(ts) == 21
                np.testing.assert_array_equal(np.asarray(vals).reshape(want.shape), want)
                read[q] = want
            client.close()
            assert len(read) == 128
        finally:
            server.stop()
    finally:
        _config.set_float_policy(prev)
    db = edb.Database(str(tmp_path / "db"))
    for q, want in read.items():
        store = db.by_name(q)
        np.testing.assert_array_equal(store.values[:store.len].reshape(want.shape), want)


@pytest.mark.gpu
def test_served_nbody_on_k2_mirrored_and_exported(cuda, tmp_path):
    """``chip_smoke.py`` phase 40 (a) and (c) at 64 bodies: a port
    ``MirrorWorld`` subscribes to every body's ``world_pos`` and
    ``world_vel`` of a served n-body on K2 (f64) between two runs; after a
    flush its ``value_at`` at every stored timestamp is bitwise the
    ``Exec``'s history (the first run's rows by backfill, the second's by
    the live sink).  The database's MCAP (``db export --format mcap``)
    holds one message a stored row of each body's components, equal to
    the store."""
    import json
    import time

    import elodin_tpu_torch.db as edb
    from elodin_tpu_torch import _config
    from elodin_tpu_torch.__main__ import main as cli
    from elodin_tpu_torch.db.export_mcap import read_mcap_full
    from elodin_tpu_torch.db.mirror import MirrorWorld
    from elodin_tpu_torch.db.server import serve_exec
    from elodin_tpu_torch.models.nbody import build_system

    prev = _config._FLOAT_POLICY
    _config.set_float_policy("f64")
    try:
        exec_ = build_nbody(64, seed=2).build(build_system(60.0, use_kernel=True), device="cuda",
                                              simulation_rate=1.0 / 60.0,
                                              db_path=str(tmp_path / "db"))
        server = serve_exec(exec_, "127.0.0.1:0")
        try:
            exec_.run(5)
            exec_.flush_telemetry()
            names = [q for q in exec_._history.column_names()
                     if q.endswith((".world_pos", ".world_vel"))]
            assert len(names) == 128
            with MirrorWorld.connect(f"127.0.0.1:{server.port}", names) as m:
                before = pw.LAUNCHES, sk.LAUNCHES
                exec_.run(20)
                assert (pw.LAUNCHES - before[0], sk.LAUNCHES - before[1]) == (20, 0)
                exec_.flush_telemetry()
                start = exec_._history.start_timestamp.timestamp()
                times = np.asarray(exec_._history.times)
                want_ts = np.concatenate([[int(start * 1e6)],
                                          ((start + times[1:]) * 1e6).astype(np.int64)])
                assert len(want_ts) == 26
                deadline = time.monotonic() + 30
                while any(m.cache.peek(q) is None or m.cache.peek(q).latest()[0] < want_ts[-1]
                          for q in names):
                    assert time.monotonic() < deadline, "the live sink never got the last rows"
                    time.sleep(0.01)
                for q in names:
                    comp, row = exec_._history.resolve(q)
                    hist = exec_._history.series(comp)[:, row]
                    fetched = m.backfill(q, int(want_ts[0]), int(want_ts[-1]))
                    assert fetched >= 6, (q, fetched, m._client.time_series(
                        q, int(want_ts[0]), int(want_ts[-1]) + 1)[0][:8], want_ts[:8])
                    for k, t in enumerate(want_ts):
                        v = m.value_at(q, int(t))
                        assert v is not None and np.array_equal(np.ravel(v), hist[k]), (
                            q, k, m.cache.peek(q)._covered, m.cache.peek(q)._ts[:8], want_ts[:8])
        finally:
            server.stop()
            exec_.on_commit_batch = None
    finally:
        _config.set_float_policy(prev)
    cli(["db", "export", str(tmp_path / "db"), "--output", str(tmp_path / "out"),
         "--format", "mcap", "--pattern", "b*"])
    f = read_mcap_full(str(tmp_path / "out" / "db.mcap"))
    by_topic = {c["topic"]: cid for cid, c in f.channels.items()}
    msgs = {}
    for cid, _t, data in f.messages:
        msgs.setdefault(cid, []).append(json.loads(data))
    db = edb.Database(str(tmp_path / "db"))
    for q in names:
        store = db.by_name(q)
        got = msgs[by_topic["/" + q.replace(".", "/")]]
        assert len(got) == store.len == 26
        for k, row in enumerate(got):
            assert np.array_equal(np.asarray(list(row.values()), dtype=np.float64),
                                  store.values[k].ravel()), (q, k)


def _fsw_loop(device):
    """The flight-software loop of ``chip_smoke.py``'s phase 41:
    ``mekf_system`` piped into ``lqr_system`` on ``device``."""
    from elodin_tpu_torch import fsw

    return fsw.mekf_system(
        sigma_g=[0.01] * 3, sigma_b=[0.001] * 3, dt=1.0 / 200.0,
        refs_fields=["mag_ref", "sun_ref"], body_fields=["mag_body", "sun_body"],
        sigmas=[0.03, 0.03], device=device,
    ).pipe(fsw.lqr_system(j=[0.1, 0.2, 0.3], q_ang_vel=[1.0] * 3, q_pos=[2.0] * 3,
                          r=[0.5] * 3, device=device))


@pytest.mark.gpu
def test_fsw_mekf_lqr_on_the_card_matches_its_cpu(cuda):
    """The MEKF -> LQR systems on the card and on the CPU take the same 200
    worlds (a body turning about +z, noise from one numpy seed): their
    ``att_est`` and ``control_torque`` agree each tick to 1e-12 and come
    back as host numpy."""
    from types import SimpleNamespace

    rng = np.random.default_rng(11)
    systems = {"cuda": _fsw_loop("cuda"), "cpu": _fsw_loop("cpu")}
    worlds = {d: SimpleNamespace(att_est=np.array([0.0, 0, 0, 1.0])) for d in systems}
    worst = 0.0
    for k in range(200):
        theta = 0.6 + 0.05 * k / 200.0
        inputs = {"gyro_omega": np.array([0.0, 0.0, 0.05]) + rng.normal(0.0, 0.001, 3),
                  "mag_body": np.array([np.cos(theta), -np.sin(theta), 0.0])
                  + rng.normal(0.0, 0.003, 3),
                  "sun_body": np.array([0.0, 0.0, 1.0]) + rng.normal(0.0, 0.003, 3),
                  "mag_ref": np.array([1.0, 0.0, 0.0]), "sun_ref": np.array([0.0, 0.0, 1.0]),
                  "att_goal": np.array([0.0, 0.0, 0.0, 1.0])}
        for dev, system in systems.items():
            for name, v in inputs.items():
                setattr(worlds[dev], name, v.copy())
            system.update(worlds[dev])
        for name in ("att_est", "control_torque"):
            a, b = getattr(worlds["cuda"], name), getattr(worlds["cpu"], name)
            assert isinstance(a, np.ndarray) and a.dtype == np.float64
            worst = max(worst, float(np.abs(a - b).max()))
    assert worst <= 1e-12, worst
    q_true = np.array([0.0, 0.0, np.sin(theta / 2), np.cos(theta / 2)])
    assert abs(float(np.dot(worlds["cuda"].att_est, q_true))) > 0.999


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["dense", "sequential"])
def test_a_fold_tick_does_not_synchronise(cuda, path):
    """After one warm-up tick, a tick of the n-body fold world's step (the
    dense fold of ``models/nbody.py`` at 2048 bodies, two chunks; the
    sequential fold of ``examples/n_body`` at 16) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: the fold's set-up is kept
    on the card and nothing in the tick copies through pageable memory.
    Both ticks match the CPU's (f64 ≤ 1e-12) and reuse the first's set-up."""
    from elodin_tpu_torch import _config, interop
    from elodin_tpu_torch.examples.n_body import main as n_body
    from elodin_tpu_torch.models import nbody
    from elodin_tpu_torch.system import FOLD_SETUPS, build_step

    prev = _config._FLOAT_POLICY
    _config.set_float_policy("f64")
    try:
        if path == "dense":
            world, system = build_nbody(2048, seed=4), nbody.build_system(60.0, use_kernel=False)
            nbody._gravity.fold_setups.clear()
        else:
            world, system = n_body.build_world(14, 3), n_body.build_system()
            n_body.gravity.fold_setups.clear()
        world.set_sim_time_step(60.0)
        meta, cols = world.snapshot()
        out = {}
        for dev in ("cuda", "cpu"):
            step = build_step(meta, system)
            state = interop.columns_from_numpy(cols, meta, dev)
            before = dict(FOLD_SETUPS)
            state = step(state)
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    state = step(state)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            else:
                state = step(state)
            assert {k: FOLD_SETUPS[k] - v for k, v in before.items()} == {"built": 1,
                                                                         "reused": 1}
            out[dev] = interop.columns_to_numpy(state, meta)
    finally:
        _config.set_float_policy(prev)
    for name in ("world_pos", "world_vel", "world_accel", "force"):
        assert rel_err(out["cuda"][name], out["cpu"][name]) <= 1e-12, name
