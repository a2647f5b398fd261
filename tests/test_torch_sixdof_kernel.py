"""The port's whole-rollout 6-dof RK4 (elodin_tpu_torch.ops.sixdof_kernel)
against the JAX package.

On the CPU the wrapper runs its plain PyTorch version, so these tests hold
that version to the JAX package's Pallas kernel (in interpret mode, as
tests/test_sixdof_kernel.py runs it) and to the JAX f64 ECS trajectory.
The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_gpu.py and by ``chip_smoke.py``.

Stated tolerances, max |Δ| / max |ref| for each channel group
(quaternion, position, angular and linear velocity) against its own scale:
* f32 plain version vs the f32 Pallas kernel, 192 bodies x 100 ticks:
  ≤ 1e-4 (two f32 programs of the same math, different rounding order);
* f64 plain version vs the f64 ECS path: ≤ 1e-10 (the same algebra in
  IEEE f64, regrouped per channel).
"""

import numpy as np
import pytest
import torch

from elodin_tpu.models.sixdof_batch import build_batched_sixdof as j_build
from elodin_tpu.ops import sixdof_kernel as jsk
from elodin_tpu_torch.models.sixdof_batch import MU, batched_sixdof_init
from elodin_tpu_torch.ops import sixdof_kernel as sk
from torch_port_util import float_policy, rel_err

N, TICKS, DT = 192, 100, 1.0 / 120.0
CPU = dict(device="cpu")


def test_reference_f32_matches_pallas_kernel():
    wp, wv, inertia = (a.astype(np.float32) for a in batched_sixdof_init(N))
    jpos, jvel = jsk.sixdof_rollout(wp, wv, inertia, dt=DT, ticks=TICKS,
                                    block_rows=8, interpret=True)
    pos, vel = sk.sixdof_rollout_reference(wp, wv, inertia, DT, TICKS,
                                           dtype=torch.float32, **CPU)
    assert pos.dtype == torch.float32 and pos.shape == (N, 7)
    assert rel_err(pos, jpos) <= 1e-4 and rel_err(vel, jvel) <= 1e-4


def test_reference_f64_matches_jax_ecs():
    with float_policy("f64"):
        w, system = j_build(N)
        # one telemetry batch of TICKS ticks: a single compiled loop
        ex = w.build(system, telemetry_rate=120.0 / TICKS)
        init = {k: ex.column_array(k) for k in ("world_pos", "world_vel", "inertia")}
        ex.run(TICKS)
        jpos, jvel = ex.column_array("world_pos"), ex.column_array("world_vel")
    pos, vel = sk.sixdof_rollout_reference(
        init["world_pos"], init["world_vel"], init["inertia"], DT, TICKS,
        dtype=torch.float64, **CPU)
    assert rel_err(pos, jpos) <= 1e-10 and rel_err(vel, jvel) <= 1e-10


def test_pack_unpack_roundtrip():
    """Channel-major packing and back is exact, with no padding."""
    rng = np.random.default_rng(3)
    n = 77
    pos = rng.normal(size=(n, 7)).astype(np.float32)
    vel = rng.normal(size=(n, 6)).astype(np.float32)
    inertia = rng.uniform(1.0, 2.0, (n, 7)).astype(np.float32)
    u, par = sk.pack_state(pos, vel, inertia, dtype=torch.float32, **CPU)
    assert u.shape == (sk.N_STATE, n) and par.shape == (sk.N_PARAM, n)
    assert u.is_contiguous() and par.is_contiguous()
    p2, v2 = sk.unpack_state(u)
    np.testing.assert_array_equal(p2.numpy(), pos)
    np.testing.assert_array_equal(v2.numpy(), vel)
    # params: inverse inertia diagonal + inverse mass
    np.testing.assert_allclose(par[0:3].T.numpy(), 1.0 / inertia[:, 0:3], rtol=1e-6)
    np.testing.assert_allclose(par[3].numpy(), 1.0 / inertia[:, 6], rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_zero_ticks_is_identity(dtype):
    """ticks is a runtime argument; 0 ticks returns the input unchanged."""
    rng = np.random.default_rng(5)
    n = 64
    pos = rng.normal(size=(n, 7))
    pos[:, 4:] += np.array([7e6, 0, 0])
    vel = rng.normal(size=(n, 6))
    inertia = np.ones((n, 7))
    ppos, pvel = sk.sixdof_rollout(pos, vel, inertia, DT, 0, dtype=dtype, **CPU)
    np.testing.assert_array_equal(ppos.numpy(), pos.astype(ppos.numpy().dtype))
    np.testing.assert_array_equal(pvel.numpy(), vel.astype(pvel.numpy().dtype))


def test_ragged_body_count_stays_finite():
    """A body count that fills no whole thread block (the kernel masks the
    ragged edge; nothing is padded) stays finite over a long rollout."""
    n = 10
    pos = np.zeros((n, 7))
    pos[:, 3] = 1.0
    pos[:, 4] = 6.771e6
    vel = np.zeros((n, 6))
    vel[:, 4] = np.sqrt(MU / 6.771e6)
    inertia = np.ones((n, 7))
    ppos, pvel = sk.sixdof_rollout(pos, vel, inertia, DT, 50,
                                   dtype=torch.float32, **CPU)
    assert ppos.shape == (n, 7) and pvel.shape == (n, 6)
    assert torch.isfinite(ppos).all() and torch.isfinite(pvel).all()


def test_cpu_tensors_do_not_launch_the_kernel():
    """On CPU tensors the wrapper runs the plain version: LAUNCHES stays 0
    and the result is the plain version's, bit for bit."""
    wp, wv, inertia = batched_sixdof_init(32)
    before = sk.LAUNCHES
    pos, vel = sk.sixdof_rollout(wp, wv, inertia, DT, 5, dtype=torch.float64, **CPU)
    assert sk.LAUNCHES == before == 0
    rpos, rvel = sk.sixdof_rollout_reference(wp, wv, inertia, DT, 5,
                                             dtype=torch.float64, **CPU)
    assert torch.equal(pos, rpos) and torch.equal(vel, rvel)


def test_effector_constants_match_jax_package():
    """The port gives the effector constants one home; they are the values
    the JAX kernel and model hard-code."""
    from elodin_tpu.models import sixdof_batch as jmodel
    from elodin_tpu_torch.models import sixdof_batch as tmodel

    assert tmodel.MU == jmodel.MU == jsk.MU
    assert tmodel.R0 == jmodel.R0
    assert (tmodel.THRUST, tmodel.TORQUE, tmodel.DRAG) == (25.0, 1e-3, 0.02)


def test_batched_init_matches_jax_package():
    from elodin_tpu.models.sixdof_batch import batched_sixdof_init as jinit

    for ours, ref in zip(batched_sixdof_init(100, seed=7), jinit(100, seed=7)):
        np.testing.assert_array_equal(ours, ref)


def test_kernel_refuses_an_input_that_requires_grad():
    """The kernel has no backward pass: while autograd records, its wrapper
    refuses an input that requires grad (before it looks at the device or
    loads the library); the plain version stays differentiable."""
    cols = batched_sixdof_init(4)
    u, par = sk.pack_state(*cols, device="cpu", dtype=torch.float64)
    with pytest.raises(RuntimeError, match="no backward pass"):
        sk._rollout_cuda(u.clone().requires_grad_(), par, DT, 2)
    with pytest.raises(RuntimeError, match="no backward pass"):
        sk._rollout_cuda(u, par.clone().requires_grad_(), DT, 2)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        sk._rollout_cuda(u.clone().requires_grad_(), par, DT, 2)
    vel = torch.tensor(cols[1], requires_grad=True)
    pos, _ = sk.sixdof_rollout(cols[0], vel, cols[2], DT, 2, device="cpu", dtype=torch.float64)
    (g,) = torch.autograd.grad(pos[:, 4:].sum(), vel)
    assert torch.isfinite(g).all() and g[:, 3:].abs().min() > 0


# ---------------------------------------------------------------------------
# the kernel's launch plan (``_launch_plan``), held on the CPU: the C
# launcher refuses a block size outside [32, 256] or not a multiple of 32
# ---------------------------------------------------------------------------

PLAN_SIZES = sorted({*range(1, 300), *(k * 32 + d for k in (4, 31, 32, 33, 132, 133, 256, 1024,
                                                           4096, 4224, 8192)
                                       for d in (-1, 0, 1)),
                     8191, 8192, 16384, 32767, 32768, 32769, 131072, 262143, 262144})


@pytest.mark.parametrize("sm_count", [1, 66, 114, 132])
def test_launch_plan_covers_every_body_once(sm_count):
    """One thread a body: the plan's blocks hold every body exactly once
    (the last block ragged, none empty), within the launcher's limits."""
    for n in PLAN_SIZES:
        threads = sk._launch_plan(n, sm_count)
        assert threads % 32 == 0 and sk.MIN_THREADS <= threads <= sk.MAX_THREADS
        blocks = -(-n // threads)
        assert 1 <= blocks <= 2**31 - 1
        assert (blocks - 1) * threads < n <= blocks * threads
        # a narrow N spreads over the SMs: blocks of 128 only where that
        # still gives every SM a block
        assert threads == 128 or blocks >= sm_count or threads == sk.MIN_THREADS


def test_launch_plan_is_cached_and_measured_at_the_timed_widths():
    before = sk._launch_plan.cache_info().hits
    first = sk._launch_plan(32768, 132)
    assert sk._launch_plan(32768, 132) == first
    assert sk._launch_plan.cache_info().hits > before
    # the plans scripts/sixdof_plan_sweep.py times on a 132-SM card
    assert sk._launch_plan(131072, 132) == 128
    assert first == 128
    assert sk._launch_plan(8192, 132) == 32
    assert sk._launch_plan(1, 132) == 32
