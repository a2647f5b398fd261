"""The port's split over devices (``elodin_tpu_torch.parallel``, the
sharded kernels' wrappers and ``BatchedCampaign(mesh=)``) against the JAX
package's on its virtual 8-device CPU mesh (``tests/conftest.py``).

The port builds its meshes from explicit devices, ``["cpu"] * 8`` and
``["cpu"] * 4``: on the CPU every shard runs the kernels' plain versions.
In one process the port raises for ``ep > 1``; the JAX tests of the ``ep``
axis (``tests/test_parallel.py``'s entity-sharded step and edge fold) have
their counterparts across processes in ``tests/test_torch_multihost.py``.

Stated tolerances: mesh shapes, shardings, sample splits, the sharded 6-dof
rollout against one device, every sharded campaign against the unsharded
one on the port, and the dry run's falcon9 columns are equal bit for bit
(the dry run checks 1e-13 relative, as the JAX one does); the port's f32
rollout against the JAX Pallas kernel ≤ 1e-4, the sharded step against the
JAX package's ≤ 1e-12 relative per channel group and the mixed-policy
campaign ≤ 1e-6 (``tests/test_torch_sixdof.py``'s tolerances; falcon9: ≤ 1e-10 with the
floors of ``examples/falcon9/batched.state_errors``, as
``tests/test_torch_falcon9_campaign.py`` holds it); the sharded all-pairs
gravity against the JAX package's at rtol 1e-10 (``tests/test_parallel.py``)
and a ragged split against the plain version ≤ 1e-12 relative.
"""

import typing as ty
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import elodin_tpu as jel
import elodin_tpu_torch as tel
from elodin_tpu.monte_carlo import BatchedCampaign as JCampaign
from elodin_tpu.monte_carlo import run_batched as j_run_batched
from elodin_tpu.parallel import entity_sharding as j_entity_sharding
from elodin_tpu.parallel import make_mesh as j_make_mesh
from elodin_tpu_torch import parallel as tp
from elodin_tpu_torch.interop import campaign_columns_from_numpy
from elodin_tpu_torch.monte_carlo import BatchedCampaign as TCampaign
from elodin_tpu_torch.monte_carlo import run_batched as t_run_batched
from elodin_tpu_torch.ops import pairwise as tpw
from elodin_tpu_torch.ops import sixdof_kernel as tsk
from elodin_tpu_torch.parallel import mesh as tmesh
from torch_port_util import float_policy, jax_example, rel_err

SHARDS = [8, 4]


def _port_mesh(shards, **kw):
    return tp.make_mesh(devices=["cpu"] * shards, **kw)


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    return j_make_mesh(8)


# -- make_mesh, entity_sharding, put_global ----------------------------------------


@pytest.mark.parametrize("kw", [{}, {"ep": 2}, {"dp": 2}, {"ep": 8}, {"dp": 8}])
def test_make_mesh_shapes_match_jax(jmesh, kw):
    ours = tp.make_mesh(8, devices=["cpu"] * 8, **kw)
    ref = j_make_mesh(8, **kw)
    assert ours.axis_names == ref.axis_names == ("dp", "ep")
    assert ours.shape == dict(ref.shape)
    assert ours.devices.shape == ref.devices.shape


def test_make_mesh_errors_match_jax(jmesh):
    with pytest.raises(ValueError, match="3x2 != 8"):
        j_make_mesh(8, dp=3)
    with pytest.raises(ValueError, match="3x2 != 8"):
        tp.make_mesh(8, dp=3, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        j_make_mesh(16)
    with pytest.raises(ValueError, match="16 devices asked, 8 available"):
        tp.make_mesh(16, devices=["cpu"] * 8)
    # n_devices takes the first devices, as the JAX package takes jax.devices()[:n]
    assert tp.make_mesh(4, devices=["cpu"] * 8).shape == {"dp": 4, "ep": 1}


def test_make_mesh_takes_only_cuda_cards_without_devices():
    """No CPU fallback: without ``devices=`` the mesh is the visible CUDA
    cards, and this host has none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tp.make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tp.make_mesh()


@pytest.mark.parametrize("sample_axis", [False, True])
@pytest.mark.parametrize("rows,ndim", [(1, 2), (8, 2), (7, 3), (16, 1), (64, 3)])
@pytest.mark.parametrize("kw", [{}, {"ep": 2}, {"dp": 2}])
def test_entity_sharding_matches_jax(jmesh, kw, rows, ndim, sample_axis):
    if sample_axis and ndim < 2:
        ndim = 2
    ref = j_entity_sharding(j_make_mesh(8, **kw), rows, ndim, sample_axis)
    ours = tp.entity_sharding(tp.make_mesh(8, devices=["cpu"] * 8, **kw), rows, ndim,
                              sample_axis)
    assert ours.spec == tuple(ref.spec) + (None,) * (ndim - len(ref.spec))


def test_mesh_without_dp_or_ep_axis(jmesh):
    """A pure sample-parallel mesh under another axis name
    (``tests/test_parallel.py``'s regression): rows stay whole, samples go
    over the mesh's first axis."""
    from jax.sharding import Mesh as JMesh

    ref_mesh = JMesh(np.asarray(jax.devices()[:4]), ("samples",))
    mesh = tp.Mesh(np.array(["cpu"] * 4, dtype=object), ("samples",))
    assert mesh.shape == dict(ref_mesh.shape) == {"samples": 4}
    for rows, ndim, sample_axis in ((8, 2, False), (8, 3, True)):
        ref = j_entity_sharding(ref_mesh, rows, ndim, sample_axis)
        assert tp.entity_sharding(mesh, rows, ndim, sample_axis).spec == (
            tuple(ref.spec) + (None,) * (ndim - len(ref.spec)))
    placed = tp.shard_cols(mesh, {"x": torch.zeros((4, 8, 3))}, sample_axis=True)
    assert placed["x"].shape == (4, 8, 3) and len(placed["x"].shards) == 4
    assert all(s.shape == (1, 8, 3) for s in placed["x"].shards)


def test_put_global_splits_as_jax_device_put(jmesh):
    """A cut that the axis does not divide raises ValueError in both
    packages; one that it divides gives each device its equal part."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    with pytest.raises(ValueError):
        jax.device_put(np.arange(10.0), NamedSharding(j_make_mesh(8), P("dp")))
    mesh = _port_mesh(8)
    with pytest.raises(ValueError, match="must divide its size 10"):
        tp.put_global(tmesh.NamedSharding(mesh, ("dp",)), np.arange(10.0))
    x = np.arange(48.0).reshape(16, 3)
    placed = tp.put_global(tmesh.NamedSharding(mesh, ("dp", None)), x)
    assert placed.dim == 0 and [tuple(s.shape) for s in placed.shards] == [(2, 3)] * 8
    np.testing.assert_array_equal(np.asarray(placed), x)
    whole = tp.put_global(tmesh.NamedSharding(mesh, (None, None)), x)
    assert whole.dim is None and len(whole.shards) == 1
    np.testing.assert_array_equal(np.asarray(whole), x)


def test_ep_axis_and_init_multihost_wait_for_torch_distributed(monkeypatch):
    """Rows over ``ep > 1`` in one process still raise: the shards of an
    eager tick must exchange rows in lockstep, so they need one process a
    device (``tests/test_torch_multihost.py`` runs them so), and the error
    names the launcher.  ``init_multihost`` forms a ``torch.distributed``
    group now, and without a job to join it says what it lacks.  Rows that
    the ep axis does not divide stay whole, as in the JAX package."""
    mesh = _port_mesh(8, ep=2)
    with pytest.raises(NotImplementedError, match="one process a device along it.*launch"):
        tp.shard_cols(mesh, {"x": torch.zeros((64, 3))})
    with pytest.raises(NotImplementedError, match="one process a device"):
        tp.sharded_step(lambda s: s, mesh, {"x": torch.zeros((2, 64, 3))}, sample_axis=True)
    for k in ("ELODIN_COORDINATOR", "ELODIN_NUM_PROCESSES", "ELODIN_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="ELODIN_COORDINATOR"):
        tp.init_multihost()
    placed = tp.shard_cols(mesh, {"x": torch.zeros((7, 3))})
    assert placed["x"].dim is None and len(placed["x"].shards) == 1


def test_row_blocks_cover_every_row_once():
    for n in (0, 1, 7, 8, 500, 16384):
        for parts in (1, 3, 4, 8):
            blocks = tmesh.row_blocks(n, parts)
            sizes = [b - a for a, b in blocks]
            assert len(blocks) == parts and blocks[0][0] == 0 and blocks[-1][1] == n
            assert all(blocks[k][1] == blocks[k + 1][0] for k in range(parts - 1))
            assert max(sizes) - min(sizes) <= 1


# -- sharded_step ---------------------------------------------------------------


def _sixdof_step(el, meta, system):
    from elodin_tpu_torch.six_dof import increment_sim_tick_system as t_inc
    from elodin_tpu.six_dof import increment_sim_tick_system as j_inc

    full = el.Pipe(j_inc if el is jel else t_inc, el.system(system)
                   if not isinstance(system, el.System) else system)

    def step(state):
        b = el.SystemBuilder(meta, dict(state))
        full.call(b)
        return b.cols

    return step


@pytest.mark.parametrize("shards", SHARDS)
def test_sample_sharded_step_matches_unsharded_and_jax(jmesh, shards):
    """``tests/test_parallel.py``'s dp-sharded step: 16 samples of an
    8-body world, 3 vmapped ticks."""
    from elodin_tpu.models import build_batched_sixdof as j_build
    from elodin_tpu.parallel import sharded_step as j_sharded_step
    from elodin_tpu_torch.models import build_batched_sixdof as t_build

    with float_policy("f64"):
        jw, js = j_build(8)
        jmeta, jcols = jw.snapshot()
        jstep = jax.vmap(_sixdof_step(jel, jmeta, js))

        def jthree(s):
            return jstep(jstep(jstep(s)))

        batched = {k: np.broadcast_to(v, (16,) + v.shape).copy() for k, v in jcols.items()}
        fn, placed = j_sharded_step(jthree, jmesh, batched, sample_axis=True)
        ref = {k: np.asarray(v) for k, v in fn(placed).items()}

        tw, ts = t_build(8)
        tmeta, tcols = tw.snapshot()
        tstep = vmap(_sixdof_step(tel, tmeta, ts))

        def tthree(s):
            return tstep(tstep(tstep(s)))

        cols = campaign_columns_from_numpy(
            {k: np.broadcast_to(v, (16,) + v.shape).copy() for k, v in tcols.items()},
            tmeta, "cpu")
        single = tthree(cols)
        fn, placed = tp.sharded_step(tthree, _port_mesh(shards), cols, sample_axis=True)
        out = fn(placed)
    assert all(len(c.shards) == shards and c.dim == 0 for c in out.values())
    for k in ref:
        np.testing.assert_array_equal(np.asarray(out[k]), single[k].numpy(), err_msg=k)
    for k in ("world_pos", "world_vel"):
        assert rel_err(np.asarray(out[k]), ref[k]) <= 1e-12, k
    np.testing.assert_array_equal(np.asarray(out["tick"]), ref["tick"])


def test_step_on_whole_columns_runs_once():
    """Without a sample axis and with ep = 1 every column stays whole: the
    step runs once, on the mesh's first device."""
    from elodin_tpu_torch.models import build_batched_sixdof as t_build

    tw, ts = t_build(8)
    meta, cols = tw.snapshot()
    step = _sixdof_step(tel, meta, ts)
    calls = []

    def counted(state):
        calls.append(1)
        return step(state)

    cols = campaign_columns_from_numpy({k: v[None] for k, v in cols.items()}, meta, "cpu")
    cols = {k: v[0] for k, v in cols.items()}
    fn, placed = tp.sharded_step(counted, _port_mesh(8), cols)
    out = fn(placed)
    assert len(calls) == 1 and all(c.dim is None for c in out.values())
    ref = step(cols)
    for k in ref:
        assert torch.equal(out[k].gather(), ref[k]), k


# -- the sharded kernels' wrappers ------------------------------------------------


def _rollout_inputs(n=500, seed=11):
    """``tests/test_sixdof_kernel.py``'s sharded case: 500 bodies, which do
    not divide 8 or 4 shards."""
    rng = np.random.default_rng(seed)
    pos = np.empty((n, 7), np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    pos[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    pos[:, 4:] = rng.normal(0, 1e4, (n, 3)) + np.array([6.771e6, 0, 0])
    vel = rng.normal(0, 10.0, (n, 6)).astype(np.float32)
    vel[:, 0:3] *= 1e-3
    inertia = rng.uniform(1.0, 3.0, (n, 7)).astype(np.float32)
    return pos, vel, inertia


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shards", SHARDS)
def test_sixdof_rollout_sharded_is_bitwise_one_device(shards, dtype):
    pos, vel, inertia = _rollout_inputs()
    single = tsk.sixdof_rollout(pos, vel, inertia, 1 / 120.0, 25, device="cpu", dtype=dtype)
    before = tsk.LAUNCHES
    shard = tsk.sixdof_rollout_sharded(pos, vel, inertia, 1 / 120.0, 25, _port_mesh(shards),
                                       dtype=dtype)
    assert tsk.LAUNCHES == before  # the plain version on the CPU launches nothing
    for a, b in zip(shard, single):
        assert a.dtype == dtype and torch.equal(a, b)


def test_sixdof_rollout_sharded_matches_jax(jmesh):
    pos, vel, inertia = _rollout_inputs()
    jpos, jvel = jax_sixdof_sharded(pos, vel, inertia, jmesh)
    tpos, tvel = tsk.sixdof_rollout_sharded(pos, vel, inertia, 1 / 120.0, 25, _port_mesh(8),
                                            dtype=torch.float32)
    assert rel_err(tpos, jpos) <= 1e-4 and rel_err(tvel, jvel) <= 1e-4


def jax_sixdof_sharded(pos, vel, inertia, mesh):
    from elodin_tpu.ops import sixdof_kernel as jsk

    return jsk.sixdof_rollout_sharded(pos, vel, inertia, dt=1 / 120.0, ticks=25, mesh=mesh,
                                      block_rows=8, interpret=True)


def test_pairwise_gravity_sharded_matches_jax(jmesh):
    """``tests/test_parallel.py``'s case: 64 bodies, eps 1.0."""
    from elodin_tpu.ops.pairwise import pairwise_gravity_sharded as j_sharded

    rng = np.random.default_rng(4)
    n = 64
    pos = rng.normal(size=(n, 3)) * 1e3
    mass = np.abs(rng.normal(size=(n,))) * 1e9
    want = np.asarray(j_sharded(pos, mass, jmesh, eps=1.0))
    for shards in SHARDS:
        got = tpw.pairwise_gravity_sharded(pos, mass, _port_mesh(shards), eps=1.0)
        assert got.dtype == torch.float64 and got.shape == (n, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


@pytest.mark.parametrize("n", [67, 5])
def test_pairwise_gravity_sharded_ragged_split(n):
    """Rows that do not divide the shards (and fewer rows than shards)
    against the plain version of the whole set, with coincident bodies."""
    rng = np.random.default_rng(n)
    pos = torch.as_tensor(rng.normal(size=(n, 3)) * 10)
    pos[3] = pos[1]
    mass = torch.as_tensor(rng.uniform(1.0, 2.0, n))
    ref = tpw.pairwise_gravity_reference(pos, mass, 1.0, 0.1)
    got = tpw.pairwise_gravity_sharded(pos, mass, _port_mesh(8), g=1.0, eps=0.1)
    assert rel_err(got, ref) <= 1e-12


def test_pairwise_row_block_of_the_plain_version():
    """A row block [row0, row0 + rows) is those rows of the whole call; the
    range is checked."""
    rng = np.random.default_rng(1)
    pos = torch.as_tensor(rng.normal(size=(50, 3)))
    mass = torch.as_tensor(rng.uniform(1.0, 2.0, 50))
    whole = tpw.pairwise_gravity_reference(pos, mass, 1.0, 0.0)
    for row0, rows in ((0, 50), (0, 13), (13, 24), (49, 1), (20, 0)):
        block = tpw.pairwise_gravity(pos, mass, 1.0, 0.0, row0=row0, rows=rows)
        assert block.shape == (rows, 3)
        assert rows == 0 or rel_err(block, whole[row0:row0 + rows]) <= 1e-14
    for row0, rows in ((-1, 2), (40, 11), (51, 0)):
        with pytest.raises(ValueError, match="row block"):
            tpw.pairwise_gravity_reference(pos, mass, row0=row0, rows=rows)


@pytest.mark.parametrize("n", [1, 300, 4096, 16384])
@pytest.mark.parametrize("parts", [2, 4, 8])
@pytest.mark.parametrize("sm_count", [1, 132])
def test_launch_plan_of_a_row_block(n, parts, sm_count):
    """The plan for a row block covers its rows once and the n columns
    once, within the launcher's limits; the whole call's plan is
    unchanged."""
    assert tpw._launch_plan(n, sm_count, n) == tpw._launch_plan(n, sm_count)
    for start, stop in tmesh.row_blocks(n, parts):
        rows = stop - start
        if rows == 0:
            continue
        plan = tpw._launch_plan(n, sm_count, rows)
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 32 * tpw.MAX_WARPS
        assert plan.r in (1, 2) and 1 <= plan.s <= tpw.MAX_CLUSTER
        assert plan.slice >= tpw.TILE and plan.slice % tpw.TILE == 0
        assert plan.splits * plan.slice >= n
        assert (plan.s - 1) * (plan.threads // 32) * plan.slice < n
        assert plan.grid(rows) // plan.s * 32 * plan.r >= rows


# -- BatchedCampaign(mesh=) --------------------------------------------------------


def test_campaign_signatures_follow_jax():
    import inspect

    ours = list(inspect.signature(TCampaign).parameters)
    ref = list(inspect.signature(JCampaign).parameters)
    assert ours == ref + ["device"]
    assert (list(inspect.signature(t_run_batched).parameters)
            == list(inspect.signature(j_run_batched).parameters) + ["device"])


def _count_world(el, arr, starts):
    Count = ty.Annotated[arr, el.Component("count", el.ComponentType.F64)]

    @dataclass
    class A(el.Archetype):
        count: Count = field(default_factory=lambda: np.float64(0.0))

    if el is jel:
        def inc(c: Count) -> Count:
            return jnp.minimum(c + 1.0, 5.0)
    else:
        def inc(c: Count) -> Count:
            return torch.clamp(c + 1.0, max=5.0)

    w = el.World()
    w.spawn(A(), name="e")
    return w, el.map(inc), {"e.count": starts}


def _campaign(el, world, system, n, overrides, mesh):
    if el is jel:
        return JCampaign(world, system, n, overrides, simulation_rate=10.0, mesh=mesh)
    return TCampaign(world, system, n, overrides, simulation_rate=10.0, mesh=mesh,
                     device=None if mesh else "cpu")


@pytest.mark.parametrize("shards", SHARDS)
def test_until_early_stop_sharded(jmesh, monkeypatch, shards):
    """``until=`` is an AND over every shard at a segment boundary:
    staggered starts latch at different ticks, so the stop must wait for
    the last shard; the history emits come back in sample order."""
    monkeypatch.setenv("ELODIN_MC_SEGMENT_TICKS", "3")
    starts = np.arange(16) % 3
    starts[-1] = -4  # the last shard's last sample latches last

    def until(cols):
        return cols["count"] >= 5.0

    out = {}
    with float_policy("f64"):
        for name, (el, arr, mesh) in {
                "jax": (jel, jax.Array, jmesh), "plain": (tel, torch.Tensor, None),
                "shard": (tel, torch.Tensor, _port_mesh(shards))}.items():
            w, s, over = _count_world(el, arr, starts)
            r = _campaign(el, w, s, 16, over, mesh).run(20, until=until)
            w, s, over = _count_world(el, arr, starts)
            h = _campaign(el, w, s, 16, over, mesh).run(
                20, history_every=2, history_components=["e.count"], until=until)
            out[name] = (r.ticks, r.component("e.count"), h.ticks, np.asarray(h.history["count"]),
                         h.history_times)
    assert out["shard"][0] == out["plain"][0] == out["jax"][0] == 9
    assert out["shard"][2] == out["plain"][2] == out["jax"][2]
    for name in ("plain", "jax"):
        np.testing.assert_array_equal(out["shard"][1], out[name][1])
        np.testing.assert_array_equal(out["shard"][3], out[name][3])
        np.testing.assert_array_equal(out["shard"][4], out[name][4])
    # sample order: the emits (every 2 ticks, a segment each) of sample 15
    # are the last column, and the stop comes at tick 10
    np.testing.assert_array_equal(out["shard"][3][:, -1, 0], [-2, 0, 2, 4, 5])


def _runs_world(el, arr, fast0):
    Runs = ty.Annotated[arr, el.Component("gnc_runs", el.ComponentType.F64)]
    Fast = ty.Annotated[arr, el.Component("fast_runs", el.ComponentType.F64)]

    @dataclass
    class A(el.Archetype):
        gnc_runs: Runs = field(default_factory=lambda: np.float64(0.0))
        fast_runs: Fast = field(default_factory=lambda: np.float64(0.0))

    def gnc(r: Runs) -> Runs:
        return r + 1.0

    def fast(f: Fast) -> Fast:
        return f + 1.0

    w = el.World()
    w.spawn(A(), name="e")
    return w, el.map(gnc), el.map(fast), {"e.fast_runs": fast0}


@pytest.mark.parametrize("shards", SHARDS)
def test_every_escalation_is_any_over_shards(jmesh, shards):
    """``full_rate_when`` holds in one sample of one shard from tick 4 on:
    every shard escalates (a gate decided per shard would leave the others
    at the 1-in-4 schedule, ``tests/test_parallel.py``'s case)."""
    fast0 = np.zeros(16)
    fast0[13] = 3.0  # sample 13 reaches 6 fast runs after tick 3

    out = {}
    with float_policy("f64"):
        for name, (el, arr, mesh) in {
                "jax": (jel, jax.Array, jmesh), "plain": (tel, torch.Tensor, None),
                "shard": (tel, torch.Tensor, _port_mesh(shards))}.items():
            w, gnc, fast, over = _runs_world(el, arr, fast0)
            esc = el.every(4, gnc, full_rate_when=lambda cols: cols["fast_runs"] >= 6.0)
            c = _campaign(el, w, esc | fast, 16, over, mesh)
            r = c.run(10)
            w, gnc, fast, over = _runs_world(el, arr, fast0)
            plain = _campaign(el, w, el.every(3, gnc) | fast, 16, over, mesh).run(9)
            out[name] = (r.component("e.gnc_runs"), plain.component("e.gnc_runs"),
                         plain.component("e.fast_runs"), getattr(c, "gated_runs", None))
    # ticks 1 and 3 (no: 1 on schedule), then every tick from 4 to 10
    np.testing.assert_array_equal(out["shard"][0], np.full(16, 8.0))
    assert out["shard"][3] == out["plain"][3] == 8
    for name in ("plain", "jax"):
        for a, b in zip(out["shard"][:3], out[name][:3]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shards", SHARDS)
def test_mixed_float_policy_sharded(jmesh, shards):
    """The mixed policy's f32 and f64 columns split alike; the sharded run
    equals the unsharded one bitwise and the JAX package's to 1e-6, the
    mixed policy's tolerance of ``tests/test_torch_sixdof.py``."""
    from elodin_tpu.models import build_batched_sixdof as j_build
    from elodin_tpu_torch.models import build_batched_sixdof as t_build

    with float_policy("mixed"):
        jw, js = j_build(8)
        ref = JCampaign(jw, js, 16, simulation_rate=120.0, mesh=jmesh).run(50)
        tw, ts = t_build(8)
        plain = TCampaign(tw, ts, 16, simulation_rate=120.0, device="cpu").run(50)
        tw, ts = t_build(8)
        shard = TCampaign(tw, ts, 16, simulation_rate=120.0, mesh=_port_mesh(shards)).run(50)
    for k in plain.final:
        a, b = shard.column(k), plain.column(k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    for k in ("world_pos", "world_vel"):
        r = np.asarray(ref.final[k])
        assert shard.column(k).dtype == r.dtype, k
        assert rel_err(shard.column(k), r) <= 1e-6, k


def test_sample_count_must_divide_the_axis(jmesh):
    """10 samples over 8 devices: ``jax.device_put`` refuses the sharding,
    and so does the port; the axis name falls back to the mesh's first."""
    with float_policy("f64"):
        w, s, over = _count_world(jel, jax.Array, np.zeros(10))
        with pytest.raises(ValueError):
            JCampaign(w, s, 10, over, simulation_rate=10.0, mesh=jmesh)
        w, s, over = _count_world(tel, torch.Tensor, np.zeros(10))
        with pytest.raises(ValueError, match="8 devices of axis 'dp', which must divide its size 10"):
            TCampaign(w, s, 10, over, mesh=_port_mesh(8))
        w, s, over = _count_world(tel, torch.Tensor, np.zeros(16))
        c = TCampaign(w, s, 16, over, mesh=_port_mesh(8))
        assert c.axis_name == "dp" and c.device == torch.device("cpu")
        assert [p["count"].shape[0] for p in c._parts] == [2] * 8
        with pytest.raises(ValueError, match="a device or a mesh"):
            TCampaign(w, s, 16, over, mesh=_port_mesh(8), device="cpu")


# -- the examples and the dry run --------------------------------------------------


def test_landing_fractions_with_a_mesh():
    """The landing campaign's fractions do not move with the split: 8
    landings over 2 host shards against the JAX example's 8."""
    from elodin_tpu_torch.examples.monte_carlo import batched as tmc

    jmc = jax_example("monte-carlo", "batched")
    ref = jmc.run_campaign(8, 2400, seed=0)
    with float_policy("f64"):
        ours = tmc.run_campaign(8, 2400, 0, mesh=_port_mesh(2))
    assert ours["ticks"] == ref["ticks"] == 2400
    assert ours["landed_frac"] == ref["landed_frac"]
    assert ours["soft_landing_frac"] == ref["soft_landing_frac"]
    assert abs(ours["mean_touchdown_vz"] - ref["mean_touchdown_vz"]) <= 1e-9


def test_falcon9_campaign_sharded(jmesh):
    """16 dispersed missions x 40 ticks (8 guidance firings):
    the port over 4 host shards equals the port on one device bitwise and
    the JAX package's sharded campaign to 1e-10."""
    from elodin_tpu_torch.examples.falcon9 import batched as tf9

    jf9 = jax_example("falcon9", "sim")
    with float_policy("f64"):
        plain, draws = tf9.make_campaign(16, seed=3, device="cpu")
        shard, _ = tf9.make_campaign(16, seed=3, mesh=_port_mesh(4))
        jw, js = jf9.build(None, sensors=False)
        ref = JCampaign(jw, js, 16, tf9.overrides_of(draws), simulation_rate=jf9.SIM_RATE_HZ,
                        mesh=jmesh).run(40, until=tf9.until_down)
        a = shard.run(40, until=tf9.until_down)
        b = plain.run(40, until=tf9.until_down)
    assert a.ticks == b.ticks == ref.ticks == 40 and shard.gated_runs == 8
    final = {k: a.column(k) for k in a.final}
    for k, v in final.items():
        np.testing.assert_array_equal(v, b.column(k), err_msg=k)
    errs = tf9.state_errors(final, {k: np.asarray(v) for k, v in ref.final.items()})
    assert max(errs.values()) <= 1e-10, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def test_dryrun_multichip_on_eight_host_shards(capsys):
    from elodin_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(8, devices=["cpu"] * 8)
    assert out["mesh"] == {"dp": 8, "ep": 1} and out["falcon9_ticks"] == 4
    assert out["ep_mesh"] == {"dp": 4, "ep": 2}
    text = capsys.readouterr().out
    assert "dryrun_multichip ok" in text and "dryrun falcon9 ok" in text
    assert "dryrun kernel ok" in text and "dryrun ep ok: 8 processes" in text
