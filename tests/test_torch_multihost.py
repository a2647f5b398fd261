"""The port's mesh across processes (``parallel.distributed``: ``init_multihost``
over ``torch.distributed``, the ``ep`` axis, campaigns a process a rank, the
multi-process dry run) on the CPU with ``gloo``: each rank is a new process
started by ``distributed.launch`` on a free port, running
``tests/torch_ranks.py``.

The counterparts of ``tests/test_parallel.py``'s entity-sharded step
(``:48-67``) and edge fold (``:92-122``), of its ``until=`` and ``every``
joins (``:198``, ``:246``) and of ``tests/test_multihost.py``'s gate.

Stated tolerances: the ``ep = 2`` six-dof step against the JAX package's
jitted unsharded step rtol 1e-12 (atol 1e-12), the n-body fold ``force``
rtol 1e-10 and ``world_pos`` rtol 1e-12 (``tests/test_parallel.py``'s);
n-body through ``Exec`` on the mesh (K2's row blocks, plain on the CPU, and
the dense fold) against one process ≤ 1e-12 relative per channel group;
the campaigns across processes, the dry run and a world of one rank against
one process bit for bit.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import elodin_tpu as jel
import elodin_tpu_torch as tel
import torch_ranks as ranks
from elodin_tpu.models import build_batched_sixdof as j_build_sixdof
from elodin_tpu.six_dof import increment_sim_tick_system as j_tick
from elodin_tpu_torch.models import build_nbody, build_nbody_system
from elodin_tpu_torch.models.sixdof_batch import batched_sixdof_init
from elodin_tpu_torch.parallel import distributed
from torch_port_util import float_policy, jax_example, rel_err

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def _launch(target, n, out_dir, monkeypatch):
    """``target`` in ``n`` new CPU ranks that can import ``tests/``."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (TESTS, os.environ.get("PYTHONPATH")) if p))
    return distributed.launch(target, [["cpu"]] * n, kwargs={"out_dir": str(out_dir)},
                              timeout=240)


def _shards(data, prefix: str, name: str):
    """(index, values) of every shard of ``prefix/name`` in a rank's npz."""
    out, k = [], 0
    while f"{prefix}/{name}/{k}" in data:
        bounds = data[f"{prefix}/{name}/{k}/index"]
        out.append((tuple(slice(a, None if b < 0 else b) for a, b in bounds),
                    data[f"{prefix}/{name}/{k}"]))
        k += 1
    return out


@pytest.fixture(scope="module")
def ep_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ep")
    with pytest.MonkeyPatch.context() as mp:
        meta = _launch("torch_ranks:ep_world", 2, out, mp)
    return meta, [dict(np.load(out / f"ep_rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def campaign_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("campaigns")
    with pytest.MonkeyPatch.context() as mp:
        meta = _launch("torch_ranks:campaigns", 2, out, mp)
    return (meta, [dict(np.load(out / f"joins_rank{r}.npz")) for r in range(2)],
            [dict(np.load(out / f"rank{r}.npz")) for r in range(2)])


def _jax_step(meta, system):
    full = jel.Pipe(j_tick, system if isinstance(system, jel.System) else jel.system(system))

    def step(state):
        b = jel.SystemBuilder(meta, dict(state))
        full.call(b)
        return b.cols

    return jax.jit(step)


# -- the ep axis --------------------------------------------------------------------


def test_ep_sixdof_step_matches_jax(ep_ranks):
    """``tests/test_parallel.py``'s entity-sharded step: 64 bodies over 2
    processes, each holding a block of 32 rows of every body column."""
    meta, data = ep_ranks
    assert [m["mesh"] for m in meta] == [{"dp": 1, "ep": 2}] * 2
    with float_policy("f64"):
        world, system = j_build_sixdof(64)
        jmeta, cols = world.snapshot()
        ref = _jax_step(jmeta, system)({k: jnp.asarray(v) for k, v in cols.items()})
    for rank, d in enumerate(data):
        for name in ref:
            (index, got), = _shards(d, "sixdof", name)
            want = np.asarray(ref[name])[index]
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, err_msg=name)
        (index, _), = _shards(d, "sixdof", "world_pos")
        assert index[0] == slice(32 * rank, 32 * rank + 32)
        (index, _), = _shards(d, "sixdof", "tick")
        assert index[0] == slice(0, None)  # the globals' one row stays whole


def test_ep_edge_fold_matches_jax(ep_ranks):
    """``examples/n-body/main.py``'s ``TotalEdge`` fold at 16 bodies: the
    right-hand bodies all-gathered at the read, the probe agreed by every
    rank (it rejects the fold, which runs sequentially)."""
    meta, data = ep_ranks
    mod = jax_example("n-body", "main")
    with float_policy("f64"):
        w = mod.build_world(n_asteroids=14, seed=3)
        jmeta, cols = w.snapshot()
        ref = _jax_step(jmeta, mod.build_system())({k: jnp.asarray(v) for k, v in cols.items()})
    for m in meta:
        assert m["folds"] == {"dense": 0, "sequential": 1, "probes": 1}
    for d in data:
        (index, force), = _shards(d, "fold", "force")
        assert index[0] in (slice(0, 8), slice(8, 16))
        np.testing.assert_allclose(force, np.asarray(ref["force"])[index], rtol=1e-10)
        (index, pos), = _shards(d, "fold", "world_pos")
        np.testing.assert_allclose(pos, np.asarray(ref["world_pos"])[index], rtol=1e-12)


@pytest.mark.parametrize("path", ["kernel", "dense"])
def test_ep_nbody_exec_matches_one_process(ep_ranks, path):
    """n-body through ``Exec`` on the mesh: K2's row blocks from the
    all-gathered bodies (plain on the CPU: no launch), or the dense fold,
    against the same run in one process; every rank reads the whole
    columns."""
    meta, data = ep_ranks
    with float_policy("f64"):
        exec_ = build_nbody(ranks.NBODY_BODIES, seed=2).build(
            build_nbody_system(60.0, use_kernel=path == "kernel"), simulation_rate=1 / 60.0,
            device="cpu")
        exec_.run(ranks.NBODY_TICKS)
        ref = {k: exec_.column_array(k) for k in ("world_pos", "world_vel", "force")}
    assert [m["launches"][path] for m in meta] == [0, 0]
    for d in data:
        for k, want in ref.items():
            assert d[f"{path}/{k}"].shape == want.shape
            assert rel_err(d[f"{path}/{k}"], want) <= 1e-12, k
    np.testing.assert_array_equal(data[0][f"{path}/world_pos"], data[1][f"{path}/world_pos"])


def test_ep_fold_reuses_its_setup_per_rank(ep_ranks):
    """The dense fold through ``Exec`` on the mesh builds its set-up (the
    rank's left ids against every rank's right ones) once on each rank and
    reuses it on every later tick; the kernel path folds nothing."""
    meta, _ = ep_ranks
    for m in meta:
        assert m["setups"] == {"kernel": {"built": 0, "reused": 0},
                               "dense": {"built": 1, "reused": ranks.NBODY_TICKS - 1}}


def test_ep_runs_over_gloo_on_the_host(ep_ranks):
    meta, _ = ep_ranks
    assert {m["transport"] for m in meta} == {"gloo on cpu"}
    # one all-gather a kernel tick (positions and masses as one block), one
    # a fold tick for each right-hand component, and the history's gathers
    assert all(m["collectives"]["all_gather"] >= 3 * ranks.NBODY_TICKS for m in meta)


# -- campaigns a process a rank -------------------------------------------------


def test_until_joins_across_processes(campaign_ranks):
    """``until=`` is an ALL over the ranks: the staggered starts stop at the
    tick-9 segment boundary, as in one process, with the same history."""
    meta, data, _ = campaign_ranks
    with float_policy("f64"):
        one, one_meta = ranks.campaign_runs(device="cpu")
    assert one_meta["until_ticks"] == 9
    for m, d in zip(meta, data):
        assert m["until_ticks"] == one_meta["until_ticks"]
        assert m["history_ticks"] == one_meta["history_ticks"]
        a, b = m["samples"]
        assert b - a == 8
        np.testing.assert_array_equal(d["until/count"], one["until/count"][a:b])
        np.testing.assert_array_equal(d["history/count"], one["history/count"][:, a:b])
        np.testing.assert_array_equal(d["history/times"], one["history/times"])
    assert [m["samples"] for m in meta] == [[0, 8], [8, 16]]


def test_every_joins_across_processes(campaign_ranks):
    """``full_rate_when`` holds in sample 13 (rank 1) from tick 4 on: both
    ranks escalate (an ANY over the ranks), 8 guidance ticks in 10."""
    meta, data, _ = campaign_ranks
    with float_policy("f64"):
        one, one_meta = ranks.campaign_runs(device="cpu")
    for m, d in zip(meta, data):
        a, b = m["samples"]
        assert m["gated_runs"] == one_meta["gated_runs"] == 8
        np.testing.assert_array_equal(d["every/escalated"], np.full(b - a, 8.0))
        for k in ("every/gnc_runs", "every/fast_runs"):
            np.testing.assert_array_equal(d[k], one[k][a:b])


def test_falcon9_campaign_a_process_a_rank(campaign_ranks):
    """falcon9 (16 dispersed missions x 40 ticks) over 2 ranks, each built
    from the example's importable builder by ``run_rank``, against the same
    campaign in one process, bit for bit."""
    from elodin_tpu_torch.examples.falcon9 import batched as f9

    meta, _, finals = campaign_ranks
    with float_policy("f64"):
        campaign, _ = f9.make_campaign(ranks.F9_SAMPLES, seed=ranks.F9_SEED, device="cpu")
        ref = campaign.run(ranks.F9_TICKS, until=f9.until_down)
    for m, final in zip(meta, finals):
        f = m["falcon9"]
        assert f["ticks"] == ref.ticks == ranks.F9_TICKS
        assert f["gated_runs"] == campaign.gated_runs == 8
        a, b = f["samples"]
        for k in ref.final:
            np.testing.assert_array_equal(final[k], ref.column(k)[a:b], err_msg=k)


# -- the dry run and init_multihost -----------------------------------------------------


def test_multihost_dryrun():
    """``tests/test_multihost.py``'s gate: 2 processes x 4 devices with
    ``dp`` across them, then 2 x 1 over ``ep = 2`` and 4 x 1 as 2 x 2,
    every addressable shard equal to one process's."""
    proc = subprocess.run(
        [sys.executable, "-m", "elodin_tpu_torch.parallel.dryrun_multihost", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", "")))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [line for line in proc.stdout.splitlines() if "dryrun_multihost ok" in line]
    assert len(lines) == 3, proc.stdout[-2000:]
    assert "2 processes x 4 devices (gloo), dp=8 ep=1" in lines[0]
    assert "dp=1 ep=2" in lines[1] and "4 processes x 1 devices (gloo), dp=2 ep=2" in lines[2]


@pytest.mark.parametrize("cards,forms,devices,backend", [
    (1, ((2, 1, 1), (2, 1, 2)), [["cuda:0"], ["cuda:0"]], "gloo"),
    (3, ((3, 1, 1),), [["cuda:0"], ["cuda:1"], ["cuda:2"]], None),
    (4, ((4, 1, 1), (4, 1, 2)), [["cuda:0"], ["cuda:1"], ["cuda:2"], ["cuda:3"]], None),
])
def test_multihost_dryrun_takes_the_cards_by_default(monkeypatch, cards, forms, devices,
                                                     backend):
    """Without ``--device`` the dry run takes the visible cards: a rank a
    card over the default backend (nccl), or two ranks sharing one card
    over gloo; ``dp`` across the ranks, then ``ep = 2`` when they are
    even."""
    from elodin_tpu_torch.parallel import dryrun_multihost

    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(distributed, "launch", lambda target, devs, **kw: calls.append(
        (devs, kw["backend"], kw["kwargs"]["ep"])) or [])
    assert dryrun_multihost.card_forms() == forms
    dryrun_multihost.main([])
    assert calls == [(devices, backend, ep) for _, _, ep in forms]


def test_multihost_dryrun_never_falls_back_to_the_host(monkeypatch):
    """With no card visible and no ``--device cpu`` the dry run raises."""
    from elodin_tpu_torch.parallel import dryrun_multihost

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        dryrun_multihost.main([])


@pytest.fixture
def world_of_one(monkeypatch):
    """This test process as a job of one rank, joined through the
    ``ELODIN_*`` variables, and left again afterwards."""
    monkeypatch.setenv("ELODIN_COORDINATOR", f"127.0.0.1:{distributed.free_port()}")
    monkeypatch.setenv("ELODIN_NUM_PROCESSES", "1")
    monkeypatch.setenv("ELODIN_PROCESS_ID", "0")
    monkeypatch.setenv("ELODIN_DEVICES", "cpu,cpu")
    monkeypatch.delenv("ELODIN_BACKEND", raising=False)
    tel.parallel.init_multihost()
    try:
        yield distributed.process()
    finally:
        dist.destroy_process_group()
        distributed._PROCESS = None


def test_init_multihost_env_fallbacks_and_idempotence(world_of_one):
    job = world_of_one
    assert dist.is_initialized() and dist.get_backend() == "gloo"
    assert job.devices == [torch.device("cpu")] * 2 and job.rank == 0
    # a second call does nothing, whatever it is given
    tel.parallel.init_multihost("127.0.0.1:1", 4, 3, devices=["cuda:0"])
    assert distributed.process() is job and dist.get_world_size() == 1
    mesh = tel.parallel.make_mesh()
    assert mesh.distributed and mesh.shape == {"dp": 2, "ep": 1}
    assert mesh.owners.tolist() == [[0], [0]]
    with pytest.raises(NotImplementedError, match="one process a device"):
        tel.parallel.shard_cols(tel.parallel.make_mesh(ep=2), {"x": torch.zeros((8, 3))})


def test_init_multihost_states_what_it_needs(monkeypatch):
    for k in ("ELODIN_COORDINATOR", "ELODIN_NUM_PROCESSES", "ELODIN_PROCESS_ID",
              "ELODIN_DEVICES", "ELODIN_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        tel.parallel.init_multihost()
    with pytest.raises(ValueError, match="never guessed"):
        tel.parallel.init_multihost("127.0.0.1:1", 1, 0)
    with pytest.raises(ValueError, match="all cards or all the CPU"):
        tel.parallel.init_multihost("127.0.0.1:1", 1, 0, devices=["cpu", "cuda:0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tel.parallel.init_multihost("127.0.0.1:1", 1, 0, devices=["cuda:0"])
    assert not dist.is_initialized()


def test_world_of_one_rank_runs_the_distributed_path(world_of_one):
    """A job of one rank (two devices): ``Exec`` on its mesh's row window
    (one part: every row) and the sharded kernels' rank form equal the
    one-process runs bit for bit."""
    from elodin_tpu_torch.ops import pairwise as tpw
    from elodin_tpu_torch.ops import sixdof_kernel as tsk

    mesh = tel.parallel.make_mesh(1)
    with float_policy("f64"):
        runs = {}
        for device in ("cpu", mesh):
            exec_ = build_nbody(32, seed=2).build(build_nbody_system(60.0), device=device,
                                                  simulation_rate=1 / 60.0)
            exec_.run(5)
            runs[str(device)] = {k: exec_.column_array(k) for k in ("world_pos", "force")}
        (a, b) = runs.values()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    rng = np.random.default_rng(0)
    pos, mass = torch.as_tensor(rng.normal(size=(50, 3))), torch.as_tensor(rng.uniform(1, 2, 50))
    mesh2 = tel.parallel.make_mesh()
    got = tpw.pairwise_gravity_sharded(pos, mass, mesh2, g=1.0, eps=0.1)
    assert not got.is_fully_addressable and got.shape == (50, 3)
    with pytest.raises(RuntimeError, match="addressable_shards"):
        np.asarray(got)
    whole = tpw.pairwise_gravity_reference(pos, mass, 1.0, 0.1)
    for shard in got.addressable_shards:
        assert torch.equal(shard.data, whole[shard.index])
    init = batched_sixdof_init(13, seed=4)
    spos, svel = tsk.sixdof_rollout_sharded(*init, 1 / 120.0, 5, mesh2, dtype=torch.float64)
    pos1, vel1 = tsk.sixdof_rollout(*init, 1 / 120.0, 5, device="cpu", dtype=torch.float64)
    for sharded, one in ((spos, pos1), (svel, vel1)):
        assert [s.index[0] for s in sharded.addressable_shards] == [slice(0, 7), slice(7, 13)]
        for shard in sharded.addressable_shards:
            assert torch.equal(shard.data, one[shard.index])


def test_placed_columns_on_a_mesh_across_processes(world_of_one):
    """``put_global`` keeps the rank's shards with their indices, as
    ``jax.make_array_from_callback`` does; ``np.asarray`` of such a column
    raises, as JAX's does for one that spans other processes."""
    mesh = tel.parallel.make_mesh()
    x = np.arange(24.0).reshape(8, 3)
    placed = tel.parallel.put_global(
        tel.parallel.NamedSharding(mesh, ("dp", None)), x)
    assert placed.shape == (8, 3) and not placed.is_fully_addressable
    assert [s.index for s in placed.addressable_shards] == [
        (slice(0, 4), slice(None)), (slice(4, 8), slice(None))]
    for s in placed.addressable_shards:
        np.testing.assert_array_equal(s.data.numpy(), x[s.index])
    with pytest.raises(RuntimeError, match="addressable_shards"):
        np.asarray(placed)
    with pytest.raises(ValueError, match="must divide its size 9"):
        tel.parallel.put_global(tel.parallel.NamedSharding(mesh, ("dp", None)),
                                np.zeros((9, 3)))
    fn, placed = tel.parallel.sharded_step(lambda s: {"x": s["x"] * 2}, mesh,
                                           {"x": torch.as_tensor(x)})
    out = fn(placed)
    for s in out["x"].addressable_shards:
        np.testing.assert_array_equal(s.data.numpy(), 2 * x[s.index])
