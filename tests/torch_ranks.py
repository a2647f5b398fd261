"""What the ranks of the port's multi-process tests run
(``tests/test_torch_multihost.py``, and the staged gloo cases of
``tests/test_torch_gpu.py``): functions that ``parallel.distributed.launch``
calls in new processes, which import torch and the port only (no JAX) and
write what they computed to npz files that the tests hold against the JAX
package and against one process.

No ``from __future__ import annotations``: this module defines
``@el.system`` functions, which read their annotations as objects."""

import os
import typing as ty
from dataclasses import dataclass, field

import numpy as np
import torch

import elodin_tpu_torch as el

# the n-body worlds the ep cases run through Exec on the mesh
NBODY_BODIES, NBODY_TICKS = 64, 10
SEGMENT_TICKS = 3  # the until= case's segments (tests/test_parallel.py's)
F9_SAMPLES, F9_TICKS, F9_SEED = 16, 40, 3


def _shard_arrays(prefix: str, placed: dict) -> dict:
    """Every addressable shard of the placed columns: its values, and the
    [start, stop) of its index in each dimension (stop -1: to the end)."""
    out = {}
    for name, col in placed.items():
        for k, shard in enumerate(col.addressable_shards):
            out[f"{prefix}/{name}/{k}"] = shard.data.cpu().numpy()
            out[f"{prefix}/{name}/{k}/index"] = np.array(
                [[s.start or 0, -1 if s.stop is None else s.stop] for s in shard.index])
    return out


def _rank() -> int:
    from elodin_tpu_torch.parallel import distributed

    return distributed.process().rank


def ep_world(out_dir: str) -> dict:
    """The bodies cut over ``ep`` (one rank a device of the job): the
    batched 6-dof step at 64 bodies and ``examples/n-body/main.py``'s fold at
    16 through ``sharded_step`` (``tests/test_parallel.py``'s cases), then
    n-body on the kernel path and on the dense fold through ``Exec`` on the
    mesh, ``NBODY_TICKS`` ticks, f64."""
    from elodin_tpu_torch import _config
    from elodin_tpu_torch.interop import columns_from_numpy
    from elodin_tpu_torch.models import build_batched_sixdof, build_nbody, build_nbody_system
    from elodin_tpu_torch.ops import pairwise
    from elodin_tpu_torch.parallel import distributed, make_mesh, sharded_step
    from elodin_tpu_torch.system import FOLD_SETUPS, TOTAL_FOLDS, build_step

    _config.set_float_policy("f64")
    mesh = make_mesh(ep=len(distributed.process().global_devices))
    arrays = {}
    world, system = build_batched_sixdof(64)
    meta, cols = world.snapshot()
    fn, placed = sharded_step(build_step(meta, system), mesh,
                              columns_from_numpy(cols, meta, "cpu"))
    arrays.update(_shard_arrays("sixdof", fn(placed)))

    from elodin_tpu_torch.examples.n_body import main as n_body

    system = n_body.build_system()
    meta, cols = n_body.build_world(14, 3).snapshot()
    folds = dict(TOTAL_FOLDS)
    fn, placed = sharded_step(build_step(meta, system), mesh,
                              columns_from_numpy(cols, meta, "cpu"))
    arrays.update(_shard_arrays("fold", fn(placed)))
    folds = {k: TOTAL_FOLDS[k] - v for k, v in folds.items()}

    launches, setups, before = {}, {}, dict(distributed.COLLECTIVES)
    for name, use_kernel in (("kernel", True), ("dense", False)):
        exec_ = build_nbody(NBODY_BODIES, seed=2).build(
            build_nbody_system(60.0, use_kernel=use_kernel), simulation_rate=1 / 60.0,
            device=mesh)
        pairwise.LAUNCHES = 0
        built = dict(FOLD_SETUPS)
        exec_.run(NBODY_TICKS)
        launches[name] = pairwise.LAUNCHES
        setups[name] = {k: FOLD_SETUPS[k] - v for k, v in built.items()}
        for k in ("world_pos", "world_vel", "force"):
            arrays[f"{name}/{k}"] = exec_.column_array(k)
    np.savez(os.path.join(out_dir, f"ep_rank{_rank()}.npz"), **arrays)
    return {"rank": _rank(), "mesh": mesh.shape, "folds": folds, "launches": launches,
            "setups": setups,
            "transport": mesh.line_comm("ep", mesh.local_positions()[0]).transport,
            "collectives": {k: distributed.COLLECTIVES[k] - v for k, v in before.items()}}


# -- campaigns whose joins decide (tests/test_parallel.py:198 and :246) ------------

Count = ty.Annotated[torch.Tensor, el.Component("count", el.ComponentType.F64)]
Runs = ty.Annotated[torch.Tensor, el.Component("gnc_runs", el.ComponentType.F64)]
Fast = ty.Annotated[torch.Tensor, el.Component("fast_runs", el.ComponentType.F64)]


@dataclass
class Counter(el.Archetype):
    count: Count = field(default_factory=lambda: np.float64(0.0))


@dataclass
class Rates(el.Archetype):
    gnc_runs: Runs = field(default_factory=lambda: np.float64(0.0))
    fast_runs: Fast = field(default_factory=lambda: np.float64(0.0))


@el.map
def inc(c: Count) -> Count:
    return torch.clamp(c + 1.0, max=5.0)


@el.map
def gnc(r: Runs) -> Runs:
    return r + 1.0


@el.map
def fast(f: Fast) -> Fast:
    return f + 1.0


def count_done(cols):
    return cols["count"] >= 5.0


def count_starts(n: int) -> np.ndarray:
    """Staggered starts: the samples latch at different ticks, the last
    sample (in the last rank) last."""
    starts = np.arange(n) % 3
    starts[-1] = -4
    return starts.astype(np.float64)


def count_campaign(n: int, mesh=None, device=None):
    w = el.World()
    w.spawn(Counter(), name="e")
    return el.monte_carlo.BatchedCampaign(w, inc, n, {"e.count": count_starts(n)},
                                          simulation_rate=10.0, mesh=mesh, device=device)


def rates_campaign(n: int, escalate: bool, mesh=None, device=None):
    """Guidance every 4 ticks, escalated to every tick once sample 13 has
    run 6 fast ticks (``escalate``), or plainly every 3."""
    fast0 = np.zeros(n)
    fast0[13] = 3.0
    w = el.World()
    w.spawn(Rates(), name="e")
    gate = (el.every(4, gnc, full_rate_when=lambda cols: cols["fast_runs"] >= 6.0)
            if escalate else el.every(3, gnc))
    return el.monte_carlo.BatchedCampaign(w, gate | fast, n, {"e.fast_runs": fast0},
                                          simulation_rate=10.0, mesh=mesh, device=device)


def campaign_runs(mesh=None, device=None) -> dict:
    """The joins' cases on one mesh or device: numpy arrays of the samples
    it holds, and the ticks and gated ticks each run took."""
    prev = os.environ.get("ELODIN_MC_SEGMENT_TICKS")
    os.environ["ELODIN_MC_SEGMENT_TICKS"] = str(SEGMENT_TICKS)
    try:
        r = count_campaign(16, mesh, device).run(20, until=count_done)
        h = count_campaign(16, mesh, device).run(20, history_every=2,
                                                 history_components=["e.count"],
                                                 until=count_done)
    finally:
        if prev is None:
            del os.environ["ELODIN_MC_SEGMENT_TICKS"]
        else:
            os.environ["ELODIN_MC_SEGMENT_TICKS"] = prev
    esc_c = rates_campaign(16, True, mesh, device)
    esc = esc_c.run(10)
    plain = rates_campaign(16, False, mesh, device).run(9)
    arrays = {"until/count": r.component("e.count"), "history/count": h.history["count"],
              "history/times": h.history_times, "every/escalated": esc.component("e.gnc_runs"),
              "every/gnc_runs": plain.component("e.gnc_runs"),
              "every/fast_runs": plain.component("e.fast_runs")}
    meta = {"until_ticks": r.ticks, "history_ticks": h.ticks, "gated_runs": esc_c.gated_runs,
            "samples": [r.samples.start, r.samples.stop]}
    return arrays, meta


def campaigns(out_dir: str) -> dict:
    """A rank of the 2-rank campaigns: the joins' cases over
    ``make_mesh()``, then falcon9 (``F9_SAMPLES`` x ``F9_TICKS``) through
    ``monte_carlo.batched.run_rank``, which builds it from its importable
    builder."""
    from elodin_tpu_torch import _config
    from elodin_tpu_torch.monte_carlo.batched import run_rank
    from elodin_tpu_torch.parallel import make_mesh

    _config.set_float_policy("f64")
    arrays, meta = campaign_runs(mesh=make_mesh())
    np.savez(os.path.join(out_dir, f"joins_rank{_rank()}.npz"), **arrays)
    meta["falcon9"] = run_rank(
        "elodin_tpu_torch.examples.falcon9.batched:make_campaign", F9_SAMPLES, F9_TICKS,
        until="elodin_tpu_torch.examples.falcon9.batched:until_down", out_dir=out_dir,
        seed=F9_SEED)
    return meta
