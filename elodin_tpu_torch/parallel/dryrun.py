"""The multi-device dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``): the JAX package's three programs over a device mesh,
at its sizes and with its checks.

1. 4 ticks of the vmapped batched 6-dof through ``sharded_step``, samples
   over ``dp`` (``ep = 1`` in this process);
2. the falcon9 campaign through ``BatchedCampaign(mesh=)``: ``2 n``
   samples, 2-tick segments, ``until tick >= 3``, stopping at tick 4 of 8,
   every column within 1e-13 relative of the unsharded run on the mesh's
   first device;
3. the whole-rollout kernel sharded over 200 bodies, 10 ticks, bitwise
   equal to one device, in f32 and f64;
4. with an even ``n_devices`` of 4 or more, the JAX run's mesh, ``ep = 2``:
   the program of 1. with the bodies over ``ep``, one process a device
   (``dryrun_multihost.worker`` through ``distributed.launch``; ``gloo``
   where a card repeats), every rank's shards equal to one process's.

    python -m elodin_tpu_torch.parallel.dryrun 4                # 4 cards
    python -m elodin_tpu_torch.parallel.dryrun 8 --devices cpu  # 8 host shards
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.func import vmap

F9_TOL = 1e-13


def dryrun_multichip(n_devices: int, *, devices=None) -> dict:
    """Run the three programs on ``make_mesh(n_devices, devices=devices)``;
    raises on the first check that fails.  Returns the mesh's shape, the
    falcon9 run's stop tick and its largest relative difference."""
    from ..examples.falcon9 import sim as f9
    from ..interop import campaign_columns_from_numpy
    from ..models import build_batched_sixdof
    from ..models.sixdof_batch import batched_sixdof_init
    from ..monte_carlo import BatchedCampaign
    from ..ops import sixdof_kernel as sk
    from ..six_dof import increment_sim_tick_system
    from ..system import Pipe, SystemBuilder, as_system
    from .mesh import make_mesh, sharded_step

    mesh = make_mesh(n_devices, devices=devices)
    dp = mesh.shape["dp"]

    # 1. the vmapped batched 6-dof, a few ticks, samples over dp
    n_bodies, n_samples = 4, 2 * dp
    world, system = build_batched_sixdof(n_bodies)
    meta, cols = world.snapshot()
    full = Pipe(increment_sim_tick_system, as_system(system))

    def one_tick(state):
        b = SystemBuilder(meta, dict(state))
        full.call(b)
        return b.cols

    vstep = vmap(one_tick)

    def train_step(state):
        for _ in range(4):
            state = vstep(state)
        return state

    batched = campaign_columns_from_numpy(
        {k: np.broadcast_to(v, (n_samples,) + v.shape).copy() for k, v in cols.items()},
        meta, "cpu")
    fn, placed = sharded_step(train_step, mesh, batched, sample_axis=True)
    out = fn(placed)
    tick = np.asarray(out["tick"])
    if not (tick == 4).all():
        raise AssertionError(f"tick != 4 after dry run: {tick}")
    if not np.isfinite(np.asarray(out["world_pos"])).all():
        raise AssertionError("non-finite state after dry run")
    print(f"dryrun_multichip ok: mesh dp={dp} ep={mesh.shape['ep']}, {n_samples} samples x "
          f"{n_bodies} bodies, 4 ticks, devices {[str(d) for d in mesh.devices.flat]}")

    # 2. the falcon9 campaign, sharded over the samples, through an early
    # stop at a segment boundary
    def campaign(use_mesh):
        w, s = f9.build(None)
        return BatchedCampaign(w, s, 2 * n_devices, {}, simulation_rate=f9.SIM_RATE_HZ,
                               mesh=mesh if use_mesh else None,
                               device=None if use_mesh else mesh.first_device)

    seg_prev = os.environ.get("ELODIN_MC_SEGMENT_TICKS")
    os.environ["ELODIN_MC_SEGMENT_TICKS"] = "2"
    try:
        def until(c):
            return c["tick"] >= 3

        sharded = campaign(True).run(8, until=until)
        unsharded = campaign(False).run(8, until=until)
    finally:
        if seg_prev is None:
            del os.environ["ELODIN_MC_SEGMENT_TICKS"]
        else:
            os.environ["ELODIN_MC_SEGMENT_TICKS"] = seg_prev
    if not sharded.ticks == unsharded.ticks == 4:
        raise AssertionError(f"early-stop boundary mismatch: sharded {sharded.ticks}, "
                             f"unsharded {unsharded.ticks}")
    if not np.isfinite(sharded.component("booster.world_pos")).all():
        raise AssertionError("non-finite falcon9 sharded state")
    worst = 0.0
    for k in unsharded.final:
        a, b = sharded.column(k), unsharded.column(k)
        np.testing.assert_allclose(a, b, rtol=F9_TOL, atol=0,
                                   err_msg=f"sharded != unsharded for {k}")
        if a.dtype.kind == "f":
            d = np.abs(a.astype(np.float64) - b)
            scale = np.abs(b.astype(np.float64))
            worst = max(worst, float((d[d > 0] / scale[d > 0]).max()) if (d > 0).any() else 0.0)
    print(f"dryrun falcon9 ok: {2 * n_devices} samples sharded over {n_devices} devices, "
          f"early-stopped at tick 4 of 8, state == single-device to {F9_TOL:g} rel "
          f"(largest {worst:.3g})")

    # 3. the whole-rollout kernel sharded over the bodies
    wp, wv, inert = batched_sixdof_init(200, seed=3)
    for dtype in (torch.float32, torch.float64):
        single = sk.sixdof_rollout(wp, wv, inert, 1 / 120.0, 10, device=mesh.first_device,
                                   dtype=dtype)
        shard = sk.sixdof_rollout_sharded(wp, wv, inert, 1 / 120.0, 10, mesh, dtype=dtype)
        for a, b in zip(shard, single):
            if not torch.equal(a, b):
                raise AssertionError(f"sharded rollout != single device ({dtype})")
    print(f"dryrun kernel ok: 200-body whole-rollout kernel sharded over {n_devices} devices "
          "== single-device bitwise (f32, f64)")
    out = {"mesh": mesh.shape, "falcon9_ticks": sharded.ticks, "falcon9_max_rel": worst}

    # 4. the JAX run's dp x ep mesh, one process a device
    if n_devices % 2 == 0 and n_devices >= 4:
        from .distributed import launch

        names = [str(d) for d in mesh.devices.flat]
        ranks = launch("elodin_tpu_torch.parallel.dryrun_multihost:worker",
                       [[d] for d in names], kwargs={"ep": 2}, timeout=300,
                       backend="gloo" if len(set(names)) < len(names) else None)
        if {tuple(sorted(r["mesh"].items())) for r in ranks} != {
                (("dp", n_devices // 2), ("ep", 2))}:
            raise AssertionError(f"dryrun ep: ranks' meshes {[r['mesh'] for r in ranks]}")
        print(f"dryrun ep ok: {n_devices} processes, mesh dp={n_devices // 2} ep=2, every "
              "rank's shards == one process")
        out["ep_mesh"] = ranks[0]["mesh"]
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="The multi-device dry run")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--devices", default=None,
                    help="one device name repeated n_devices times (e.g. cpu, cuda:0); "
                         "default: the visible CUDA cards")
    a = ap.parse_args()
    dryrun_multichip(a.n_devices,
                     devices=[a.devices] * a.n_devices if a.devices else None)
