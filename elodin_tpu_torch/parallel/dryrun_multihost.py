"""The multi-process dry run (counterpart of ``scripts/dryrun_multihost.py``):
processes joined by ``init_multihost`` over ``torch.distributed``, each
stepping 4 ticks of the vmapped batched 6-dof over the global mesh, its
addressable shards held bitwise against the single-process run.

    python -m elodin_tpu_torch.parallel.dryrun_multihost               # the cards
    python -m elodin_tpu_torch.parallel.dryrun_multihost --device cpu  # the host
    python -m elodin_tpu_torch.parallel.dryrun_multihost --processes 2 \\
        --devices-per-process 1 --ep 2 --device cuda:0 --backend gloo

With no arguments it runs on the visible cards: one rank a card over nccl
(two ranks sharing the card over gloo when there is one), samples over
``dp`` across the ranks, then the bodies over ``ep = 2``.  ``--device
cpu`` runs the three forms on the host (gloo): 2 processes x 4 devices,
samples over ``dp`` across the process boundary (the JAX gate's); 2 x 1
with the bodies over ``ep = 2``; 4 x 1 as ``dp = 2`` x ``ep = 2``.
``launch`` picks a free port for each (the JAX script's fixed 19457 would
collide between test workers).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

TICKS = 4


def worker(ep: int = 1) -> dict:
    """One rank: the batched 6-dof step over ``make_mesh(ep=ep)`` (every
    rank's devices), checked against this rank's single-process run;
    returns the mesh and what was checked."""
    from torch.func import vmap

    from ..interop import campaign_columns_from_numpy
    from ..models import build_batched_sixdof
    from ..six_dof import increment_sim_tick_system
    from ..system import Pipe, SystemBuilder, as_system
    from . import distributed
    from .mesh import make_mesh, sharded_step

    job = distributed.process()
    mesh = make_mesh(ep=ep)
    dp, ep = mesh.shape["dp"], mesh.shape["ep"]
    n_bodies, n_samples = 4 * ep, 2 * dp
    world, system = build_batched_sixdof(n_bodies)
    meta, cols = world.snapshot()
    full = Pipe(increment_sim_tick_system, as_system(system))

    def one_tick(state):
        b = SystemBuilder(meta, dict(state))
        full.call(b)
        return b.cols

    vstep = vmap(one_tick)

    def train_step(state):
        for _ in range(TICKS):
            state = vstep(state)
        return state

    batched = campaign_columns_from_numpy(
        {k: np.broadcast_to(v, (n_samples,) + v.shape).copy() for k, v in cols.items()},
        meta, "cpu")
    fn, placed = sharded_step(train_step, mesh, batched, sample_axis=True)
    out = fn(placed)
    device = job.devices[0]
    ref = {k: v.cpu() for k, v in train_step({k: v.to(device) for k, v in batched.items()}).items()}
    shards = 0
    for name, col in out.items():
        for shard in col.addressable_shards:
            if not torch.equal(shard.data.cpu(), ref[name][shard.index]):
                raise AssertionError(f"rank {job.rank}: shard {shard.index} of {name} != the "
                                     "single-process run")
            shards += 1
    tick = out["tick"].addressable_shards[0].data
    if not (tick == TICKS).all():
        raise AssertionError(f"tick != {TICKS} after the dry run: {tick}")
    if job.rank == 0:
        print(f"dryrun_multihost ok: {job.world_size} processes x {len(job.devices)} "
              f"devices ({job.backend}), dp={dp} ep={ep}, {n_samples} samples x {n_bodies} "
              f"bodies, {TICKS} ticks, every addressable shard == single process", flush=True)
    return {"mesh": mesh.shape, "rank": job.rank, "shards": shards,
            "devices": [str(d) for d in job.devices]}


def launch(num_processes: int = 2, devices_per_process: int = 1, ep: int = 1,
           device: str | None = None, backend: str | None = None) -> list:
    """The dry run over ``num_processes`` new processes, each with
    ``devices_per_process`` entries of its device; returns each rank's
    result.  ``device`` None: the visible cards, rank k on card k modulo
    their count, over gloo when ranks share a card (NCCL refuses that) and
    ``backend`` is not given; raises when no card is visible.  Otherwise
    every rank on ``device`` (``"cpu"``: the host)."""
    from .distributed import launch as run

    if device is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("dryrun_multihost: no CUDA card is visible; pass "
                               "device='cpu' (--device cpu) for the host")
        names = [f"cuda:{k % count}" for k in range(num_processes)]
        if backend is None and count < num_processes:
            backend = "gloo"
    else:
        names = [device] * num_processes
    return run("elodin_tpu_torch.parallel.dryrun_multihost:worker",
               [[d] * devices_per_process for d in names],
               backend=backend, kwargs={"ep": ep}, timeout=300)


# the forms with --device cpu and no --processes: (processes, devices a
# process, ep)
CPU_FORMS = ((2, 4, 1), (2, 1, 2), (4, 1, 2))


def card_forms() -> tuple:
    """The forms on the visible cards: a rank a card (two on one card), ``dp``
    across them, then ``ep = 2`` when the ranks are even."""
    processes = max(torch.cuda.device_count(), 2)
    return ((processes, 1, 1),) + (((processes, 1, 2),) if processes % 2 == 0 else ())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="The multi-process dry run")
    ap.add_argument("--processes", type=int)
    ap.add_argument("--devices-per-process", type=int, default=1)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="every rank's device (default: the visible cards, one a rank)")
    ap.add_argument("--backend", default=None)
    a = ap.parse_args(argv)
    if a.processes is not None:
        forms = ((a.processes, a.devices_per_process, a.ep),)
    else:
        forms = CPU_FORMS if a.device == "cpu" else card_forms()
    for processes, per, ep in forms:
        launch(processes, per, ep, a.device, a.backend)


if __name__ == "__main__":
    main()
