"""N-body at scale: thousands of gravitating bodies in one world, in torch
(counterpart of ``examples/n-body/batched.py``).  The world of
``models.nbody.build_nbody`` steps through the canonical tick
(``system.build_step``) with all-pairs gravity on the hand-written kernel
(``ops.pairwise``, one launch a tick) or, with ``use_kernel=False``, on the
dense edge fold.  The tick loop is eager: a warm pass, then a timed pass
of ``ticks`` ticks each, the clock stopped after the card has finished.

    python -m elodin_tpu_torch.examples.n_body.batched [N_BODIES] [TICKS] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ... import interop
from ...models.nbody import build_nbody, build_system
from ...ops import pairwise
from ...system import build_step

DT = 60.0


def setup(n_bodies: int, use_kernel: bool = True, dtype=np.float32,
          device: str | torch.device = "cuda"):
    """(step, state): the one-tick step of ``build_nbody(n_bodies, seed=2)``
    and its columns on ``device``, every float column at ``dtype``."""
    world = build_nbody(n_bodies, seed=2, dtype=dtype)
    world.set_sim_time_step(DT)
    meta, cols = world.snapshot()
    # the canonical tick composition: a hand-rolled one could diverge
    step = build_step(meta, build_system(DT, use_kernel=use_kernel))
    tdtype = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype
    state = {k: v.to(tdtype) if v.is_floating_point() else v
             for k, v in interop.columns_from_numpy(cols, meta, device).items()}
    return step, state


def advance(step, state, ticks: int) -> dict:
    """``ticks`` eager ticks of ``step`` from ``state``."""
    for _ in range(ticks):
        state = step(state)
    return state


def run(n_bodies: int, ticks: int, use_kernel: bool = True, dtype=np.float32,
        device: str | torch.device = "cuda", stats: dict | None = None) -> dict:
    """The JAX example's run: ``ticks`` warm ticks, then ``ticks`` timed
    ticks, and the total momentum's drift against the initial total.
    ``stats``, when given, receives the timed pass's kernel launches
    (``launches``) and the final columns as numpy (``final``)."""
    device = torch.device(device)
    step, state = setup(n_bodies, use_kernel, dtype, device)
    mass = state["inertia"][:, 6].cpu().numpy()
    p0 = (mass[:, None] * state["world_vel"][:, 3:].cpu().numpy()).sum(axis=0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    state = advance(step, state, ticks)  # warm
    sync()
    launches = pairwise.LAUNCHES
    t0 = time.perf_counter()
    state = advance(step, state, ticks)
    sync()
    wall = time.perf_counter() - t0
    launches = pairwise.LAUNCHES - launches
    pos = state["world_pos"].cpu().numpy()
    if not np.isfinite(pos).all():
        raise AssertionError("n-body positions are not finite")

    # physics sanity: total momentum is conserved by pair-force symmetry
    # (drift measured against the initial total, which is itself nonzero)
    vel = state["world_vel"][:, 3:].cpu().numpy()
    p = (mass[:, None] * vel).sum(axis=0) - p0
    p_scale = float(np.abs(mass[:, None] * vel).sum())
    if stats is not None:
        stats["launches"] = launches
        stats["final"] = {k: v.cpu().numpy() for k, v in state.items()}
    return {
        "n_bodies": n_bodies,
        "ticks": ticks,
        "wall_s": round(wall, 4),
        "pairs_per_sec": round(n_bodies * n_bodies * ticks / wall, 1),
        "entity_steps_per_sec": round(n_bodies * ticks / wall, 1),
        "momentum_drift_rel": float(np.abs(p).max() / max(p_scale, 1e-30)),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_bodies", type=int, nargs="?", default=8192)
    ap.add_argument("ticks", type=int, nargs="?", default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(json.dumps(run(args.n_bodies, args.ticks, device=args.device)))
