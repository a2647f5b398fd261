#!/usr/bin/env python3
"""Time one tick of the n-body fold world's step (``models/nbody.py``,
``use_kernel=False``: the ``GraphQuery[TotalEdge]`` dense fold, f64) on one
CUDA card, untraced, beside an older checkout.

Run from the root of a checkout, on a machine with a card:

    git archive REV | tar -x -C build/parent
    python3 scripts/fold_tick_timing.py [--parent build/parent] [--bodies 8192]

Each tree runs in a process of its own (with ``--parent``: parent, change,
change, parent).  After three warm-up ticks it reads, over 20 ticks each
started from an idle card, the host's time to issue the step (its return,
no synchronize) and the tick's wall to the end of its device work; then
the steady ms a tick of 50 ticks back to back, ended by a synchronize.
Over 5 ticks under ``torch.profiler`` it counts the CUDA runtime's
``cudaStreamSynchronize``, ``cudaMemcpyAsync`` and ``cudaLaunchKernel``
calls, and over 5 more the operations ``torch.cuda.set_sync_debug_mode``
flags.  The last line of each run is one JSON object, with a hash of the
state after every tick, which two trees with the same arithmetic share.
The card's name and power limit head the output.
"""

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

SEED, WARM, SINGLE, STEADY, COUNTED = 7, 3, 20, 50, 5


def one(bodies: int) -> dict:
    """This tree's readings; its root is the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    import elodin_tpu_torch as el
    from elodin_tpu_torch import interop
    from elodin_tpu_torch.models import nbody
    from elodin_tpu_torch.system import build_step

    el.set_float_policy("f64")
    world = nbody.build_nbody(bodies, seed=SEED)
    world.set_sim_time_step(60.0)
    meta, cols = world.snapshot()
    step = build_step(meta, nbody.build_system(60.0, use_kernel=False))
    state = interop.columns_from_numpy(cols, meta, "cuda")
    for _ in range(WARM):
        state = step(state)
    host, wall = [], []
    for _ in range(SINGLE):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = step(state)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(STEADY):
        state = step(state)
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) * 1e3 / STEADY
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(COUNTED):
            state = step(state)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(COUNTED):
                state = step(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    flagged = sum("synchroniz" in str(w.message) and "debug mode" not in str(w.message)
                  for w in caught)
    digest = hashlib.sha256(b"".join(state[k].cpu().numpy().tobytes()
                                     for k in ("world_pos", "world_vel", "force")))
    ticks = WARM + SINGLE + STEADY + 2 * COUNTED
    return {"tree": os.getcwd(), "bodies": bodies, "ticks": ticks,
            "host_issue_ms_median": statistics.median(host), "host_issue_ms_min": min(host),
            "tick_wall_ms_median": statistics.median(wall), "steady_ms_per_tick": steady,
            **{f"{n}_per_tick": names.count(n) / COUNTED
               for n in ("cudaStreamSynchronize", "cudaMemcpyAsync", "cudaLaunchKernel")},
            "flagged_syncs_per_tick": flagged / COUNTED,
            "state_sha256": digest.hexdigest()[:16]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", help="the root of an older checkout")
    p.add_argument("--bodies", type=int, default=8192)
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one:
        print(json.dumps(one(args.bodies)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"gpu: {smi}", flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = [here] if args.parent is None else [args.parent, here, here, args.parent]
    rows = []
    for tree in trees:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                              "--bodies", str(args.bodies)], cwd=os.path.abspath(tree),
                             capture_output=True, text=True, check=True).stdout
        rows.append(json.loads(out.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    if len({r["state_sha256"] for r in rows}) != 1:
        print("the trees' states differ", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
