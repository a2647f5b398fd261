"""The cube-sat stepped from Python through ``World.to_jax`` / ``TorchSim``
(counterpart of ``examples/cube-sat-pysim/main.py``): a functional state
dict, chunks of eager ticks, direct column reads; no database and no run
loop.  The JAX example's source runs as is on the port's ``to_jax``, the
alias of ``World.to_torch``; here it takes the device as well.

    python -m elodin_tpu_torch.examples.cube_sat_pysim.main [--device cpu]

prints the detumble trace.
"""

import argparse
import sys

import numpy as np

from ..cube_sat.main import build_system, build_world

CHUNK = 400
CHUNKS = 6


def run(chunk: int = CHUNK, chunks: int = CHUNKS, device="cuda"):
    """``chunks`` chunks of ``chunk`` ticks; the angular speed after each.
    (The JAX example's ``run`` also checks the detumbling; here ``main``
    does, so that a shorter run can be held against it.)"""
    sim = build_world().to_jax(build_system(), device=device)
    omegas = []
    for _ in range(chunks):
        sim.step(chunk)
        vel = sim.get_state("world_vel", "ore_sat").cpu().numpy()
        omegas.append(float(np.linalg.norm(vel[:3])))
    print("angular speed trace (rad/s):", [f"{o:.4f}" for o in omegas])
    return omegas


def main(argv):
    ap = argparse.ArgumentParser(description="Step the cube-sat through TorchSim")
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--chunks", type=int, default=CHUNKS)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    omegas = run(a.chunk, a.chunks, a.device)
    if not omegas[-1] < omegas[0] * 0.9:
        raise SystemExit("cube-sat should be detumbling")


if __name__ == "__main__":
    main(sys.argv[1:])
