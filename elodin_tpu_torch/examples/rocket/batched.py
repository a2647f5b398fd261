"""The batched rocket: ``n`` copies of the rocket example advanced
together through ``monte_carlo.BatchedCampaign`` (the sample axis under
``torch.func.vmap``), as the JAX package's bench runs it with 1024 rockets
for 240 ticks.  No overrides: every sample starts from the same state.

    python -m elodin_tpu_torch.examples.rocket.batched N_ROCKETS TICKS --device cuda
"""

from __future__ import annotations

import json

import torch

from ...monte_carlo import BatchedCampaign
from .main import SIM_TIME_STEP, build_system, build_world


def make_campaign(n_rockets: int = 1024, device: str | torch.device = "cuda"):
    return BatchedCampaign(build_world(), build_system(), n_rockets, {},
                           simulation_rate=1.0 / SIM_TIME_STEP, device=device)


def run(n_rockets: int = 1024, ticks: int = 240,
        device: str | torch.device = "cuda") -> dict:
    """Entity-steps/s and the wall time of one campaign run."""
    result = make_campaign(n_rockets, device).run(ticks)
    return {
        "n_rockets": n_rockets,
        "ticks": ticks,
        "wall_s": result.wall_seconds,
        "entity_steps_per_sec": n_rockets * ticks / result.wall_seconds,
    }


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Batched rocket campaign")
    ap.add_argument("n_rockets", nargs="?", type=int, default=1024)
    ap.add_argument("ticks", nargs="?", type=int, default=240)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(json.dumps(run(a.n_rockets, a.ticks, a.device), indent=2))
