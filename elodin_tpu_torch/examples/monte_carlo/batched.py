"""Dispersed landing campaign on one torch device, or with the samples cut
over a mesh (counterpart of ``examples/monte-carlo/batched.py``): N
landings with Latin-hypercube draws of the five parameters, advanced
together through ``monte_carlo.BatchedCampaign`` and scored on the
touchdown velocity.

    python -m elodin_tpu_torch.examples.monte_carlo.batched N_SAMPLES TICKS --device cuda
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ...monte_carlo import BatchedCampaign, sample_plan
from .sim import DEFAULT_MAX_TICKS, PARAMS, PROPELLANT0_KG, SIMULATION_RATE_HZ, build


def dispersions(n_samples: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The LHS draws of every dispersed parameter, uniform over its range."""
    variables = {name: {"dist": "uniform", "min": p.min, "max": p.max}
                 for name, p in PARAMS.items() if p.min is not None}
    return sample_plan(variables, n_samples, method="lhs", seed=seed)


def overrides_of(draws: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The campaign's per-sample columns from the draws, as the JAX
    example writes them."""
    n = len(draws["start_altitude"])
    wet = draws["dry_mass"][:, None] + PROPELLANT0_KG
    return {
        "booster.world_pos": np.concatenate(
            [np.tile([0.0, 0.0, 0.0, 1.0, 0.0, 0.0], (n, 1)),
             draws["start_altitude"][:, None]], axis=1),
        "booster.world_vel": np.concatenate(
            [np.tile([0.0, 0.0, 0.0, 3.0, 0.0], (n, 1)), draws["start_vz"][:, None]], axis=1),
        "booster.wind": np.stack([draws["wind_x"], np.zeros(n), np.zeros(n)], axis=1),
        "booster.thrust_eff": draws["thrust_eff"],
        "booster.inertia": np.concatenate(
            [np.tile(wet, (1, 3)), np.zeros((n, 3)), wet], axis=1),
    }


def make_campaign(n_samples: int, seed: int = 0, device: str | torch.device | None = None,
                  mesh=None):
    """(campaign, draws) of ``n_samples`` landings from the template world
    with default parameters, on ``device`` (``"cuda"`` by default) or with
    the samples cut over ``mesh``."""
    draws = dispersions(n_samples, seed)
    world, system = build(None)
    return BatchedCampaign(world, system, n_samples, overrides_of(draws),
                           simulation_rate=SIMULATION_RATE_HZ, mesh=mesh,
                           device=device), draws


def scores(result) -> dict[str, np.ndarray]:
    """Per sample: the touchdown velocity, landed (touched down) and soft
    (landed above -5 m/s)."""
    touchdown_vz = result.component("booster.touchdown_vz")
    landed = touchdown_vz < 0.0
    return {"touchdown_vz": touchdown_vz, "landed": landed,
            "soft": np.logical_and(landed, touchdown_vz > -5.0)}


def outcome(result) -> dict:
    """The JAX example's outcome dict of a campaign run."""
    s = scores(result)
    landed, touchdown_vz = s["landed"], s["touchdown_vz"]
    final_pos = result.component("booster.world_pos")[:, 4:]
    return {
        "n_samples": result.n_samples,
        "ticks": result.ticks,
        "wall_s": result.wall_seconds,
        "rollouts_per_s": result.rollouts_per_second,
        "landed_frac": float(landed.mean()),
        "soft_landing_frac": float(s["soft"].mean()),
        "mean_touchdown_vz": float(touchdown_vz[landed].mean()) if landed.any() else None,
        "mean_landing_offset_m": float(
            np.linalg.norm(final_pos[landed][:, :2], axis=1).mean()) if landed.any() else None,
    }


def run_campaign(n_samples: int, ticks: int = DEFAULT_MAX_TICKS, seed: int = 0,
                 device: str | torch.device | None = None, mesh=None) -> dict:
    campaign, _ = make_campaign(n_samples, seed, device, mesh)
    return outcome(campaign.run(ticks))


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Batched landing-burn campaign")
    ap.add_argument("n_samples", nargs="?", type=int, default=1024)
    ap.add_argument("ticks", nargs="?", type=int, default=DEFAULT_MAX_TICKS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(json.dumps(run_campaign(a.n_samples, a.ticks, a.seed, a.device), indent=2))
