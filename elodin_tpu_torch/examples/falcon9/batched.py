"""Dispersed falcon9 RTLS campaign on one torch device (counterpart of
``examples/falcon9/batched.py``): N missions with Latin-hypercube draws of
the five dispersions, scored on the touchdown state.

    python -m elodin_tpu_torch.examples.falcon9.batched N_SAMPLES TICKS --device cuda
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ...monte_carlo import BatchedCampaign, sample_plan, write_artifacts
from .constants import (
    FIN_MAX_RAD,
    STAGE1_DRY_MASS_KG,
    STAGE1_LENGTH_M,
    TOUCHDOWN_SOFT_LATERAL_MPS,
    TOUCHDOWN_SOFT_TILT_DEG,
    TOUCHDOWN_SOFT_VERTICAL_MPS,
    TVC_MAX_RAD,
)
from .sim import (  # noqa: F401  (GUIDANCE_EVERY_TICKS for callers)
    DEFAULT_MAX_TICKS,
    DOWN,
    GUIDANCE_EVERY_TICKS,
    PARAMS,
    RCS_DEADBAND_RATE_RADPS,
    SIM_RATE_HZ,
    build,
)

HISTORY_COMPONENTS = ["booster.world_pos", "booster.world_vel", "booster.phase",
                      "booster.prop_kg"]


def dispersions(n_samples: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The LHS draws of every dispersed parameter, uniform over its range."""
    variables = {name: {"dist": "uniform", "min": p.min, "max": p.max}
                 for name, p in PARAMS.items()}
    return sample_plan(variables, n_samples, method="lhs", seed=seed)


def overrides_of(draws: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The campaign's per-sample overrides from the draws.  No inertia
    override: mass_props recomputes the stack inertia from the dispersed
    dry mass before the first integration."""
    n = len(draws["thrust_eff"])
    return {
        "booster.thrust_eff": draws["thrust_eff"],
        "booster.dry_mass": draws["dry_mass"],
        "booster.cd_descent": draws["cd_descent"],
        "booster.wind": np.stack([draws["wind_e"], draws["wind_n"], np.zeros(n)], axis=1),
    }


def make_campaign(n_samples: int, seed: int = 0, device: str | torch.device = "cuda"):
    """(campaign, draws): the mission without sensors, which are pure
    observers (the physics and flight software are the same)."""
    draws = dispersions(n_samples, seed)
    world, system = build(None, sensors=False)
    return BatchedCampaign(world, system, n_samples, overrides_of(draws),
                           simulation_rate=SIM_RATE_HZ, device=device), draws


def until_down(cols):
    """Terminal early stop: once every sample has latched DOWN the booster
    is frozen, so the remaining ticks are exact no-ops."""
    return cols["phase"] == DOWN


def scores(result) -> dict[str, np.ndarray]:
    """Touchdown scores against the declared envelope (constants.py)."""
    vz = result.component("booster.touchdown_vz")
    vlat = result.component("booster.touchdown_vlat")
    tilt = result.component("booster.touchdown_tilt")
    miss = result.component("booster.miss_distance")
    landed = miss >= 0.0
    soft = (landed & (vz > -TOUCHDOWN_SOFT_VERTICAL_MPS)
            & (vlat < TOUCHDOWN_SOFT_LATERAL_MPS) & (tilt < TOUCHDOWN_SOFT_TILT_DEG))
    return {"touchdown_vz": vz, "touchdown_vlat": vlat, "touchdown_tilt": tilt,
            "miss_distance": miss, "landed": landed, "soft": soft,
            "precise": soft & (miss < 50.0)}


# The scale below which a channel holds only round-off of the attitude
# loop.  While the commanded and the actual attitude agree (on the pad and
# in the vertical rise before the pitch kick at 7 s) the attitude error is
# a cancellation of two unit vectors, ~1e-16 rad, which two packages (or
# two devices) round their own ways; every rate, torque and deflection made
# from it carries that residue at ~1e-9 of its unit.  ``state_errors``
# measures such a channel against the larger of its largest value and this
# scale: the RCS rate deadband for rates and its rate of change per second
# for angular acceleration, that acceleration on the dry stage's transverse
# inertia for torque, each actuator's full travel for its commands.
_ANGULAR_ACCEL_FLOOR = RCS_DEADBAND_RATE_RADPS  # rad/s^2
SCALE_FLOORS = {
    ("world_vel", "angular"): RCS_DEADBAND_RATE_RADPS,
    ("world_accel", "angular"): _ANGULAR_ACCEL_FLOOR,
    ("force", "angular"): _ANGULAR_ACCEL_FLOOR * STAGE1_DRY_MASS_KG * STAGE1_LENGTH_M**2 / 12.0,
    ("tvc_cmd", "all"): TVC_MAX_RAD,
    ("tvc_state", "all"): TVC_MAX_RAD,
    ("fin_cmd", "all"): FIN_MAX_RAD,
    ("fin_state", "all"): FIN_MAX_RAD,
    ("rcs_cmd", "all"): 1.0,
    ("rcs_state", "all"): 1.0,
}
_GROUPS = {7: (("quaternion", slice(0, 4)), ("translation", slice(4, 7))),
           6: (("angular", slice(0, 3)), ("linear", slice(3, 6)))}


def state_errors(ours: dict, ref: dict) -> dict[str, float]:
    """max |Δ| / max(max |ref|, floor) of every float column of two
    campaign states (numpy, same shapes), per channel group: a (..., 7)
    transform is quaternion + translation, a (..., 6) motion or force
    angular + linear, any other column one group; the floor is
    ``SCALE_FLOORS``' entry or 0.  Keys are 'column.group'."""
    out = {}
    for name, r in ref.items():
        r = np.asarray(r)
        if r.dtype.kind != "f":
            continue
        o = np.asarray(ours[name], dtype=np.float64)
        r = r.astype(np.float64)
        groups = _GROUPS.get(r.shape[-1], ()) if name in ("world_pos", "world_vel",
                                                           "world_accel", "force") else ()
        for group, idx in groups or (("all", slice(None)),):
            d = float(np.abs(o[..., idx] - r[..., idx]).max())
            scale = max(float(np.abs(r[..., idx]).max()), SCALE_FLOORS.get((name, group), 0.0))
            out[f"{name}.{group}"] = d / scale if scale > 0.0 else d
    return out


def run_campaign(n_samples: int, ticks: int = DEFAULT_MAX_TICKS, seed: int = 0,
                 device: str | torch.device = "cuda", out_dir=None,
                 history_every: int = 0) -> dict:
    campaign, draws = make_campaign(n_samples, seed, device)
    result = campaign.run(ticks, history_every=history_every,
                          history_components=HISTORY_COMPONENTS if history_every else None,
                          until=until_down)
    s = scores(result)
    landed, miss, vz = s["landed"], s["miss_distance"], s["touchdown_vz"]
    if out_dir is not None:
        write_artifacts(result, out_dir, draws=draws, scores={
            "touchdown_vz": vz, "touchdown_vlat": s["touchdown_vlat"],
            "miss_distance": miss, "soft": s["soft"], "valid": landed})
    return {
        "n_samples": n_samples,
        "ticks": result.ticks,  # ticks advanced (early-stop aware)
        "ticks_requested": ticks,
        "wall_s": result.wall_seconds,
        "rollouts_per_s": result.rollouts_per_second,
        "landed_frac": float(landed.mean()),
        "soft_landing_frac": float(s["soft"].mean()),
        "precision_landing_frac": float(s["precise"].mean()),
        "mean_touchdown_vz": float(vz[landed].mean()) if landed.any() else None,
        "median_miss_m": float(np.percentile(miss[landed], 50)) if landed.any() else None,
        "p95_miss_m": float(np.percentile(miss[landed], 95)) if landed.any() else None,
    }


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Batched falcon9 landing campaign")
    ap.add_argument("n_samples", nargs="?", type=int, default=256)
    ap.add_argument("ticks", nargs="?", type=int, default=DEFAULT_MAX_TICKS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="artifact output directory")
    ap.add_argument("--traj-every", type=int, default=0,
                    help="record decimated trajectories every K ticks")
    a = ap.parse_args()
    print(json.dumps(run_campaign(a.n_samples, a.ticks, device=a.device, out_dir=a.out,
                                  history_every=a.traj_every), indent=2))
