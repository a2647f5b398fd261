"""Plan sampling: LHS / random over distribution specs.

A copy of ``elodin_tpu/monte_carlo/sample.py``, which needs no JAX but
cannot be imported without it (importing ``elodin_tpu.monte_carlo`` runs
``elodin_tpu/__init__.py``).  Same numpy code, so the same seed draws the
same plan bit for bit in both packages.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path

import numpy as np

KNOWN_DISTS = ("fixed", "choice", "uniform", "loguniform", "normal")
_MIN_ALIASES = ("min", "lo", "low")
_MAX_ALIASES = ("max", "hi", "high")


def _bound(spec: dict, aliases) -> float | None:
    for a in aliases:
        if a in spec:
            return spec[a]
    return None


def validate_variable(name: str, spec) -> None:
    if not isinstance(spec, dict):
        raise ValueError(
            f'variable "{name}" must be a table like {{"dist": "normal", ...}}'
        )
    dist = str(spec.get("dist", "fixed")).lower()
    if dist not in KNOWN_DISTS:
        raise ValueError(f'unknown dist "{dist}" for "{name}"')
    if dist == "fixed" and "value" not in spec:
        raise ValueError(f'fixed for "{name}" needs value')
    if dist == "choice" and not spec.get("values"):
        raise ValueError(f'choice for "{name}" needs a non-empty values list')
    if dist in ("uniform", "loguniform"):
        if _bound(spec, _MIN_ALIASES) is None or _bound(spec, _MAX_ALIASES) is None:
            raise ValueError(f'{dist} for "{name}" needs min/max')
        if dist == "loguniform" and (
            float(_bound(spec, _MIN_ALIASES)) <= 0
            or float(_bound(spec, _MAX_ALIASES)) <= 0
        ):
            raise ValueError(f'loguniform for "{name}" needs positive min/max')
    if dist == "normal" and ("mean" not in spec or "std" not in spec):
        raise ValueError(f'normal for "{name}" needs mean/std')


def sample_dist(spec: dict, u):
    """Map a uniform [0,1) draw through a distribution spec; vectorized."""
    u = np.asarray(u)
    dist = str(spec.get("dist", "fixed")).lower()
    if dist == "fixed":
        return np.broadcast_to(np.asarray(spec.get("value")), u.shape).copy()
    if dist == "choice":
        values = np.asarray(spec["values"])
        idx = np.minimum((u * len(values)).astype(int), len(values) - 1)
        return values[idx]
    if dist == "uniform":
        lo = float(_bound(spec, _MIN_ALIASES))
        hi = float(_bound(spec, _MAX_ALIASES))
        return lo + (hi - lo) * u
    if dist == "loguniform":
        lo = math.log(float(_bound(spec, _MIN_ALIASES)))
        hi = math.log(float(_bound(spec, _MAX_ALIASES)))
        return np.exp(lo + (hi - lo) * u)
    if dist == "normal":
        # branch-local: scipy is only needed for the inverse normal CDF —
        # uniform/choice/fixed campaigns must not require it
        from scipy.special import ndtri

        mean = float(spec["mean"])
        std = float(spec["std"])
        return mean + std * ndtri(np.clip(u, 1e-12, 1 - 1e-12))
    raise ValueError(f"unsupported distribution: {dist}")


def lhs_units(n: int, d: int, rng: np.random.Generator) -> np.ndarray:
    """Latin-hypercube stratified uniforms, shape (n, d)
    (python/elodin/monte_carlo/sample.py:84-111)."""
    out = np.empty((n, d))
    for col in range(d):
        vals = (np.arange(n) + rng.random(n)) / n
        rng.shuffle(vals)
        out[:, col] = vals
    return out


def sample_plan(variables: dict[str, dict], n: int, method: str = "lhs",
                seed=None) -> dict[str, np.ndarray]:
    """Sample n rows for each variable; returns name -> (n,) array."""
    for name, spec in variables.items():
        validate_variable(name, spec)
    keys = sorted(variables)
    rng = np.random.default_rng(seed)
    if method == "lhs":
        units = lhs_units(n, len(keys), rng)
    elif method == "random":
        units = rng.random((n, len(keys)))
    else:
        raise ValueError(f'unknown method "{method}" (known: lhs, random)')
    return {
        k: sample_dist(variables[k], units[:, i]) for i, k in enumerate(keys)
    }


def materialize_plan(config: dict, out_path: str | Path | None = None) -> list[dict]:
    """Materialize a campaign config into plan rows (run_id/seed/param.*),
    optionally writing plan.csv."""
    mc = config.get("monte_carlo", {})
    n = int(mc.get("n_samples", 1))
    if n < 1:
        raise ValueError(f"n_samples must be >= 1 (got {n})")
    variables = dict(mc.get("variables", {}))
    cols = sample_plan(
        variables, n, str(mc.get("method", "lhs")).lower(), mc.get("seed")
    )
    base_seed = int(mc.get("seed") or 0)
    rows = []
    for i in range(n):
        row = {"run_id": f"{i:06d}", "seed": base_seed + i}
        for k, v in cols.items():
            row[f"param.{k}"] = v[i].item() if hasattr(v[i], "item") else v[i]
        rows.append(row)
    if out_path is not None:
        out_path = Path(out_path)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        with open(out_path, "w", newline="") as f:
            fieldnames = list(rows[0].keys()) if rows else ["run_id", "seed"]
            w = csv.DictWriter(f, fieldnames=fieldnames)
            w.writeheader()
            w.writerows(rows)
    return rows
