"""Calibration loop: rank -> narrow -> rerun, file-based and batched
(counterpart of ``elodin_tpu/monte_carlo/calibrate.py``, numpy only).

Parity target: the reference's calibration tooling
(examples/falcon9/calibrate.py:1-118) — rank campaign runs by a fit score,
then write a spec narrowed around the best run, keeping a fixed fraction of
every variable range per round.

Two frontends:

* **File-based** (`rank_runs` / `narrow_spec` + the CLI) operates on a
  process-campaign output directory (results.csv columns: ``param.<name>``
  draws and ``result.<key>`` scores) and narrowed TOML specs, exactly the
  reference workflow for sims that must run as OS processes.

* **Batched** (`Calibrator`) runs the same loop over a batched rollout:
  each round draws LHS points from the live ranges, rolls every draw out
  at once (typically this package's ``BatchedCampaign.run`` and a
  final-state metric, on one device), and narrows the ranges around the
  argmin.  The caller supplies ``rollout(draws) -> scores`` (lower is
  better).
"""

from __future__ import annotations

import csv
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np

from .sample import lhs_units, sample_dist

KEEP_FRACTION = 0.4  # per round, of every variable range (reference :23)


# -- file-based (process campaigns) -------------------------------------------


def _score_of(row: dict, score: str) -> float | None:
    raw = row.get(f"result.{score}", row.get(score))
    if raw in (None, ""):
        return None
    try:
        value = float(raw)
    except (TypeError, ValueError):
        return None
    # NaN keys make list.sort() produce an arbitrary order — a NaN-scored
    # run could rank "best" and become the narrowing center
    return value if math.isfinite(value) else None


def load_runs(out_dir: str | Path, score: str) -> list[tuple[str, float, dict]]:
    """(run_id, score, params) for every scored run, best first."""
    out_dir = Path(out_dir)
    path = out_dir / "results.csv"
    if not path.exists():
        raise FileNotFoundError(f"no results.csv in {out_dir}")
    runs = []
    for row in csv.DictReader(path.open()):
        s = _score_of(row, score)
        if s is None or row.get("valid", "True") in ("False", "false", "0"):
            continue
        params = {
            k.removeprefix("param."): float(v)
            for k, v in row.items()
            if k.startswith("param.") and v not in (None, "")
        }
        runs.append((row.get("run_id", "?"), s, params))
    runs.sort(key=lambda r: r[1])
    return runs


def rank_runs(out_dir: str | Path, score: str, top: int = 5) -> list[tuple[str, float, dict]]:
    runs = load_runs(out_dir, score)
    print(f"{len(runs)} scored runs; best {min(top, len(runs))} by {score}:")
    for run_id, s, _params in runs[:top]:
        print(f"  {run_id}  {score}={s:10.4g}")
    if runs:
        print("best-run params:")
        for k, v in sorted(runs[0][2].items()):
            print(f"  {k} = {v}")
    return runs


def narrow_variables(variables: dict[str, dict], best: dict[str, float],
                     keep_fraction: float = KEEP_FRACTION) -> dict[str, dict]:
    """Shrink each uniform range to ``keep_fraction`` of its width, centered
    on the best draw and clamped inside the original bounds."""
    out = {}
    for name, cfg in variables.items():
        lo, hi = float(cfg["min"]), float(cfg["max"])
        center = float(best.get(name, (lo + hi) / 2.0))
        half = (hi - lo) * keep_fraction / 2.0
        new_lo = max(lo, center - half)
        new_hi = min(hi, center + half)
        out[name] = {"dist": "uniform", "min": new_lo, "max": new_hi}
    return out


def narrow_spec(out_dir: str | Path, spec_path: str | Path,
                new_spec_path: str | Path, score: str,
                keep_fraction: float = KEEP_FRACTION) -> None:
    """Write a TOML spec narrowed around the best-scoring run."""
    import tomllib

    runs = load_runs(out_dir, score)
    if not runs:
        raise SystemExit("no scored runs to narrow around")
    best = runs[0][2]
    spec = tomllib.loads(Path(spec_path).read_text())
    mc = spec.get("monte_carlo", {})
    variables = mc.get("variables", {})
    lines = [
        "# Auto-narrowed by elodin_tpu_torch.monte_carlo.calibrate around the best run.",
        "",
        "[monte_carlo]",
        f"n_samples = {mc.get('n_samples', 24)}",
        f"seed = {mc.get('seed', 0)}",
        f'method = "{mc.get("method", "lhs")}"',
        "",
        "[monte_carlo.variables]",
    ]
    for name, cfg in narrow_variables(variables, best, keep_fraction).items():
        lines.append(
            f'{name} = {{ dist = "uniform", min = {cfg["min"]}, max = {cfg["max"]} }}'
        )
    Path(new_spec_path).write_text("\n".join(lines) + "\n")
    print(f"wrote {new_spec_path} (kept {keep_fraction:.0%} of each range)")


# -- batched campaigns ----------------------------------------------------------


@dataclass
class CalibRound:
    variables: dict[str, dict]
    best_params: dict[str, float]
    best_score: float
    scores: np.ndarray


@dataclass
class CalibResult:
    rounds: list[CalibRound] = field(default_factory=list)

    @property
    def best_params(self) -> dict[str, float]:
        r = min(self.rounds, key=lambda r: r.best_score)
        return r.best_params

    @property
    def best_score(self) -> float:
        return min(r.best_score for r in self.rounds)


class Calibrator:
    """Iterative narrow-around-best calibration over a batched rollout.

    Each round draws ``n_samples`` LHS points from the live ranges, calls
    ``rollout(draws)`` (draws: dict name -> (n,) float64; returns (n,)
    scores, lower = better), then shrinks every range to ``keep_fraction``
    of its width around the argmin.  The LHS RNG is seeded once, so rounds
    are deterministic given (seed, rounds, n_samples) — the reference's
    fixed-seed iteration discipline (calibrate.py:8-9)."""

    def __init__(self, variables: dict[str, dict],
                 keep_fraction: float = KEEP_FRACTION, seed: int = 0):
        for name, cfg in variables.items():
            if "min" not in cfg or "max" not in cfg:
                raise ValueError(f"variable {name!r} needs min/max bounds")
        self.variables = {
            n: {"dist": str(c.get("dist", "uniform")), "min": float(c["min"]),
                "max": float(c["max"])}
            for n, c in variables.items()
        }
        self.keep_fraction = float(keep_fraction)
        self.rng = np.random.default_rng(seed)

    def draws(self, n_samples: int, variables=None) -> dict[str, np.ndarray]:
        variables = variables or self.variables
        names = list(variables)
        units = lhs_units(n_samples, len(names), self.rng)
        return {
            name: np.asarray(sample_dist(variables[name], units[:, j]), dtype=np.float64)
            for j, name in enumerate(names)
        }

    def run(self, rollout: Callable[[dict], np.ndarray], rounds: int = 3,
            n_samples: int = 64) -> CalibResult:
        result = CalibResult()
        live = dict(self.variables)
        for _ in range(int(rounds)):
            draws = self.draws(n_samples, live)
            scores = np.asarray(rollout(draws), dtype=np.float64).ravel()
            if scores.shape != (n_samples,):
                raise ValueError(
                    f"rollout returned shape {scores.shape}, want ({n_samples},)"
                )
            finite = np.where(np.isfinite(scores), scores, np.inf)
            best_i = int(np.argmin(finite))
            best = {name: float(v[best_i]) for name, v in draws.items()}
            result.rounds.append(
                CalibRound(dict(live), best, float(finite[best_i]), scores)
            )
            live = narrow_variables(live, best, self.keep_fraction)
        return result


def main(argv: list[str] | None = None) -> None:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    usage = (
        "usage: python -m elodin_tpu_torch.monte_carlo.calibrate rank <out_dir> <score>\n"
        "       python -m elodin_tpu_torch.monte_carlo.calibrate narrow <out_dir> "
        "<spec.toml> <new_spec.toml> <score>"
    )
    if not argv:
        raise SystemExit(usage)
    cmd = argv[0]
    if cmd == "rank" and len(argv) >= 3:
        rank_runs(argv[1], argv[2])
    elif cmd == "narrow" and len(argv) >= 5:
        narrow_spec(argv[1], argv[2], argv[3], argv[4])
    elif cmd == "best-json" and len(argv) >= 3:
        runs = load_runs(argv[1], argv[2])
        if not runs:
            raise SystemExit("no scored runs")
        print(json.dumps(runs[0][2]))
    else:
        raise SystemExit(usage)


if __name__ == "__main__":
    main()
