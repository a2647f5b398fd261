"""The telemetry regression gate for the port's examples: run an example
for ``TICKS`` ticks, export every 'entity.component' series to CSV
(``Exec.save_archive``) and hold each against a stored baseline
(``scripts/baseline/<example>``, or the re-export of ``REEXPORTED``) at
per-column tolerances (``scripts/baseline/tolerances.json``).

A cell of a vector or matrix component is a list (``[0.0, 1.0, ...]``);
the reader parses it and compares it element by element, so vector
columns such as ``world_pos`` are held as tightly as scalar ones.  An
element passes when it is within the absolute or the relative tolerance;
one side NaN where the other is a number fails, both NaN passes.  A
missing file or column, or a different row count, fails.

    python -m elodin_tpu_torch.regress [--device cuda] [EXAMPLE ...]
"""

from __future__ import annotations

import csv
import json
import math
import os
import re
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_ROOT = os.path.join(REPO, "scripts", "baseline")
# The drone's and the cube-sat's baselines under scripts/baseline predate
# the JAX examples' current form, and the JAX examples themselves fail them
# (the drone in scalar columns too, and it has a component the baseline
# lacks).  Their gate holds the port against the JAX package's own export
# of the current examples, ``scripts/export_example.py EXAMPLE 240 DIR``
# run on a CPU, stored here.
REEXPORTED_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline")
REEXPORTED = ("drone", "cube-sat")
DEFAULT_TOL = {"abs": 1e-4, "rel": 1e-4}
# the seven examples of ``scripts/regress.sh``, in its order
EXAMPLES = ("ball", "three-body", "stablehlo", "drone", "linalg", "rocket", "cube-sat")
DEFAULT_TIME_STEP = 1.0 / 120.0
# the stored baselines' length (``scripts/regress.sh``): 241 rows, tick 0
# and 240 ticks at 120 Hz
TICKS = 240


def baselined_examples() -> dict:
    """Example name (as under ``scripts/baseline``) -> its module with
    ``build_world`` and ``build_system``."""
    from .examples.ball import sim as ball
    from .examples.cube_sat import main as cube_sat
    from .examples.drone import main as drone
    from .examples.linalg import main as linalg
    from .examples.rocket import main as rocket
    from .examples.stablehlo import sim as stablehlo
    from .examples.three_body import main as three_body

    return {"ball": ball, "three-body": three_body, "stablehlo": stablehlo, "drone": drone,
            "linalg": linalg, "rocket": rocket, "cube-sat": cube_sat}


def simulation_rate(mod) -> float:
    """The rate the stored baselines ran an example at: ``1 /
    SIM_TIME_STEP``, or 120 Hz for a module without one (the drone, the
    stablehlo probe), as ``scripts/export_example.py`` runs it."""
    return 1.0 / getattr(mod, "SIM_TIME_STEP", DEFAULT_TIME_STEP)


def baseline_dir(example: str) -> str:
    """The directory of an example's stored baseline CSV files."""
    return os.path.join(REEXPORTED_ROOT if example in REEXPORTED else BASELINE_ROOT, example)


def _cell(text: str):
    """A CSV cell as a float, or as an array when it holds a list; any
    other text (the time column) as NaN."""
    try:
        return float(text)
    except ValueError:
        pass
    if text.startswith("["):
        text = re.sub(r"\bnan\b", "NaN", text)
        text = re.sub(r"(-?)\binf\b", r"\1Infinity", text)
        return np.asarray(json.loads(text), dtype=np.float64)
    return float("nan")


def load_csv(path) -> dict[str, list]:
    """{column: [cell, ...]} of one exported CSV file."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, data = rows[0], rows[1:]
    cols = {h: [] for h in header}
    for row in data:
        for h, v in zip(header, row):
            cols[h].append(_cell(v))
    return cols


def load_tolerances(path=None) -> dict:
    """The tolerance file deep-merged over the default: ``value`` is the
    global tolerance, any other key a column's own."""
    tol = {"value": dict(DEFAULT_TOL)}
    if path and os.path.exists(path):
        with open(path) as f:
            for k, v in json.load(f).items():
                merged = dict(tol.get(k) or tol["value"])
                merged.update(v if isinstance(v, dict) else {})
                tol[k] = merged
    return tol


def _cell_error(b, a, abs_tol: float, rel_tol: float) -> tuple[float, str | None]:
    """(share of the tolerance used, why the cell fails or None) of cell
    ``a`` against baseline cell ``b``: an element passes within
    ``abs_tol`` or within ``rel_tol`` of max(|a|, |b|), so its share is the
    smaller of the two ratios; the cell's is its largest element's."""
    b, a = np.asarray(b, dtype=np.float64), np.asarray(a, dtype=np.float64)
    if b.shape != a.shape:
        return math.inf, f"shape {a.shape} vs baseline {b.shape}"
    b_nan, a_nan = np.isnan(b), np.isnan(a)
    if (b_nan != a_nan).any():
        return math.inf, f"{a.tolist()} vs baseline {b.tolist()} (NaN)"
    if b.size == 0:
        return 0.0, None
    with np.errstate(invalid="ignore", divide="ignore"):
        d = np.where(b_nan | (b == a), 0.0, np.abs(b - a))
        scale = np.maximum(np.abs(b), np.abs(a))
        share = float(np.max(np.fmin(d / abs_tol, d / (rel_tol * scale))))
    if share > 1.0:
        return share, f"{a.tolist()} vs baseline {b.tolist()} (abs {float(d.max()):.3e})"
    return share, None


def compare(baseline_dir, actual_dir, tolerances=None) -> tuple[int, list[str], float]:
    """(files compared, failures, the largest share of its tolerance any
    element used) of every baselined CSV against its export in
    ``actual_dir``; ``tolerances`` is ``load_tolerances``' dict."""
    tol = tolerances or load_tolerances(None)
    baselines = sorted(f for f in os.listdir(baseline_dir) if f.endswith(".csv"))
    if not baselines:
        return 0, [f"no baselines stored in {baseline_dir}"], math.inf
    failures, worst = [], 0.0
    for fname in baselines:
        actual_path = os.path.join(actual_dir, fname)
        if not os.path.exists(actual_path):
            failures.append(f"{fname}: missing from actual export")
            continue
        base, act = load_csv(os.path.join(baseline_dir, fname)), load_csv(actual_path)
        for col, b in base.items():
            if col == "time":
                continue
            if col not in act:
                failures.append(f"{fname}:{col}: column missing from export")
                continue
            t = tol.get(col, tol["value"])
            abs_tol = t.get("abs", tol["value"]["abs"])
            rel_tol = t.get("rel", tol["value"]["rel"])
            a = act[col]
            if len(b) != len(a):
                failures.append(f"{fname}:{col}: row count {len(a)} vs {len(b)}")
            for i in range(min(len(b), len(a))):
                share, miss = _cell_error(b[i], a[i], abs_tol, rel_tol)
                if miss is not None:
                    failures.append(f"{fname}:{col}[{i}]: {miss}")
                    break
                worst = max(worst, share)
    return len(baselines), failures, worst


def export(example: str, out_dir, device="cuda"):
    """Run one of the port's examples for ``TICKS`` ticks on ``device``
    and write its CSV archive to ``out_dir``; returns the ``Exec`` and the
    seconds ``Exec.run`` took (it synchronises the card)."""
    mod = baselined_examples()[example]
    exec_ = mod.build_world().build(mod.build_system(), device=device,
                                    simulation_rate=simulation_rate(mod))
    t0 = time.perf_counter()
    exec_.run(TICKS)
    wall = time.perf_counter() - t0
    exec_.save_archive(out_dir, format="csv")
    return exec_, wall


def check(example: str, device="cuda"):
    """``export`` then ``compare`` against the stored baseline; raises
    AssertionError on any failure.  Returns the ``Exec``, the seconds its
    run took, the number of files held and the largest share of its
    tolerance an element used."""
    with tempfile.TemporaryDirectory(prefix=f"elodin-regress-{example}-") as out_dir:
        exec_, wall = export(example, out_dir, device)
        n, failures, worst = compare(
            baseline_dir(example), out_dir,
            load_tolerances(os.path.join(BASELINE_ROOT, "tolerances.json")))
    if failures:
        raise AssertionError(f"{example}: regression failures:\n  " + "\n  ".join(failures))
    return exec_, wall, n, worst


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Telemetry regression gate of the port's examples")
    ap.add_argument("examples", nargs="*", default=list(EXAMPLES))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    for ex in a.examples:
        _, _, n, worst = check(ex, a.device)
        print(f"{ex}: {n} baselined files match within tolerance "
              f"(the closest element used {worst:.3g} of its tolerance)")
    print("regression gate: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
