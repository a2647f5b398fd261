"""The readings a cell's limits are set from, on the card.

    python3 benchmark/limits.py --workload <name> --seeds 1,2,... --control-seeds 7,8,9 \
        [--seconds 2] [--out FILE]

In one process (the torch import paid once): for each of ``--seeds`` a run
of the cell with a short window, its numbers as ``correct`` compares them
(the lower readings); for each of ``--control-seeds`` the same run with the
reference computed one precision lower judged in the program's place (the
control: the upper readings).  Each run prints a JSON line; the last line
holds, for each number, the largest program reading and the smallest
control reading.  Not part of a benchmark run.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(workload: str, seeds, control_seeds, seconds: float, device: str = "cuda",
             overrides=None, out=sys.stdout) -> dict:
    """{"program": {number: largest}, "control": {number: smallest}} over
    the runs, each run's line written to ``out``."""
    from benchmark.harness import runner

    summary = {"program": {}, "control": {}}
    for control, seed_list in ((False, seeds), (True, control_seeds)):
        side = summary["control" if control else "program"]
        for seed in seed_list:
            r = runner.run(workload, seed, seconds, False, device=device, overrides=overrides,
                           control=control)
            numbers = {k: v["value"] for k, v in r["compared"].items()}
            print(json.dumps({"workload": workload, "seed": seed, "control": control,
                              "numbers": numbers, "gaps_by_group": r["gaps_by_group"],
                              "correct": r["correct"]}), file=out, flush=True)
            for k, v in numbers.items():
                v = float(v)
                pick = min if control else max
                side[k] = v if k not in side else pick(side[k], v)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    out = open(args.out, "a") if args.out else sys.stdout
    try:
        summary = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                           [int(s) for s in args.control_seeds.split(",")], args.seconds, out=out)
        print(json.dumps({"workload": args.workload, "summary": summary}), file=out, flush=True)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
