"""The ``elodin`` CLI on the port (counterpart of
``elodin_tpu/__main__.py``).

Usage:
    python -m elodin_tpu_torch run <target> [sim args...]
    python -m elodin_tpu_torch bench <target> [--ticks N] [--device DEV]
    python -m elodin_tpu_torch components <target>
    python -m elodin_tpu_torch db ...          (the telemetry database's CLI)
    python -m elodin_tpu_torch monte-carlo run <sim.py> --campaign c.toml --out DIR
        [--workers N] [--max-ticks N] [--resume] [--device DEV]

A target is a sim file (``path/to/main.py``) or, since the port's examples
are package modules with relative imports, a dotted module name
(``elodin_tpu_torch.examples.drone.main``); either runs as ``__main__``
with the sim args as its ``sys.argv``.  ``editor`` and ``render-server``
are not ported (ROADMAP.md §1 item 8).
"""

from __future__ import annotations

import os
import runpy
import sys

_NOT_PORTED = ("editor", "render-server")


def _run_sim(target: str, extra: list[str]) -> None:
    if target.endswith(".py") or os.path.sep in target or os.path.exists(target):
        path = os.path.abspath(target)
        sys.path.insert(0, os.path.dirname(path))
        sys.argv = [path] + extra
        runpy.run_path(path, run_name="__main__")
    else:
        # alter_sys sets sys.argv[0] to the module's file
        sys.argv = [target] + extra
        runpy.run_module(target, run_name="__main__", alter_sys=True)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return
    cmd, rest = argv[0], argv[1:]

    if cmd in ("run", "bench", "components") and not rest:
        print(f"usage: python -m elodin_tpu_torch {cmd} <sim.py or module> [args...]",
              file=sys.stderr)
        sys.exit(2)
    if cmd == "run":
        _run_sim(rest[0], ["run"] + rest[1:])
    elif cmd == "bench":
        _run_sim(rest[0], ["bench"] + rest[1:])
    elif cmd == "components":
        _run_sim(rest[0], ["components"])
    elif cmd == "db":
        from .db.__main__ import main as db_main

        db_main(rest)
    elif cmd == "monte-carlo":
        _monte_carlo(rest)
    elif cmd in _NOT_PORTED:
        print(f"{cmd} is not ported (ROADMAP.md §1 item 8)", file=sys.stderr)
        sys.exit(2)
    else:
        raise SystemExit(f"unknown subcommand {cmd!r}\n{__doc__}")


def _monte_carlo(rest: list[str]) -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(prog="elodin monte-carlo")
    sub = p.add_subparsers(dest="mc_cmd", required=True)
    run_p = sub.add_parser("run")
    run_p.add_argument("sim")
    run_p.add_argument("--campaign", required=True)
    run_p.add_argument("--out", required=True)
    run_p.add_argument("--workers", type=int, default=1)
    run_p.add_argument("--max-ticks", type=int, default=None)
    run_p.add_argument("--batched", action="store_true",
                       help="run on-device (vmap) instead of per-process")
    run_p.add_argument("--resume", action="store_true")
    run_p.add_argument("--device", default=None,
                       help="passed to each sample's process as --device")
    args = p.parse_args(rest)

    config = _load_config(args.campaign)
    if args.batched:
        raise SystemExit(
            "--batched campaigns are driven from Python (see "
            "elodin_tpu_torch.monte_carlo.BatchedCampaign and "
            "elodin_tpu_torch/examples/monte_carlo/batched.py); the CLI path "
            "runs processes"
        )
    from .monte_carlo import run_campaign

    records = run_campaign(
        args.sim, config, args.out, workers=args.workers,
        max_ticks=args.max_ticks, resume=args.resume, device=args.device,
    )
    ok = sum(1 for r in records if r.get("valid"))
    print(json.dumps({"total": len(records), "valid": ok}))


def _load_config(path: str) -> dict:
    import tomllib

    with open(path, "rb") as f:
        return tomllib.load(f)


if __name__ == "__main__":
    main()
