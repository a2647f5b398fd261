"""The ``elodin`` CLI on the port (counterpart of
``elodin_tpu/__main__.py``).

Usage:
    python -m elodin_tpu_torch run <target> [sim args...]
    python -m elodin_tpu_torch bench <target> [--ticks N] [--device DEV]
    python -m elodin_tpu_torch components <target>
    python -m elodin_tpu_torch db ...          (the telemetry database's CLI)
    python -m elodin_tpu_torch monte-carlo run <sim.py> --campaign c.toml --out DIR
        [--workers N] [--max-ticks N] [--resume] [--device DEV]
    python -m elodin_tpu_torch editor <target> [sim args...]   (no GUI: see below)
    python -m elodin_tpu_torch render-server [DIR] [--addr HOST:PORT]

A target is a sim file (``path/to/main.py``) or, since the port's examples
are package modules with relative imports, a dotted module name
(``elodin_tpu_torch.examples.drone.main``); either runs as ``__main__``
with the sim args as its ``sys.argv``.

There is no GUI: ``render-server`` serves a database (``db run``) for a
renderer elsewhere to attach to, and ``editor`` resolves its target as the
reference editor does and serves it: a sim (a ``.py`` file, or a name that
is no existing path and names an importable dotted module) runs through
``run`` with the sim args after the target (on the card unless they
name another ``--device``), an ``s10.toml`` runs its recipes and
supervises them until their processes end, a ``host:port`` prints the
live database's viewer address, and anything else is served as a
database directory.
"""

from __future__ import annotations

import importlib.util
import os
import re
import runpy
import sys
import time

_ADDR = re.compile(r"[\w.\-\[\]:]+:\d+")
_DOTTED = re.compile(r"[A-Za-z_]\w*(\.[A-Za-z_]\w*)+")


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
    elif cmd == "render-server":
        # the reference render-server is the headless Bevy renderer
        # (apps/elodin/src/cli/mod.rs:23-36); with no GUI stack, serve the
        # target database so a renderer elsewhere can attach
        from .db.__main__ import main as db_main

        db_main(["run"] + rest)
    elif cmd == "editor":
        _editor(rest[0] if rest else None, rest[1:])
    else:
        raise SystemExit(f"unknown subcommand {cmd!r}\n{__doc__}")


def _is_module(target: str) -> bool:
    """``target`` is no existing path and names an importable dotted
    module (the port's sims are package modules)."""
    if os.path.exists(target) or not _DOTTED.fullmatch(target):
        return False
    try:
        return importlib.util.find_spec(target) is not None
    except (ImportError, ValueError):
        return False


def _editor(target: str | None, sim_args: list[str]) -> None:
    """Resolve the target the way the reference editor does
    (apps/elodin/src/cli/editor.rs:125-211: a sim, an s10.toml, a database
    address, a replay directory) and serve it for an external editor.
    A sim takes ``sim_args`` after ``run``."""
    if target and (target.endswith(".py") or _is_module(target)):
        _run_sim(target, ["run"] + sim_args)
    elif target and target.endswith(".toml"):
        from .s10 import load_toml, run_recipes

        sup = run_recipes(load_toml(target))
        try:
            while any(rp.poll() is None for rp in sup.running):
                sup.tick()
                time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        finally:
            sup.stop_all()
    elif target and _ADDR.fullmatch(target):
        host, _, port = target.rpartition(":")
        print(
            f"{target} is a live database address — its web viewer is "
            f"at http://{host}:{int(port) + 1}/ (the native editor can "
            "also attach directly)"
        )
    else:
        from .db.__main__ import main as db_main

        db_main(["run", target] if target else ["run"])


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
