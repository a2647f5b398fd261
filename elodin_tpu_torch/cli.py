"""Sim argv subcommands: run | bench | components | params | plan
(counterpart of ``elodin_tpu/cli.py``; libs/nox-py/src/world_builder.rs).

Every sim built on this package is also a CLI: ``python main.py bench
--ticks 100`` benchmarks it headless, ``components`` dumps its schema,
``params`` and ``plan`` give its Monte Carlo spec, and ``run`` steps it
with its host callbacks, tick metrics and real-time pacing.

``run`` and ``bench`` take ``--device`` (the sim's ``World.run(device=)``
when not given, ``"cuda"`` by default).  ``run`` serves the telemetry
database on its address (``db.server.serve_exec``; if the server cannot
start it warns and steps headless), into ``db_path`` or
``ELODIN_DB_PATH`` when given, where it also captures the sim's sources;
``ELODIN_RESUME=1`` resumes from that database's latest rows, and
``ELODIN_KEEP_ALIVE=1`` keeps serving after the last tick.  The database
closes when ``run`` returns, and the returned ``Exec`` no longer feeds it.
``bench --profile`` writes
``profile-metrics.json`` and the ``torch.profiler`` table of one tick,
``step.torch_profile.txt``, into ``profile_output/`` beside the sim; the
port's spans (``tick_metrics.span``: the tick, each system, the edge fold)
are rows of that table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_COMMANDS = ("run", "bench", "components", "params", "plan")


def _parse_args(argv: list[str]):
    parser = argparse.ArgumentParser(prog="elodin-sim", add_help=True)
    sub = parser.add_subparsers(dest="command")

    run_p = sub.add_parser("run")
    run_p.add_argument("addr", nargs="?", default="[::]:2240")
    run_p.add_argument("--no-s10", action="store_true")
    run_p.add_argument("--liveness-port", type=int, default=None)
    run_p.add_argument("--optimize", action="store_true")
    run_p.add_argument("--device", default=None)

    bench_p = sub.add_parser("bench")
    bench_p.add_argument("--ticks", type=int, default=1000)
    bench_p.add_argument("--profile", action="store_true")
    bench_p.add_argument("--detail", action="store_true")
    bench_p.add_argument("--device", default=None)

    sub.add_parser("components")
    sub.add_parser("params")

    plan_p = sub.add_parser("plan")
    plan_p.add_argument("out_dir")
    plan_p.add_argument("addr", nargs="?", default="[::]:2240")

    if argv and argv[0] not in _COMMANDS:
        if argv[0] in ("-h", "--help"):
            # show the TOP-LEVEL help (subcommand list), not run's
            return parser.parse_args(argv)
        if argv[0].startswith("-") and argv[0] not in ("-",):
            parser.error(f"unknown option {argv[0]!r}")
        # bare `python main.py <addr>` runs like `run <addr>`
        argv = ["run"] + argv
    if not argv:
        argv = ["run"]
    return parser.parse_args(argv)


def serve_addr(argv: list[str]) -> str:
    """The address a client reaches a sim on when the sim runs with these
    CLI arguments: ``run ADDR``'s host (a wildcard host as loopback), else
    loopback at the default port."""
    rest = argv
    if argv and argv[0] in _COMMANDS:
        rest = argv[1:] if argv[0] == "run" else []
    if rest and not rest[0].startswith("-"):
        host, _, port = rest[0].rpartition(":")
        host = host.strip("[]")
        return f"{'127.0.0.1' if host in ('', '::', '0.0.0.0') else host}:{port}"
    return "127.0.0.1:2240"


def run_cli(world, system, simulation_rate=120.0, generate_real_time=False,
            telemetry_rate=None, max_ticks=None, is_canceled=None,
            pre_step=None, post_step=None, db_path=None, backend="tpu",
            device="cuda"):
    # harness hook: let tools import a sim module whose main ends in
    # w.run(...) without executing it
    if os.environ.get("ELODIN_SKIP_RUN") == "1":
        return None

    args = _parse_args(sys.argv[1:])
    cmd = args.command or "run"

    if cmd == "components":
        world.set_sim_time_step(1.0 / simulation_rate)
        meta, _cols = world.snapshot()
        out = []
        for name, comp in meta.components.items():
            out.append(
                {
                    "name": name,
                    "type": comp.ty.ty.value,
                    "shape": list(comp.ty.shape),
                    "metadata": comp.metadata,
                    "entities": [
                        meta.entity_metadata[e].name
                        if e in meta.entity_metadata
                        else str(e)
                        for e in meta.comp_entities[name]
                    ],
                }
            )
        print(json.dumps(out, indent=2, ensure_ascii=False))
        return None

    if cmd == "params":
        from . import monte_carlo

        print(monte_carlo.spec_json())
        return None

    if cmd == "plan":
        from . import monte_carlo

        spec = json.loads(monte_carlo.spec_json())
        variables = {
            k: {"dist": "fixed", "value": v.get("default")}
            for k, v in spec.get("params", {}).items()
        }
        monte_carlo.materialize_plan(
            {"monte_carlo": {"n_samples": 1, "variables": variables}},
            f"{args.out_dir}/plan.csv",
        )
        return None

    device = args.device or device

    if cmd == "bench":
        exec_ = world.build(
            system,
            simulation_rate=simulation_rate,
            telemetry_rate=telemetry_rate,
            device=device,
        )
        exec_.record_history = False
        exec_.run(args.ticks, show_progress=False)
        profile = exec_.profile()
        tpt = exec_.ticks_per_telemetry
        print(f"= tick time:          {profile['tick']:.3f} ms (batch of {tpt} ticks)")
        print(f"build time:           {profile['build']:.3f} ms")
        print(f"real_time_factor:     {profile['real_time_factor']:.3f}")
        if args.profile:
            _write_profile(exec_, args.ticks, profile)
        return exec_

    # -- run ---------------------------------------------------------------
    env_max = os.environ.get("ELODIN_MAX_TICKS")
    if env_max is not None:
        max_ticks = int(env_max) if max_ticks is None else min(max_ticks, int(env_max))

    db_path = db_path or os.environ.get("ELODIN_DB_PATH")
    if db_path:
        _capture_simulation_source(db_path)
    exec_ = world.build(
        system,
        simulation_rate=simulation_rate,
        telemetry_rate=telemetry_rate,
        max_ticks=max_ticks,
        db_path=db_path,
        device=device,
    )

    from .step_context import StepContext
    from .tick_metrics import Liveness, TickMetrics

    ctx = StepContext(exec_)
    metrics = TickMetrics()
    exec_.commit_hist = metrics.hist["commit"]
    liveness = Liveness(args.liveness_port)
    dt = 1.0 / simulation_rate
    tick = 0
    paced_ticks = 0
    behind_deadline = 0  # paced cycles that missed their deadline
    wall_start = time.perf_counter()
    server = None
    try:
        from .db.server import serve_exec

        # ELODIN_RESUME=1: the database is the checkpoint; its latest rows
        # are copied back into the device state before the first tick
        resume = os.environ.get("ELODIN_RESUME", "0") == "1"
        server = serve_exec(exec_, args.addr, resume=resume)
    except Exception as e:  # noqa: BLE001
        # keep simulating headless, but never silently
        print(f"warning: telemetry server failed to start on {args.addr}: "
              f"{e}; running headless", file=sys.stderr)
    if server is not None and server.port is None:
        # the listener did not bind (a port in use, a bad address): the
        # database still records, but nothing is served
        print(f"warning: telemetry server could not listen on {args.addr}; "
              f"running headless", file=sys.stderr)
    try:
        try:
            while max_ticks is None or tick < max_ticks:
                if is_canceled is not None and is_canceled():
                    break
                if pre_step is not None:
                    with metrics.phase("pre_step"):
                        pre_step(tick, ctx)
                t0 = time.perf_counter()
                with metrics.phase("run"):
                    exec_.run(1, show_progress=False)
                tick += 1
                liveness.beat()
                if post_step is not None:
                    with metrics.phase("post_step"):
                        post_step(tick - 1, ctx)
                if generate_real_time:
                    with metrics.phase("pacing"):
                        elapsed = time.perf_counter() - t0
                        paced_ticks += 1
                        if elapsed < dt:
                            time.sleep(dt - elapsed)
                        else:
                            behind_deadline += 1
            # the reference sim keeps serving after max_ticks; opt in with
            # ELODIN_KEEP_ALIVE so scripted runs still end
            if server is not None and os.environ.get("ELODIN_KEEP_ALIVE", "0") == "1":
                while True:
                    time.sleep(0.5)
        except KeyboardInterrupt:
            pass
        # a writer-thread error is raised here, never swallowed
        exec_.flush_telemetry()
    finally:
        liveness.stop()
        if server is not None:
            server.stop()
            # the database closes with the run: a handle left to the garbage
            # collector closes whenever it is collected, cutting the stores'
            # files to its length under a later run's rows (a resume)
            exec_.on_commit_batch = None
            server.db.close()
        metrics.print_summary()
        wall = time.perf_counter() - wall_start
        metrics.write_summary_json(
            {
                "profile": exec_.profile(),
                "max_ticks": max_ticks,
                # pacing integrity for the campaign's quality gates
                "paced_ticks": paced_ticks,
                "behind_deadline": behind_deadline,
                "behind_deadline_frac": (
                    behind_deadline / paced_ticks if paced_ticks else 0.0
                ),
                "real_time_factor_run": (
                    (tick * dt) / wall if wall > 0 else 0.0
                ),
            }
        )
    return exec_


def _write_profile(exec_, ticks: int, profile: dict) -> None:
    """``bench --profile``: ``profile-metrics.json`` and the
    ``torch.profiler`` key-averages table of one tick (the step applied to
    the current state, its result dropped) in ``profile_output/`` beside
    ``sys.argv[0]``."""
    import pathlib

    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    out_dir = pathlib.Path(sys.argv[0]).resolve().parent / "profile_output"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "profile-metrics.json").write_text(
        json.dumps(
            {
                "build_time_ms": profile["build"],
                "real_time_factor": profile["real_time_factor"],
                "ticks": ticks,
            },
            indent=2,
        )
    )
    on_card = exec_.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with torch_profile(activities=activities) as prof:
        exec_._step(dict(exec_.cols))
        if on_card:
            torch.cuda.synchronize(exec_.device)
    sort_by = "cuda_time_total" if on_card else "cpu_time_total"
    (out_dir / "step.torch_profile.txt").write_text(
        prof.key_averages().table(sort_by=sort_by, row_limit=50) + "\n")


def _capture_simulation_source(db_path: str) -> None:
    """Snapshot the sim's project .py sources into the DB
    (python/elodin/__init__.py:116-157): entrypoint + any loaded module under
    the project root, with a sha256 manifest (the JAX package's
    ``cli._capture_simulation_source``)."""
    import datetime
    import hashlib
    import pathlib
    import shutil

    entry = pathlib.Path(sys.argv[0]).resolve()
    if entry.suffix != ".py" or not entry.exists():
        return
    project_root = entry.parent
    sources = {entry}
    for mod in list(sys.modules.values()):
        f = getattr(mod, "__file__", None)
        if not f or not f.endswith(".py"):
            continue
        p = pathlib.Path(f)
        try:
            p = p.resolve()
        except OSError:
            continue
        if not p.exists():
            continue
        try:
            p.relative_to(project_root)
        except ValueError:
            continue
        if "__pycache__" in p.parts or "site-packages" in str(p):
            continue
        sources.add(p)

    source_root = pathlib.Path(db_path) / "simulation_source"
    files_root = source_root / "files"
    manifest_files = []
    for src_path in sorted(sources):
        rel = src_path.relative_to(project_root)
        dest = files_root / rel
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src_path, dest)
        data = src_path.read_bytes()
        manifest_files.append(
            {
                "path": rel.as_posix(),
                "sha256": hashlib.sha256(data).hexdigest(),
                "size": len(data),
            }
        )
    source_root.mkdir(parents=True, exist_ok=True)
    (source_root / "manifest.json").write_text(
        json.dumps(
            {
                "version": 1,
                "entrypoint": entry.name,
                "project_root": str(project_root),
                "captured_at": datetime.datetime.now(
                    datetime.timezone.utc
                ).isoformat(),
                "files": manifest_files,
            },
            indent=2,
            sort_keys=True,
        )
        + "\n"
    )
