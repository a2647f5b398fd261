"""Sim argv subcommands: run | bench | components | params | plan
(counterpart of ``elodin_tpu/cli.py``; libs/nox-py/src/world_builder.rs).

Every sim built on this package is also a CLI: ``python main.py bench
--ticks 100`` benchmarks it headless, ``components`` dumps its schema,
``params`` and ``plan`` give its Monte Carlo spec, and ``run`` steps it
with its host callbacks, tick metrics and real-time pacing.

``run`` and ``bench`` take ``--device`` (the sim's ``World.run(device=)``
when not given, ``"cuda"`` by default).  The telemetry server and database
are not ported: ``run`` says so on stderr and steps headless, and a
database path (``db_path``, ``ELODIN_DB_PATH``) or ``ELODIN_RESUME=1``
raises ``NotImplementedError``.  ``bench --profile`` writes
``profile-metrics.json`` and the ``torch.profiler`` table of one tick,
``step.torch_profile.txt``, into ``profile_output/`` beside the sim.
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
    if db_path or os.environ.get("ELODIN_RESUME", "0") == "1":
        raise NotImplementedError(
            "run with a telemetry database (db_path, ELODIN_DB_PATH, "
            "ELODIN_RESUME): the telemetry database is not ported")
    exec_ = world.build(
        system,
        simulation_rate=simulation_rate,
        telemetry_rate=telemetry_rate,
        max_ticks=max_ticks,
        device=device,
    )

    from .step_context import StepContext
    from .tick_metrics import Liveness, TickMetrics

    ctx = StepContext(exec_)
    metrics = TickMetrics()
    exec_.commit_hist = metrics.hist["commit"]
    liveness = Liveness(args.liveness_port)
    # the JAX package serves telemetry on args.addr here; without a server
    # it steps headless, as this port always does
    print(f"note: the telemetry server is not ported; running headless "
          f"(not serving {args.addr})", file=sys.stderr)
    dt = 1.0 / simulation_rate
    tick = 0
    paced_ticks = 0
    behind_deadline = 0  # paced cycles that missed their deadline
    wall_start = time.perf_counter()
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
        except KeyboardInterrupt:
            pass
        # a writer-thread error is raised here, never swallowed
        exec_.flush_telemetry()
    finally:
        liveness.stop()
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
