#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (elodin_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

Phases; each raises on failure, so the script exits non-zero:

1. device: a CUDA card is required (no CPU fallback); print its name and
   power limit as nvidia-smi reports them.
2. build: compile ops/csrc/sixdof_rk4.cu and ops/csrc/pairwise_gravity.cu
   with nvcc for sm_90a, one nvcc per source, started together; print
   ptxas's report (registers, spills) of each.

The batched 6-dof RK4 path and its kernel (sixdof_rk4):

3. kernel vs plain PyTorch version on the card, f32 and f64, at 1024
   bodies x 50 ticks and at the main path's 8192 bodies x 240 ticks:
   max |Δ| / max |ref| per channel group (quaternion, position, angular
   and linear velocity) ≤ 1e-4 in f32 and ≤ 1e-12 in f64.
4. the main path at full width, through the two entry points a user
   calls, from the same initial columns of ``build_batched_sixdof(8192)``
   under the f64 policy: the ECS tick loop,
   ``World.build(device="cuda", telemetry_rate=12.0)`` and
   ``Exec.run(240)``, then the whole-rollout entry point
   ``sixdof_rollout`` for 240 ticks in f64 and in f32.  The kernel's
   launch count is set to 0 just before and read after each entry point:
   the ECS loop runs eager PyTorch ops and must launch the kernel 0 times
   (the kernel is not behind ``Exec`` yet), the whole-rollout entry point
   exactly once per call.  The ECS state must be finite with tick == 240;
   the f64 kernel must agree with it to ≤ 1e-10 and the f32 kernel to
   ≤ 1e-4 (per channel group, max |Δ| / max |ref|).
5. kernel (4000 ticks) and plain version (20 ticks) timed with CUDA
   events, f32 and f64, at 1024 bodies and at the JAX bench's kernel
   width, 131072 bodies; the bound of a tick there, from the function's
   operations and SFU results (``SIXDOF_TICK_OPS``), with the loops of the
   kernel's SASS beside it (cuobjdump, read by ``scripts/sass_loops.py``).
6. device trace with ``torch.profiler``: device ops per tick, device busy
   time and idle share of the ECS loop (8192 bodies, f64, 20 ticks) and
   of one kernel launch at 131072 bodies x 4000 ticks, f32 and f64.

The n-body path and its kernel (pairwise_gravity):

7. kernel vs plain PyTorch version on the card, f32 and f64, at every
   size where the launch plan changes (1, 2, 127, 129, 300, 1000, 4099
   and 16384 bodies), on the ``build_nbody(N, seed=2)`` positions and
   masses (a sun at the origin, so d2 == 0 against the tail slots) and on
   a unit cloud with eps = 0.1 and two coincident bodies: max |Δ| / max
   |ref| ≤ 1e-4 in f32 and ≤ 1e-12 in f64 (max |Δ| where the reference is
   all zero), finite, and two launches bitwise equal.
8. the main path at full width: ``build_nbody(16384, seed=2)`` under the
   f32 policy, ``World.build(build_system(60.0, use_kernel=True),
   device="cuda")`` and ``Exec.run(100)``.  The kernel's launch count is
   set to 0 just before the run and must read 100 after it (one launch per
   semi-implicit tick); the state must be finite with tick == 100.  The
   momentum drift is printed, and the state must agree with the same run
   under the f64 policy to ≤ 1e-4 per channel group.
9. the edge-fold path (``GraphQuery[TotalEdge]``): ``build_nbody(4096)``,
   f64, ``use_kernel=False``, ``Exec.run(50)``: the kernel must launch 0
   times, every fold must take the dense path with no probe, and the state
   must agree with the kernel path on the same world to ≤ 1e-10 per channel
   group; then its device trace over 5 ticks.
10. the fold as ``examples/n-body/main.py`` writes it (no additive hint)
    on ``build_nbody(128)``, f64, ``Exec.run(10)``: the additive probe must
    run once and reject it, every tick must fold sequentially, the kernel
    must launch 0 times, and the state must agree with the kernel path on
    the same world to ≤ 1e-10.
11. kernel timed with CUDA events (20 back-to-back calls between two
    events, min and median of 5, after a warm-up) at 300, 1024, 4096 and
    16384 bodies, f32 and f64: the launch plan, µs per call, pairs/s, the
    bound (the larger of the function's operations, ``PAIR_OPS``, over the
    FP32 or FP64 pipe's peak, one reciprocal square root a pair over the
    SFU's, and the bytes over HBM's) with the
    resource that sets it, and the share of the bound; then the device
    time of a launch from ``torch.profiler`` (at small sizes the calls'
    host time, not the kernel, sets the CUDA-event time); the plain
    version at 16384 bodies.
12. device trace of the n-body kernel path (16384 bodies, f32, 20 ticks),
    then a cProfile of the same run: where the host's time per tick goes.

The falcon9 RTLS Monte Carlo campaign (eager PyTorch ops under
``torch.func.vmap``; no hand kernel):

13. ``examples.falcon9.batched.make_campaign(10000, seed=0,
    device="cuda")`` (LHS draws, f64), then ``BatchedCampaign.run(300,
    history_every=100, history_components=[world_pos, world_vel, phase,
    prop_kg], until=phase == DOWN)``: 3 s of the mission (spool-up,
    release from the hold-down, liftoff, 60 guidance ticks).  Both kernels'
    launch counts are set to 0 before and read after (the path has no
    hand kernel).  Checks: every column finite, tick == 300 and lifted ==
    1 in every sample, guidance on 60 ticks, the last history emit equal
    to the final state bitwise, and the first 8 samples equal to the port's
    run on the CPU from the same draws to ≤ 1e-9 per channel group
    (``batched.state_errors``).  Then ms/tick with and without guidance
    (25 single ticks), sample-ticks/s, the projected full-mission wall, the
    device trace and a cProfile of 20 ticks each.

The rocket, three-body and landing Monte Carlo examples (eager PyTorch
ops; no hand kernel: before each of phases 14-18 both kernels' launch
counts are set to 0, and each must read 0 after it), in f64.  The CPU
runs that phases 17 and 18 compare against go on in two worker processes
while the verify runs of phases 14-16 take place, and are collected
before phase 17; no worker runs during a timed run:

14. three-body (``examples.three_body``) through ``regress.check``:
    ``World.build(device="cuda", simulation_rate=120)``, ``Exec.run(240)``
    (timed), ``save_archive(dir, "csv")``, then every column of
    ``scripts/baseline/three-body`` held by ``regress.compare`` (vector
    cells parsed as lists; abs or rel 1e-4 from
    ``scripts/baseline/tolerances.json``; a missing file or column or a
    row count other than 241 fails); later, with the workers started,
    ``verify_trajectory``, the card against the CPU, 100 ticks,
    allclose(1e-6, 1e-6).
15. the rocket (``examples.rocket.main``), one entity: the same two checks
    against ``scripts/baseline/rocket``.
16. falcon9 without sensors (``build(None, sensors=False)``) through
    ``verify_trajectory``, the card against the CPU, 100 ticks,
    allclose(1e-6, 1e-6).
17. the batched rocket (``examples.rocket.batched``): 1024 rockets x 240
    ticks through ``BatchedCampaign``.  Every column finite, the 1024
    samples bitwise equal to each other (no overrides), the first 8 equal
    to the port's run on the CPU (the first worker) to ≤ 1e-9 per channel
    group; then entity-steps/s, ms/tick, the device trace of 2 ticks and
    a cProfile of 20 ticks.
18. the landing Monte Carlo (``examples.monte_carlo.batched``), the whole
    campaign: 10000 samples x 2400 ticks, LHS seed 0.  Every column
    finite; the landed and soft fractions within 5 samples of the JAX
    package's run of the same campaign (``JAX_MC_*``); the first 64
    samples' touchdown velocity and final state equal to the port's run on
    the CPU from the same draws (the second worker) to ≤ 1e-9 per channel
    group, with the same landed and soft flags; then wall, rollouts/s,
    sample-ticks/s, the device trace and a cProfile of 20 ticks.

The drone and the cube-sat, single-entity interactive sims (eager PyTorch
ops; no hand kernel: both kernels' launch counts are set to 0 before each
of phases 19-22 and must read 0 after it), in f64; no CPU worker runs
beside any of them:

19. the drone (``examples.drone``, noise on) and the cube-sat
    (``examples.cube_sat``) through ``regress.check``: ``World.build(
    device="cuda", simulation_rate=120)``, ``Exec.run(240)``, the CSV
    archive against their re-exported baselines (``regress.REEXPORTED``:
    the JAX examples fail ``scripts/baseline``, which predates them), every
    column, vector cells included, abs or rel 1e-4.
20. both through ``verify_trajectory``, the card against the CPU, 100
    ticks, allclose(1e-6, 1e-6): max |Δ|/(1+|x|) and the worst columns.
21. the real-time factor (simulated seconds over wall seconds) of each,
    built as ``bench.py``'s RTF leg builds it (``SIMULATION_RATE`` or ``1 /
    SIM_TIME_STEP``, no history), run ``RTF_TICKS`` ticks (drone 300 at
    300 Hz, cut from bench.py's 1200 to keep the script inside its time;
    cube-sat 240 at 120 Hz) after a 30-tick warm-up,
    ``RTF_REPEATS`` times on the card and as often on the CPU with the same
    port: the median, min and max, and ms per tick.
22. the device trace of each on the card (device ops per tick, busy time,
    idle share) and a cProfile of the host.
23. the card count and whether ``pyarrow`` imports (``Exec.save_archive``'s
    Parquet and Arrow need it; no phase does).

JAX's threefry, the ball, linalg and stablehlo examples, the falcon9
sensor suite and Exec checkpoints (eager PyTorch ops; no hand kernel:
both kernels' launch counts are set to 0 before each of phases 24-27 and
must read 0 after it), in f64 unless named:

24. ``ops.threefry`` on the card against the CPU: the words of ``key``,
    ``fold_in`` (a negative int32 among the data), ``split`` and ``bits``
    (32- and 64-bit) and the f32 and f64 uniforms bit for bit, for 10**6
    counters under two seeds and 1000 under three corner seeds (2**32 + 5,
    -7, 2**40); the normals within 3 ulps (f32) and 8 (f64), the sum of
    the card's documented erfinv error and the CPU's measured one, the
    largest difference in ulps printed, and each side's against sqrt(2)
    times scipy's erfinv of the same uniform.  Then the falcon9 suite's noise: ``sensors.noise_streams`` of
    a tick's six streams equal to six ``sensors.noise`` calls bitwise, and
    the host microseconds and device ops of one ``noise`` and one
    ``noise_streams`` call.
25. ball, linalg and stablehlo through ``regress.check`` on the card
    (every column of ``scripts/baseline/<example>``, vector cells parsed,
    abs or rel 1e-4), then ``verify_trajectory``, the card against the CPU,
    100 ticks, then the real-time factor on the card and on the CPU
    (``RTF_TICKS``: ball 600 ticks, cut from bench.py's 2400; stablehlo
    1200; linalg 600), the device trace and a cProfile of the host.
26. falcon9 with its sensors (``build(None)``): ``verify_trajectory``, the
    card against the CPU, 100 ticks, under f64 (the JAX bench's leg) and
    under the mixed policy at max |Δ|/(1+|x|) ≤ 1e-6 (its mixed leg); then
    ``Exec.run`` of the mission with and without sensors on the card (no
    history): ms/tick over 100 ticks, device ops per tick and idle share,
    and a cProfile of the tick with sensors.
27. Exec checkpoints on the card, on falcon9 with sensors and a history
    small enough to spill to its spool: 30 ticks, ``restore(10)`` (the
    history cut to 11 rows, spilled chunks included), 20 more ticks, and
    every column bitwise equal to the first run's tick 30;
    ``save_checkpoint`` then ``load_checkpoint`` after 5 more ticks,
    bitwise; ``verify.checkpoint_first_tick`` writes its three files.

28. a JSON line of the kernels (time, plain version's time and bound at
    the main path's width, launches on the main path; no PyTorch call
    computes either function, so ``library_ms`` is null), then the last
    line ``{"ok": true, "device": {...}}``.
"""

import cProfile
import json
import multiprocessing
import os
import pstats
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

DT = 1.0 / 120.0
F32_TOL, F64_TOL, ECS_F64_TOL = 1e-4, 1e-12, 1e-10
SIXDOF_STATE = ("world_pos", "world_vel")
MAIN_BODIES, MAIN_TICKS = 8192, 240
BENCH_BODIES, BENCH_TICKS, PLAIN_TICKS = 131072, 4000, 20
TRACE_TICKS = 20
NBODY_BODIES, NBODY_TICKS, NBODY_DT = 16384, 100, 60.0
EDGE_BODIES, EDGE_TICKS, EDGE_TRACE_TICKS = 4096, 50, 5
PROBED_BODIES, PROBED_TICKS = 128, 10
F9_SAMPLES, F9_TICKS, F9_HISTORY_EVERY = 10000, 300, 100
F9_CPU_SAMPLES, F9_TIMED_TICKS, F9_TOL = 8, 25, 1e-9
PAIRWISE_SHAPES = (1, 2, 127, 129, 300, 1000, 4099, NBODY_BODIES)
PAIRWISE_TIMED = (300, 1024, 4096, NBODY_BODIES)
# Published 700 W peaks of one H100 SXM (NVIDIA's data sheet): FP32 and
# FP64 outside the tensor cores, and HBM; the SFU returns 16 results a
# clock per SM, here at the 1980 MHz boost clock.
PEAK_FP32, PEAK_FP64, PEAK_HBM = 67e12, 34e12, 3.35e12
SFU_PER_SM_CLOCK, BOOST_HZ = 16, 1.98e9
# the pairwise function's operations a pair, an FMA counted as 2, with
# eps = 0 (one more with eps): 3 subtractions, |d|^2 (5), inv^3 m (3), the
# three sums (6); in f64 the refinement of the reciprocal square root adds
# 8 (two multiplies, three FMAs).  One reciprocal square root a pair goes
# to the SFU.  The d2 == 0 remap is no work of the function a pair.
PAIR_OPS = {torch.float32: 17, torch.float64: 25}
# K1's operations per body-tick, counted from the function
# (sixdof_rk4.cu's rk4_tick: four stages of the effector and sixdof_accel
# algebra, five normalised quaternion updates, the RK4 sums), an FMA
# counted as 2, and what stays constant for a body over the ticks (1/inv_m
# and the effector constants times m) left out: 891 adds and multiplies, 4
# reciprocals, 9 reciprocal square roots and 4 square roots, one SFU result
# each.  The IEEE reciprocal and square root add the shortest correctly
# rounded sequence after the SFU's seed: in f32 4 operations a reciprocal
# (one Newton step), 6 a square root, none a reciprocal square root
# (rsqrtf is the SFU's result); in f64 8 a reciprocal and a reciprocal
# square root (two Newton steps, the cubic step), 14 a square root.
SIXDOF_TICK_OPS = {torch.float32: 891 + 4 * 4 + 4 * 6,
                   torch.float64: 891 + 4 * 8 + 9 * 8 + 4 * 14}
SIXDOF_TICK_SFU = 4 + 9 + 4
# the JAX package's campaign on the CPU (examples/falcon9, LHS seed 0,
# history every 100 ticks): the tick at which every sample has latched
# DOWN, and the first tick at which a sample is in DESCENT (guidance at
# full rate from then on)
JAX_F9_SAMPLES, JAX_F9_ALL_DOWN_TICK, JAX_F9_FIRST_DESCENT_TICK = 1024, 54400, 34300
VERIFY_TICKS = 100
ROCKETS, ROCKET_TICKS, ROCKET_CPU_SAMPLES, EX_TOL = 1024, 240, 8, 1e-9
# ticks of the batched rocket's device trace: ~3000 device ops a tick, and
# the profiler's post-processing grows with the events
ROCKET_TRACE_TICKS = 2
MC_SAMPLES, MC_TICKS, MC_CPU_SAMPLES, MC_FRAC_SLACK = 10000, 2400, 64, 5
# bench.py's RTF run lengths of the single-entity sims, and the repeats
# (the drone cut from 1200 and the ball from 2400 ticks to keep the script
# inside its time)
RTF_TICKS = {"drone": 300, "cube-sat": 240, "ball": 600, "stablehlo": 1200, "linalg": 600}
RTF_REPEATS = 3
RTF_WARMUP_TICKS = 30
SINGLE_TRACE_TICKS = 10
THREEFRY_COUNTERS, THREEFRY_CORNER_COUNTERS = 10**6, 1000
# the normals' largest difference, card against CPU, in ulps: the card's
# erfinv is the CUDA math library's (documented at 2 ulps in f32 and 5 in
# f64), the CPU's is within 1 and 3 ulps of a correctly rounded erfinv
# (tests/test_torch_threefry.py holds it against scipy's)
NORMAL_ULPS = {torch.float32: 3, torch.float64: 8}
NOISE_CALLS = 50
F9_SENSOR_TICKS, F9_MIXED_TOL = 100, 1e-6
CKPT_TICKS, CKPT_RESTORE, CKPT_MORE = 30, 10, 5
# history bytes before a spill, small enough that phase 27's run spills
CKPT_HISTORY_BYTES = 16 << 10
# the JAX package's landing campaign, examples/monte-carlo/batched.py
# run_campaign(10000, 2400, seed=0), run on a CPU (JAX_PLATFORMS=cpu, f64)
JAX_MC_LANDED_FRAC, JAX_MC_SOFT_FRAC = 0.9759, 0.9401


_START = time.perf_counter()


def _clock(label):
    """Print the seconds since the script started, after ``label``."""
    print(f"[{time.perf_counter() - _START:.1f} s] {label} done")


def _time_ms(fn, reps=3, calls=1):
    """(min, median) milliseconds per call of fn() on the card, by CUDA
    events around ``calls`` back-to-back calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return min(times), statistics.median(times)


def _device_trace(fn):
    """(device ops, device busy ms, wall ms) of one call of fn() under
    torch.profiler.  Busy is the sum of the durations of the device ops
    (kernels and copies), which run on one stream."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(dev), sum(e.time_range.elapsed_us() for e in dev) / 1e3, wall_ms


def _host_profile(label, fn, ticks, top=10):
    """cProfile of one call of fn(), a run of ``ticks`` ticks: its wall per
    tick, then the ``top`` functions by own time and the port's ``top``
    functions by cumulative time, each per tick.  cProfile slows the
    Python side, so its times are upper bounds."""
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = pstats.Stats(prof).stats.items()
    print(f"{label}: wall under cProfile {wall_ms / ticks:.4g} ms/tick")

    def show(title, picked):
        print(f"  {title}:")
        for (path, line, func), (_, calls, own, cum, _) in picked[:top]:
            print(f"    {os.path.basename(path)}:{line}({func}) calls/tick "
                  f"{calls / ticks:.4g}, own {own * 1e3 / ticks:.4g} ms/tick, "
                  f"cumulative {cum * 1e3 / ticks:.4g} ms/tick")

    show("by own time", sorted(rows, key=lambda r: -r[1][2]))
    show("the port's functions by cumulative time",
         sorted((r for r in rows if "elodin_tpu_torch" in r[0][0]),
                key=lambda r: -r[1][3]))


def _bound(ops, mufu, nbytes, dtype):
    """(least ms the card could take, the resource that sets it) for
    ``ops`` operations on the FP32 or FP64 pipe, ``mufu`` results of the
    SFU and ``nbytes`` read or written once in device memory."""
    pipe = "FP64 pipe" if dtype == torch.float64 else "FP32 pipe"
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    times = {pipe: ops / (PEAK_FP64 if dtype == torch.float64 else PEAK_FP32),
             "SFU": mufu / (SFU_PER_SM_CLOCK * sm_count * BOOST_HZ),
             "memory": nbytes / PEAK_HBM}
    resource = max(times, key=times.get)
    return times[resource] * 1e3, resource


def _bound_by(resource):
    return "bytes" if resource == "memory" else "operations"


def _pairwise_bound(n, dtype, eps=0.0):
    """``_bound`` of one all-pairs call on ``n`` bodies: N^2 pairs, each
    read and written value moved once (positions, masses, accelerations)."""
    pairs = n * n
    return _bound(pairs * (PAIR_OPS[dtype] + (eps != 0.0)), pairs,
                  7 * n * dtype.itemsize, dtype)


def _print_sixdof_sass(dtype):
    """The loops of K1 as built, from its SASS (cuobjdump): instructions,
    FP32 or FP64 pipe operations (an FMA counted as 2) and SFU results.  A
    diagnostic of the issue slots the compiler spent, beside the
    function's own count (``SIXDOF_TICK_OPS``); never the bound."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import sass_loops
    from elodin_tpu_torch.ops import _build

    text = sass_loops.sass_text(str(_build.library_path("sixdof_rk4")))
    tag = "sixdof_rk4_kernelI" + ("f" if dtype == torch.float32 else "d")
    for name, start, end, count, classes, fp32, fp64, _ in sass_loops.loop_counts(text, tag):
        print(f"K1 SASS, {dtype}: loop 0x{start:x}-0x{end:x} of {count} instructions, "
              f"FP32 ops {fp32}, FP64 ops {fp64}, MUFU {classes['MUFU']}")


def _rel_groups(ours, ref):
    """(max |Δ| / max |ref|, max |Δ|) per channel group of a (N, 7)
    transform or a (N, 6) motion/force column, each group against its own
    scale (an all-zero group by max |Δ| alone)."""
    groups = {7: (("quaternion", slice(0, 4)), ("translation", slice(4, 7))),
              6: (("angular", slice(0, 3)), ("linear", slice(3, 6)))}[ref.shape[-1]]
    out = {}
    for name, idx in groups:
        o, r = ours[:, idx].double(), ref[:, idx].double()
        d, scale = (o - r).abs().max().item(), r.abs().max().item()
        out[name] = (d / scale if scale > 0.0 else d, d)
    return out


def _compare(label, ours, ref, names, tol):
    """``_rel_groups`` of each named column of two dicts of columns; raises
    past ``tol``.  Returns (worst relative, worst absolute) error."""
    worst, worst_abs, parts = 0.0, 0.0, []
    for name in names:
        for g, (rel, d) in _rel_groups(ours[name], ref[name]).items():
            worst, worst_abs = max(worst, rel), max(worst_abs, d)
            parts.append(f"{name}.{g} {rel:.3e}")
    print(f"{label}: max|Δ|/max|ref| {worst:.3e} (tol {tol:g}), max|Δ| "
          f"{worst_abs:.3e}, by group " + ", ".join(parts))
    if not worst <= tol:
        raise AssertionError(f"{label}: {worst:.3e} exceeds {tol:g}")
    return worst, worst_abs


def _state(pos_vel):
    """A (world_pos, world_vel) pair as a dict of columns."""
    return dict(zip(SIXDOF_STATE, pos_vel))


def _sixdof(el, interop):
    """Phases 3-6: the batched 6-dof RK4 path and its kernel; returns the
    kernel's entry of the kernels line."""
    from elodin_tpu_torch.models import batched_sixdof_init, build_batched_sixdof
    from elodin_tpu_torch.ops import sixdof_kernel as sk

    # 3. kernel vs plain version
    errs = {}
    for n, ticks in ((1024, 50), (MAIN_BODIES, MAIN_TICKS)):
        cols = batched_sixdof_init(n, seed=0)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            args = dict(device="cuda", dtype=dtype)
            ours = sk.sixdof_rollout(*cols, DT, ticks, **args)
            ref = sk.sixdof_rollout_reference(*cols, DT, ticks, **args)
            torch.cuda.synchronize()
            errs[n, dtype] = _compare(
                f"kernel vs plain, {n} bodies x {ticks} ticks, {dtype}",
                _state(ours), _state(ref), SIXDOF_STATE, tol)

    # 4. main path at full width: the ECS tick loop, then the whole-rollout
    # entry point from the same initial columns
    el.set_float_policy("f64")
    world, system = build_batched_sixdof(MAIN_BODIES, seed=0)
    sk.LAUNCHES = 0
    t0 = time.perf_counter()
    exec_ = world.build(system, device="cuda", telemetry_rate=12.0)
    init = {k: exec_.cols[k].clone() for k in ("world_pos", "world_vel", "inertia")}
    t1 = time.perf_counter()
    exec_.run(MAIN_TICKS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ecs_launches = sk.LAUNCHES
    k64 = sk.sixdof_rollout(init["world_pos"], init["world_vel"], init["inertia"],
                            DT, MAIN_TICKS, device="cuda", dtype=torch.float64)
    k32 = sk.sixdof_rollout(init["world_pos"], init["world_vel"], init["inertia"],
                            DT, MAIN_TICKS, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    main_launches = sk.LAUNCHES
    rollout_launches = main_launches - ecs_launches
    print(f"main path launches of sixdof_rk4: ECS World.build -> "
          f"Exec.run({MAIN_TICKS}) {ecs_launches} (eager PyTorch ops; the "
          f"kernel is not behind Exec), whole-rollout entry point "
          f"sixdof_rollout {rollout_launches} (f64 and f32)")
    if ecs_launches != 0:
        raise AssertionError(f"Exec.run launched the kernel {ecs_launches} times")
    if rollout_launches != 2:
        raise AssertionError("sixdof_rollout did not launch the kernel once per call")

    final = interop.columns_to_numpy(exec_.cols, exec_.meta)
    if int(final["tick"][0]) != MAIN_TICKS or exec_.tick() != MAIN_TICKS:
        raise AssertionError(f"tick {final['tick'][0]} / {exec_.tick()} != {MAIN_TICKS}")
    for name in ("world_pos", "world_vel", "world_accel", "force"):
        if not torch.isfinite(exec_.cols[name]).all():
            raise AssertionError(f"{name} is not finite after the run")
    _compare(f"ECS f64 vs kernel f64, {MAIN_BODIES} bodies x {MAIN_TICKS} ticks",
             _state(k64), exec_.cols, SIXDOF_STATE, ECS_F64_TOL)
    _compare(f"ECS f64 vs kernel f32, {MAIN_BODIES} bodies x {MAIN_TICKS} ticks",
             _state(k32), exec_.cols, SIXDOF_STATE, F32_TOL)
    ecs_rate = MAIN_BODIES * MAIN_TICKS / (t2 - t1)
    print(f"ECS eager loop (f64, {MAIN_BODIES} bodies, telemetry every "
          f"{exec_.ticks_per_telemetry} ticks): build {t1 - t0:.3f} s, "
          f"run({MAIN_TICKS}) {t2 - t1:.3f} s, {ecs_rate:.4g} entity-steps/s")

    # 5. kernel and plain version timed at the small and the bench width
    timing = {}
    for n in (1024, BENCH_BODIES):
        cols = batched_sixdof_init(n, seed=0)
        for dtype in (torch.float32, torch.float64):
            args = dict(device="cuda", dtype=dtype)
            dev_cols = [torch.as_tensor(c, **args) for c in cols]
            k_min, k_med = _time_ms(
                lambda: sk.sixdof_rollout(*dev_cols, DT, BENCH_TICKS, **args))
            p_min, p_med = _time_ms(
                lambda: sk.sixdof_rollout_reference(*dev_cols, DT, PLAIN_TICKS, **args))
            k_tick, p_tick = k_min / BENCH_TICKS, p_min / PLAIN_TICKS
            timing[n, dtype] = (k_tick, p_tick)
            print(f"{n} bodies, {dtype}: kernel {BENCH_TICKS} ticks "
                  f"min {k_min:.3f} ms median {k_med:.3f} ms -> {k_tick * 1e3:.4g} us/tick, "
                  f"{n / (k_tick * 1e-3):.4g} entity-steps/s; plain "
                  f"{PLAIN_TICKS} ticks min {p_min:.3f} ms median {p_med:.3f} ms -> "
                  f"{p_tick * 1e3:.4g} us/tick, {n / (p_tick * 1e-3):.4g} "
                  f"entity-steps/s; kernel/plain speedup {p_tick / k_tick:.4g}x")
    if sk.LAUNCHES <= main_launches:
        raise AssertionError("the bench phase did not launch the kernel")

    # 6. device trace
    ops, busy, wall = _device_trace(lambda: exec_.run(TRACE_TICKS))
    print(f"device trace, ECS loop (f64, {MAIN_BODIES} bodies, run({TRACE_TICKS}), "
          f"telemetry every {exec_.ticks_per_telemetry} ticks): {ops / TRACE_TICKS:.1f} "
          f"device ops/tick, device busy {busy / TRACE_TICKS:.4g} ms/tick, wall "
          f"{wall / TRACE_TICKS:.4g} ms/tick, idle share {1 - busy / wall:.2%}")
    cols = batched_sixdof_init(BENCH_BODIES, seed=0)
    for dtype in (torch.float32, torch.float64):
        dev_cols = [torch.as_tensor(c, device="cuda", dtype=dtype) for c in cols]
        ops, busy, wall = _device_trace(lambda: sk.sixdof_rollout(
            *dev_cols, DT, BENCH_TICKS, device="cuda", dtype=dtype))
        print(f"device trace, sixdof_rollout ({dtype}, {BENCH_BODIES} bodies x "
              f"{BENCH_TICKS} ticks, one call): {ops} device ops, busy "
              f"{busy:.4g} ms, wall {wall:.4g} ms, idle share {1 - busy / wall:.2%}")

    # the bound of one tick at the bench width, from the function's
    # operations; the SASS's loop counts beside it
    bounds = {}
    for dtype in (torch.float32, torch.float64):
        _print_sixdof_sass(dtype)
        ops, mufu, n = SIXDOF_TICK_OPS[dtype], SIXDOF_TICK_SFU, BENCH_BODIES
        bounds[dtype] = _bound(n * ops, n * mufu, 30 * n * dtype.itemsize / BENCH_TICKS, dtype)
        ms = timing[n, dtype][0]
        print(f"K1 bound, {dtype}, {n} bodies: the function's {ops} ops and {mufu} SFU "
              f"results per body-tick ->{bounds[dtype][0] * 1e3:.4g} us/tick ({bounds[dtype][1]}); "
              f"kernel {ms * 1e3:.4g} us/tick, {bounds[dtype][0] / ms:.1%} of the bound")

    return {
        "name": "sixdof_rk4",
        "route": "cuda",
        "source": "elodin_tpu_torch/ops/csrc/sixdof_rk4.cu",
        "replaces": "elodin_tpu/ops/sixdof_kernel.py:179",
        "launches": main_launches,
        "max_abs_err": errs[MAIN_BODIES, torch.float32][1],
        "ms": timing[BENCH_BODIES, torch.float32][0],
        "plain_ms": timing[BENCH_BODIES, torch.float32][1],
        "bound_ms": bounds[torch.float32][0],
        "bound_by": _bound_by(bounds[torch.float32][1]),
        "library_ms": None,
        "units": (f"max_abs_err: float32 vs plain at {MAIN_BODIES} bodies x "
                  f"{MAIN_TICKS} ticks; ms, plain_ms, bound_ms: per tick at "
                  f"{BENCH_BODIES} bodies, float32; launches: the two "
                  "sixdof_rollout calls of the main path (f64, f32); library_ms: "
                  "no PyTorch call computes a 6-dof RK4 rollout"),
        "float64": {"max_abs_err": errs[MAIN_BODIES, torch.float64][1],
                    "ms": timing[BENCH_BODIES, torch.float64][0],
                    "plain_ms": timing[BENCH_BODIES, torch.float64][1],
                    "bound_ms": bounds[torch.float64][0],
                    "bound_by": _bound_by(bounds[torch.float64][1])},
    }


def _nbody_exec(el, policy, n, use_kernel, telemetry_rate=None):
    """An n-body Exec on the card: ``build_nbody(n, seed=2)`` under
    ``policy``, built through ``World.build``."""
    from elodin_tpu_torch.models import build_nbody, build_nbody_system

    el.set_float_policy(policy)
    world = build_nbody(n, seed=2)
    return world.build(build_nbody_system(NBODY_DT, use_kernel=use_kernel),
                       device="cuda", simulation_rate=1.0 / NBODY_DT,
                       telemetry_rate=telemetry_rate)


def _run_timed(exec_, ticks):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exec_.run(ticks)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _nbody(el, interop):
    """Phases 7-12: the n-body path and its kernel; returns the kernel's
    entry of the kernels line."""
    from elodin_tpu_torch.entity import TotalEdge
    from elodin_tpu_torch.models import build_nbody
    from elodin_tpu_torch.models.nbody import G
    from elodin_tpu_torch.ops import pairwise as pw
    from elodin_tpu_torch.system import TOTAL_FOLDS, GraphQuery, Query, system

    state = ("world_pos", "world_vel", "world_accel")

    # 7. kernel vs plain version
    def inputs(n, kind, dtype):
        if kind == "nbody":
            _, cols = build_nbody(n, seed=2).snapshot()
            pos, mass, g, eps = cols["world_pos"][:, 4:], cols["inertia"][:, 6], G, 0.0
        else:  # unit cloud, two coincident bodies
            rng = torch.Generator().manual_seed(n)
            pos = torch.randn(n, 3, generator=rng, dtype=torch.float64) * 10
            if n > 7:
                pos[7] = pos[3]
            mass, g, eps = torch.rand(n, generator=rng, dtype=torch.float64) + 1, 1.0, 0.1
        return (torch.as_tensor(pos, device="cuda", dtype=dtype).contiguous(),
                torch.as_tensor(mass, device="cuda", dtype=dtype).contiguous(), g, eps)

    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {}
    for n in PAIRWISE_SHAPES:
        for kind in ("nbody", "cloud"):
            parts = []
            for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
                pos, mass, g, eps = inputs(n, kind, dtype)
                ours = pw.pairwise_gravity(pos, mass, g=g, eps=eps)
                again = pw.pairwise_gravity(pos, mass, g=g, eps=eps)
                ref = pw.pairwise_gravity_reference(pos, mass, g=g, eps=eps)
                torch.cuda.synchronize()
                d = (ours.double() - ref.double()).abs().max().item()
                scale = ref.double().abs().max().item()
                rel = d / scale if scale > 0.0 else d
                errs[n, kind, dtype] = d
                parts.append(f"{str(dtype)[6:]} max|Δ|/max|ref| {rel:.3e} (tol {tol:g}), "
                             f"max|Δ| {d:.3e}")
                if not (torch.isfinite(ours).all() and rel <= tol):
                    raise AssertionError(f"pairwise kernel vs plain {n} {kind} {dtype}: {rel:.3e}")
                if not torch.equal(ours, again):
                    raise AssertionError(f"pairwise kernel {n} {kind} {dtype}: two launches differ")
            print(f"pairwise kernel vs plain, {kind}, {n} bodies, eps {eps}, plan "
                  f"{tuple(pw._launch_plan(n, sm_count))}: " + "; ".join(parts)
                  + "; two launches bitwise equal")

    # 8. main path at full width: World.build -> Exec.run, f32, then f64
    runs = {}
    for policy in ("f32", "f64"):
        exec_ = _nbody_exec(el, policy, NBODY_BODIES, True,
                            telemetry_rate=1.0 / (10 * NBODY_DT))
        mass = exec_.cols["inertia"][:, 6].double()
        p0 = (mass[:, None] * exec_.cols["world_vel"][:, 3:].double()).sum(0)
        pw.LAUNCHES = 0
        wall = _run_timed(exec_, NBODY_TICKS)
        launches = pw.LAUNCHES
        print(f"n-body kernel path ({policy}, {NBODY_BODIES} bodies, "
              f"Exec.run({NBODY_TICKS}), telemetry every "
              f"{exec_.ticks_per_telemetry} ticks): {launches} launches of "
              f"pairwise_gravity, {wall:.4f} s, "
              f"{NBODY_BODIES * NBODY_TICKS / wall:.4g} entity-steps/s, "
              f"{NBODY_BODIES ** 2 * NBODY_TICKS / wall:.4g} pairs/s")
        if launches != NBODY_TICKS:
            raise AssertionError(f"Exec.run({NBODY_TICKS}) launched the kernel {launches} times")
        final = interop.columns_to_numpy(exec_.cols, exec_.meta)
        if int(final["tick"][0]) != NBODY_TICKS or exec_.tick() != NBODY_TICKS:
            raise AssertionError(f"tick {final['tick'][0]} / {exec_.tick()} != {NBODY_TICKS}")
        for name in state + ("force",):
            if not torch.isfinite(exec_.cols[name]).all():
                raise AssertionError(f"{name} is not finite after the run")
        vel = exec_.cols["world_vel"][:, 3:].double()
        drift = ((mass[:, None] * vel).sum(0) - p0).abs().max().item() / (
            (mass[:, None] * vel).abs().sum().item())
        print(f"n-body momentum drift ({policy}): {drift:.4g} (max |Δp| / Σ|m v|)")
        runs[policy] = (exec_, launches, wall)
    nb32 = runs["f32"][0]
    _compare(f"n-body kernel path f32 vs f64, {NBODY_BODIES} bodies x {NBODY_TICKS} ticks",
             nb32.cols, runs["f64"][0].cols, state, F32_TOL)

    # 9. the edge-fold path against the kernel path on the same world, f64
    edge = _nbody_exec(el, "f64", EDGE_BODIES, False)
    kern = _nbody_exec(el, "f64", EDGE_BODIES, True)
    pw.LAUNCHES = 0
    TOTAL_FOLDS.update(dict.fromkeys(TOTAL_FOLDS, 0))
    edge_wall = _run_timed(edge, EDGE_TICKS)
    edge_launches, folds = pw.LAUNCHES, dict(TOTAL_FOLDS)
    kern_wall = _run_timed(kern, EDGE_TICKS)
    print(f"n-body edge-fold path (f64, {EDGE_BODIES} bodies, Exec.run({EDGE_TICKS})): "
          f"{edge_launches} launches of pairwise_gravity, folds {folds}, "
          f"{edge_wall:.4f} s, {EDGE_BODIES * EDGE_TICKS / edge_wall:.4g} entity-steps/s; "
          f"kernel path on the same world {kern_wall:.4f} s, "
          f"{EDGE_BODIES * EDGE_TICKS / kern_wall:.4g} entity-steps/s")
    if edge_launches != 0:
        raise AssertionError(f"the edge-fold path launched the kernel {edge_launches} times")
    if folds != {"dense": EDGE_TICKS, "sequential": 0, "probes": 0}:
        raise AssertionError(f"edge folds took {folds}, not the dense path every tick")
    if edge.tick() != EDGE_TICKS:
        raise AssertionError(f"edge-fold tick {edge.tick()} != {EDGE_TICKS}")
    _compare(f"n-body edge-fold vs kernel path, f64, {EDGE_BODIES} bodies x "
             f"{EDGE_TICKS} ticks", edge.cols, kern.cols, state, ECS_F64_TOL)
    ops, busy, wall = _device_trace(lambda: edge.run(EDGE_TRACE_TICKS))
    print(f"device trace, n-body edge-fold path (f64, {EDGE_BODIES} bodies, "
          f"run({EDGE_TRACE_TICKS})): {ops / EDGE_TRACE_TICKS:.1f} device ops/tick, "
          f"device busy {busy / EDGE_TRACE_TICKS:.4g} ms/tick, wall "
          f"{wall / EDGE_TRACE_TICKS:.4g} ms/tick, idle share {1 - busy / wall:.2%}")

    # 10. the example's form of the fold (examples/n-body/main.py, no
    # additive hint): the probe runs once and rejects it (it drops the
    # carry's torque), so every tick folds sequentially
    @system
    def probed_gravity(graph: GraphQuery[TotalEdge],
                       query: Query[el.WorldPos, el.Inertia]) -> Query[el.Force]:
        def gravity_fn(force, a_pos, a_inertia, b_pos, b_inertia):
            r = a_pos.linear() - b_pos.linear()
            norm = torch.linalg.norm(r)
            f = (G * a_inertia.mass()) * ((b_inertia.mass() / norm**3) * r)
            return el.Force(linear=force.force() - f)

        return graph.edge_fold(query, query, el.Force, el.Force(), gravity_fn)

    el.set_float_policy("f64")
    probed = build_nbody(PROBED_BODIES, seed=2).build(
        el.six_dof(time_step=NBODY_DT, sys=probed_gravity,
                   integrator=el.Integrator.SemiImplicit),
        device="cuda", simulation_rate=1.0 / NBODY_DT)
    kern = _nbody_exec(el, "f64", PROBED_BODIES, True)
    pw.LAUNCHES = 0
    TOTAL_FOLDS.update(dict.fromkeys(TOTAL_FOLDS, 0))
    probed_wall = _run_timed(probed, PROBED_TICKS)
    probed_launches, folds = pw.LAUNCHES, dict(TOTAL_FOLDS)
    kern_wall = _run_timed(kern, PROBED_TICKS)
    print(f"n-body probed edge fold, the example's form (f64, {PROBED_BODIES} bodies, "
          f"Exec.run({PROBED_TICKS})): {probed_launches} launches of pairwise_gravity, "
          f"folds {folds}, {probed_wall:.4f} s, "
          f"{PROBED_BODIES * PROBED_TICKS / probed_wall:.4g} entity-steps/s; kernel "
          f"path on the same world {kern_wall:.4f} s, "
          f"{PROBED_BODIES * PROBED_TICKS / kern_wall:.4g} entity-steps/s")
    if probed_launches != 0:
        raise AssertionError(f"the probed fold launched the kernel {probed_launches} times")
    if folds != {"dense": 0, "sequential": PROBED_TICKS, "probes": 1}:
        raise AssertionError(f"probed folds took {folds}, not one probe and the "
                             "sequential fold every tick")
    _compare(f"n-body probed edge fold vs kernel path, f64, {PROBED_BODIES} bodies x "
             f"{PROBED_TICKS} ticks", probed.cols, kern.cols, state, ECS_F64_TOL)

    # 11. kernel timed at the plan's shapes, the plain version at the main
    # path's width, each against the bound
    timing = {}
    for n in PAIRWISE_TIMED:
        for dtype in (torch.float32, torch.float64):
            pos, mass, g, eps = inputs(n, "nbody", dtype)
            k_min, k_med = _time_ms(lambda: pw.pairwise_gravity(pos, mass, g=g),
                                    reps=5, calls=20)
            ops, busy, _ = _device_trace(
                lambda: [pw.pairwise_gravity(pos, mass, g=g) for _ in range(10)])
            bound, resource = _pairwise_bound(n, dtype)
            timing[n, dtype] = (k_min, bound, resource)
            plan = pw._launch_plan(n, sm_count)
            print(f"pairwise_gravity, {n} bodies, {dtype}: plan threads {plan.threads} "
                  f"R {plan.r} S {plan.s} slice {plan.slice} ({plan.grid(n)} CTAs); kernel "
                  f"min {k_min * 1e3:.4g} us median {k_med * 1e3:.4g} us, "
                  f"{n * n / (k_min * 1e-3):.4g} pairs/s; bound {bound * 1e3:.4g} us "
                  f"({resource}), {bound / k_min:.1%} of the bound; device time per "
                  f"launch (profiler, {ops} device ops in 10 calls) {busy / ops * 1e3:.4g} us, "
                  f"{bound / (busy / ops):.1%} of the bound")
    plain = {}
    for dtype in (torch.float32, torch.float64):
        pos, mass, g, eps = inputs(NBODY_BODIES, "nbody", dtype)
        p_min, p_med = _time_ms(lambda: pw.pairwise_gravity_reference(pos, mass, g=g))
        plain[dtype] = p_min
        k_min = timing[NBODY_BODIES, dtype][0]
        print(f"pairwise_gravity plain version, {NBODY_BODIES} bodies, {dtype}: min "
              f"{p_min * 1e3:.4g} us median {p_med * 1e3:.4g} us, "
              f"{NBODY_BODIES ** 2 / (p_min * 1e-3):.4g} pairs/s; kernel/plain speedup "
              f"{p_min / k_min:.4g}x")

    # 12. device trace of the kernel path, then where its host time goes
    ops, busy, wall = _device_trace(lambda: nb32.run(TRACE_TICKS))
    print(f"device trace, n-body kernel path (f32, {NBODY_BODIES} bodies, "
          f"run({TRACE_TICKS}), telemetry every {nb32.ticks_per_telemetry} ticks): "
          f"{ops / TRACE_TICKS:.1f} device ops/tick, device busy "
          f"{busy / TRACE_TICKS:.4g} ms/tick, wall {wall / TRACE_TICKS:.4g} ms/tick, "
          f"idle share {1 - busy / wall:.2%}")
    _host_profile(f"host profile, n-body kernel path (f32, {NBODY_BODIES} bodies, "
                  f"run({TRACE_TICKS}))", lambda: nb32.run(TRACE_TICKS), TRACE_TICKS)

    main32, main64 = timing[NBODY_BODIES, torch.float32], timing[NBODY_BODIES, torch.float64]
    return {
        "name": "pairwise_gravity",
        "route": "cuda",
        "source": "elodin_tpu_torch/ops/csrc/pairwise_gravity.cu",
        "replaces": "elodin_tpu/ops/pairwise.py:50",
        "launches": runs["f32"][1],
        "max_abs_err": errs[NBODY_BODIES, "nbody", torch.float32],
        "ms": main32[0],
        "plain_ms": plain[torch.float32],
        "bound_ms": main32[1],
        "bound_by": _bound_by(main32[2]),
        "library_ms": None,
        "units": (f"max_abs_err: float32 vs plain, m/s^2, build_nbody({NBODY_BODIES}); "
                  f"ms, plain_ms, bound_ms: per call at {NBODY_BODIES} bodies, float32; "
                  f"launches: Exec.run({NBODY_TICKS}) of the f32 main path; library_ms: "
                  "no PyTorch call computes softened all-pairs gravity"),
        "float64": {"max_abs_err": errs[NBODY_BODIES, "nbody", torch.float64],
                    "ms": main64[0],
                    "plain_ms": plain[torch.float64],
                    "bound_ms": main64[1],
                    "bound_by": _bound_by(main64[2]),
                    "launches": runs["f64"][1]},
    }


def _falcon9(el):
    """Phase 13: the falcon9 RTLS Monte Carlo campaign (no hand kernel)."""
    from elodin_tpu_torch.examples.falcon9 import batched as f9
    from elodin_tpu_torch.monte_carlo import BatchedCampaign
    from elodin_tpu_torch.ops import pairwise as pw
    from elodin_tpu_torch.ops import sixdof_kernel as sk

    el.set_float_policy("f64")
    t0 = time.perf_counter()
    campaign, draws = f9.make_campaign(F9_SAMPLES, seed=0, device="cuda")
    setup_s = time.perf_counter() - t0
    sk.LAUNCHES = pw.LAUNCHES = 0
    result = campaign.run(F9_TICKS, history_every=F9_HISTORY_EVERY,
                          history_components=f9.HISTORY_COMPONENTS, until=f9.until_down)
    torch.cuda.synchronize()
    launches = {"sixdof_rk4": sk.LAUNCHES, "pairwise_gravity": pw.LAUNCHES}
    print(f"falcon9 campaign ({F9_SAMPLES} samples, f64, LHS seed 0): set-up {setup_s:.3f} s, "
          f"BatchedCampaign.run({F9_TICKS}, history_every={F9_HISTORY_EVERY}, until=DOWN) "
          f"{result.wall_seconds:.3f} s, {result.ticks} ticks, guidance ran on "
          f"{campaign.gated_runs} ticks, {F9_SAMPLES * result.ticks / result.wall_seconds:.4g} "
          f"sample-ticks/s; hand-kernel launches {launches} (the path has none)")

    # checks, each raising
    final = {k: result.column(k) for k in result.final}
    for k, v in final.items():
        if not np.isfinite(v.astype(np.float64)).all():
            raise AssertionError(f"falcon9 column {k} is not finite")
    if result.ticks != F9_TICKS or not (final["tick"] == F9_TICKS).all():
        raise AssertionError(f"falcon9 ticks {result.ticks}, tick column "
                             f"{np.unique(final['tick'])}, expected {F9_TICKS}")
    if not (final["lifted"] == 1.0).all():
        raise AssertionError(f"{int((final['lifted'] != 1.0).sum())} samples did not lift off")
    if campaign.gated_runs != F9_TICKS // 5:
        raise AssertionError(f"guidance ran {campaign.gated_runs} times in {F9_TICKS} ticks")
    for k, hist in result.history.items():
        if not np.array_equal(hist[-1], final[k]):
            raise AssertionError(f"the last history emit of {k} is not the final state")
    print(f"falcon9 checks: every column finite, tick == {F9_TICKS} and lifted == 1 in every "
          f"sample, the last of {result.history['phase'].shape[0]} history emits equals the "
          f"final state bitwise, phases {sorted(set(np.unique(final['phase']).tolist()))}")

    # the first samples against the port on the CPU from the same draws
    world, system = f9.build(None, sensors=False)
    cpu = BatchedCampaign(world, system, F9_CPU_SAMPLES,
                          f9.overrides_of({k: v[:F9_CPU_SAMPLES] for k, v in draws.items()}),
                          simulation_rate=f9.SIM_RATE_HZ, device="cpu")
    t0 = time.perf_counter()
    cpu_result = cpu.run(F9_TICKS, history_every=F9_HISTORY_EVERY,
                         history_components=f9.HISTORY_COMPONENTS, until=f9.until_down)
    cpu_s = time.perf_counter() - t0
    errs = f9.state_errors({k: v[:F9_CPU_SAMPLES] for k, v in final.items()},
                           {k: cpu_result.column(k) for k in cpu_result.final})
    worst = max(errs, key=errs.get)
    print(f"falcon9 card vs CPU, first {F9_CPU_SAMPLES} samples x {F9_TICKS} ticks (CPU run "
          f"{cpu_s:.2f} s): worst max|Δ|/scale {errs[worst]:.3e} at {worst} (tol {F9_TOL:g}); "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(errs.items(), key=lambda kv: -kv[1])[:5]))
    if not errs[worst] <= F9_TOL:
        raise AssertionError(f"falcon9 card vs CPU: {worst} {errs[worst]:.3e} exceeds {F9_TOL:g}")

    # ms/tick on ticks with and without guidance (one tick per run, synced)
    gated, plain = [], []
    for _ in range(F9_TIMED_TICKS):
        before = campaign.gated_runs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        campaign.run(1)
        torch.cuda.synchronize()
        (gated if campaign.gated_runs > before else plain).append(
            (time.perf_counter() - t0) * 1e3)
    g_ms, p_ms = statistics.median(gated), statistics.median(plain)
    every = f9.GUIDANCE_EVERY_TICKS
    mean_ms = (g_ms + (every - 1) * p_ms) / every
    print(f"falcon9 ms/tick at {F9_SAMPLES} samples: with guidance median {g_ms:.4g} "
          f"(min {min(gated):.4g}, {len(gated)} ticks), without guidance median {p_ms:.4g} "
          f"(min {min(plain):.4g}, {len(plain)} ticks), 1-in-{every} schedule "
          f"{mean_ms:.4g} ms/tick, {F9_SAMPLES / (mean_ms * 1e-3):.4g} sample-ticks/s")
    print(f"falcon9 projected full mission at {F9_SAMPLES} samples: {JAX_F9_ALL_DOWN_TICK} "
          f"ticks (all-DOWN tick of the JAX run on the CPU, {JAX_F9_SAMPLES} samples) -> "
          f"{_f9_projection(g_ms, p_ms, JAX_F9_ALL_DOWN_TICK, every):.4g} s, guidance 1 tick "
          f"in {every} until the first DESCENT (tick {JAX_F9_FIRST_DESCENT_TICK}) and every "
          f"tick after; {_f9_projection(g_ms, p_ms, f9.DEFAULT_MAX_TICKS, every):.4g} s for "
          f"all {f9.DEFAULT_MAX_TICKS} ticks")

    # device trace, then where the host's time per tick goes
    ops, busy, wall = _device_trace(lambda: campaign.run(TRACE_TICKS))
    print(f"device trace, falcon9 campaign ({F9_SAMPLES} samples, f64, run({TRACE_TICKS})): "
          f"{ops / TRACE_TICKS:.1f} device ops/tick, device busy {busy / TRACE_TICKS:.4g} "
          f"ms/tick, wall {wall / TRACE_TICKS:.4g} ms/tick, idle share {1 - busy / wall:.2%}")
    _host_profile(f"host profile, falcon9 campaign ({F9_SAMPLES} samples, f64, "
                  f"run({TRACE_TICKS}))", lambda: campaign.run(TRACE_TICKS), TRACE_TICKS)


def _no_launches(label, fn):
    """fn() with both kernels' launch counts set to 0 just before it;
    raises unless both read 0 just after."""
    from elodin_tpu_torch.ops import pairwise as pw
    from elodin_tpu_torch.ops import sixdof_kernel as sk

    sk.LAUNCHES = pw.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {"sixdof_rk4": sk.LAUNCHES, "pairwise_gravity": pw.LAUNCHES}
    print(f"{label}: hand-kernel launches {launches} (the path has none)")
    if any(launches.values()):
        raise AssertionError(f"{label} launched a hand kernel: {launches}")
    return out


def _errors_by_group(ours, ref):
    """max |Δ| / max |ref| of every float column of two dicts of numpy
    columns, per channel group of a (..., 7) or (..., 6) trailing axis and
    as one group otherwise (max |Δ| where the reference is all zero)."""
    groups = {7: (("quaternion", slice(0, 4)), ("translation", slice(4, 7))),
              6: (("angular", slice(0, 3)), ("linear", slice(3, 6)))}
    out = {}
    for name, r in ref.items():
        r = np.asarray(r)
        if r.dtype.kind != "f":
            continue
        o, r = np.asarray(ours[name], dtype=np.float64), r.astype(np.float64)
        for group, idx in groups.get(r.shape[-1], ()) or (("all", slice(None)),):
            d, scale = np.abs(o[..., idx] - r[..., idx]).max(), np.abs(r[..., idx]).max()
            out[f"{name}.{group}"] = float(d / scale if scale > 0.0 else d)
    return out


def _hold(label, errs, tol):
    worst = max(errs, key=errs.get)
    print(f"{label}: worst max|Δ|/max|ref| {errs[worst]:.3e} at {worst} (tol {tol:g}); "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(errs.items(), key=lambda kv: -kv[1])[:4]))
    if not errs[worst] <= tol:
        raise AssertionError(f"{label}: {worst} {errs[worst]:.3e} exceeds {tol:g}")


def _verify(label, world, system, rate):
    """verify_trajectory, the card against the CPU (its default devices),
    VERIFY_TICKS ticks at allclose(1e-6, 1e-6); prints the difference."""
    from elodin_tpu_torch import verify

    t0 = time.perf_counter()
    report = _no_launches(f"{label} verify_trajectory", lambda: verify.verify_trajectory(
        world, system, ticks=VERIFY_TICKS, simulation_rate=rate))
    summary = report.pop("_summary")
    worst = sorted(report.items(), key=lambda kv: -kv[1]["metric_rel"])[:3]
    print(f"{label} verify_trajectory ({summary['devices'][1]} vs {summary['devices'][0]}, "
          f"{summary['ticks']} ticks, {time.perf_counter() - t0:.2f} s): max|Δ| "
          f"{summary['max_abs']:.3e}, max |Δ|/(1+|x|) {summary['metric_rel']:.3e}, max "
          f"relative {summary['max_rel']:.3e}, largest excess over 1e-6 * scale "
          f"{summary['max_excess']:.3e} (allclose atol 1e-6 passes); by column: "
          + ", ".join(f"{k} {v['metric_rel']:.2e}" for k, v in worst))
    return summary


def _baselined(el, example):
    """The first part of phases 14, 15 and 19: one of the baselined
    examples through Exec on the card and its CSV archive against its
    stored baseline (``regress.check``, which raises on a failure)."""
    from elodin_tpu_torch import regress

    el.set_float_policy("f64")
    exec_, wall, n, share = _no_launches(f"{example} regress.check",
                                         lambda: regress.check(example, device="cuda"))
    if exec_.cols["tick"].device.type != "cuda" or exec_.tick() != regress.TICKS:
        raise AssertionError(f"{example}: not run on the card to tick {regress.TICKS}")
    base = os.path.relpath(regress.baseline_dir(example), regress.REPO)
    print(f"{example} on the card (f64, Exec.run({regress.TICKS}) {wall:.3f} s, "
          f"{wall / regress.TICKS * 1e3:.4g} ms/tick): {n} baselined CSV files of "
          f"{base}, vector cells parsed, 0 failures; the largest share of its "
          f"tolerance (abs or rel 1e-4) an element used: {share:.3g}")


def _rocket_cpu_reference(n, ticks):
    """The batched rocket's ``n`` samples on the CPU, run in a worker
    process: (final columns, seconds)."""
    import elodin_tpu_torch as el
    from elodin_tpu_torch.examples.rocket import batched as rkb

    torch.set_num_threads(1)
    el.set_float_policy("f64")
    t0 = time.perf_counter()
    result = rkb.make_campaign(n, device="cpu").run(ticks)
    return {k: result.column(k) for k in result.final}, time.perf_counter() - t0


def _landing_cpu_reference(draws, ticks):
    """The landing campaign from ``draws`` on the CPU, run in a worker
    process: (final columns, scores, seconds)."""
    import elodin_tpu_torch as el
    from elodin_tpu_torch.examples.monte_carlo import batched as mc
    from elodin_tpu_torch.monte_carlo import BatchedCampaign

    torch.set_num_threads(1)
    el.set_float_policy("f64")
    t0 = time.perf_counter()
    world, system = mc.build(None)
    result = BatchedCampaign(world, system, len(draws["dry_mass"]), mc.overrides_of(draws),
                             simulation_rate=mc.SIMULATION_RATE_HZ, device="cpu").run(ticks)
    return ({k: result.column(k) for k in result.final}, mc.scores(result),
            time.perf_counter() - t0)


def _examples(el):
    """Phases 14-18: the rocket, three-body and landing Monte Carlo
    examples and falcon9 through verify (no hand kernel)."""
    from elodin_tpu_torch import regress
    from elodin_tpu_torch.examples.falcon9 import sim as f9_sim
    from elodin_tpu_torch.examples.monte_carlo import batched as mc

    # 14-15. the baselined examples through Exec and the CSV gate
    for example in ("three-body", "rocket"):
        _baselined(el, example)
    _clock("phases 14-15, Exec and the CSV gate")

    # the CPU references of phases 17-18 run in two workers while the
    # verify runs (phases 14-16) take place; none runs in a timed run
    draws = {k: v[:MC_CPU_SAMPLES] for k, v in mc.dispersions(MC_SAMPLES, seed=0).items()}
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=2, mp_context=multiprocessing.get_context("spawn")) as pool:
        rocket_cpu = pool.submit(_rocket_cpu_reference, ROCKET_CPU_SAMPLES, ROCKET_TICKS)
        landing_cpu = pool.submit(_landing_cpu_reference, draws, MC_TICKS)
        for example in ("three-body", "rocket"):
            mod = regress.baselined_examples()[example]
            _verify(example, mod.build_world(), mod.build_system(), regress.simulation_rate(mod))
        # 16. falcon9 without sensors through verify
        el.set_float_policy("f64")
        world, system = f9_sim.build(None, sensors=False)
        _verify("falcon9 without sensors (build(None, sensors=False), the campaign's "
                "mission)", world, system, f9_sim.SIM_RATE_HZ)
        _clock("phases 14-16, verify")
        t1 = time.perf_counter()
        rocket_ref, landing_ref = rocket_cpu.result(), landing_cpu.result()
    print(f"CPU references of phases 17-18 (two workers, {time.perf_counter() - t0:.2f} s "
          f"after they were submitted, {time.perf_counter() - t1:.2f} s of it waited for after "
          f"the verify runs)")

    _batched_rocket(el, rocket_ref)
    _clock("phase 17")
    _landing(el, landing_ref)
    _clock("phase 18")


def _batched_rocket(el, cpu_ref):
    """Phase 17: the batched rocket at 1024 x 240 against its samples on
    the CPU (``cpu_ref``: final columns and the CPU run's seconds)."""
    from elodin_tpu_torch.examples.rocket import batched as rkb

    el.set_float_policy("f64")
    campaign = rkb.make_campaign(ROCKETS, device="cuda")
    result = _no_launches(f"batched rocket run({ROCKET_TICKS})",
                          lambda: campaign.run(ROCKET_TICKS))
    final = {k: result.column(k) for k in result.final}
    spread = 0.0
    for k, v in final.items():
        if not np.isfinite(v.astype(np.float64)).all():
            raise AssertionError(f"batched rocket column {k} is not finite")
        if not np.array_equal(v, np.broadcast_to(v[:1], v.shape)):
            d = np.abs(v.astype(np.float64) - v[:1]).max()
            spread = max(spread, d / max(np.abs(v[:1].astype(np.float64)).max(), 1e-300))
    print(f"batched rocket ({ROCKETS} rockets x {ROCKET_TICKS} ticks, f64): "
          f"{result.wall_seconds:.3f} s, {result.wall_seconds / ROCKET_TICKS * 1e3:.4g} ms/tick, "
          f"{ROCKETS * ROCKET_TICKS / result.wall_seconds:.4g} entity-steps/s; every column "
          f"finite; the {ROCKETS} samples "
          + ("bitwise equal" if spread == 0.0 else f"differ by up to {spread:.3e} of max |x|"))
    if spread > 1e-15:
        raise AssertionError(f"batched rocket samples differ by {spread:.3e}")
    cpu, cpu_s = cpu_ref
    _hold(f"batched rocket card vs CPU, first {ROCKET_CPU_SAMPLES} samples x {ROCKET_TICKS} ticks "
          f"(CPU run {cpu_s:.2f} s)",
          _errors_by_group({k: v[:ROCKET_CPU_SAMPLES] for k, v in final.items()}, cpu), EX_TOL)
    _trace_and_profile(f"batched rocket ({ROCKETS} rockets, f64", campaign, ROCKET_TRACE_TICKS)


def _landing(el, cpu_ref):
    """Phase 18: the whole landing campaign, 10000 x 2400, against the JAX
    package's outcome and its first samples on the CPU (``cpu_ref``: final
    columns, scores and the CPU run's seconds)."""
    from elodin_tpu_torch.examples.monte_carlo import batched as mc

    el.set_float_policy("f64")
    t0 = time.perf_counter()
    campaign, _ = mc.make_campaign(MC_SAMPLES, seed=0, device="cuda")
    setup_s = time.perf_counter() - t0
    result = _no_launches(f"landing campaign run({MC_TICKS})", lambda: campaign.run(MC_TICKS))
    out, scores = mc.outcome(result), mc.scores(result)
    final = {k: result.column(k) for k in result.final}
    for k, v in final.items():
        if not np.isfinite(v.astype(np.float64)).all():
            raise AssertionError(f"landing campaign column {k} is not finite")
    print(f"landing campaign ({MC_SAMPLES} samples x {MC_TICKS} ticks, f64, LHS seed 0): set-up "
          f"{setup_s:.3f} s, wall {result.wall_seconds:.3f} s, "
          f"{result.wall_seconds / MC_TICKS * 1e3:.4g} ms/tick, "
          f"{result.rollouts_per_second:.4g} rollouts/s, "
          f"{MC_SAMPLES * result.ticks / result.wall_seconds:.4g} sample-ticks/s; outcome "
          + json.dumps({k: out[k] for k in ("landed_frac", "soft_landing_frac",
                                            "mean_touchdown_vz", "mean_landing_offset_m")}))
    for key, ref in (("landed_frac", JAX_MC_LANDED_FRAC), ("soft_landing_frac", JAX_MC_SOFT_FRAC)):
        off = round(abs(out[key] - ref) * MC_SAMPLES)
        print(f"  {key} {out[key]} against the JAX package's {ref}: {off} samples apart "
              f"(at most {MC_FRAC_SLACK})")
        if off > MC_FRAC_SLACK:
            raise AssertionError(f"landing campaign {key} {out[key]} vs JAX {ref}")
    n = MC_CPU_SAMPLES
    cpu, cpu_scores, cpu_s = cpu_ref
    for flag in ("landed", "soft"):
        if not np.array_equal(scores[flag][:n], cpu_scores[flag]):
            raise AssertionError(f"landing campaign: {flag} flags differ from the CPU's")
    errs = _errors_by_group({k: v[:n] for k, v in final.items()}, cpu)
    errs["touchdown_vz (scores)"] = _errors_by_group(
        {"v": scores["touchdown_vz"][:n]}, {"v": cpu_scores["touchdown_vz"]})["v.all"]
    _hold(f"landing campaign card vs CPU, first {n} samples x {MC_TICKS} ticks from the same "
          f"draws (CPU run {cpu_s:.2f} s; landed and soft flags equal)", errs, EX_TOL)
    _trace_and_profile(f"landing campaign ({MC_SAMPLES} samples, f64", campaign)


def _rtf_exec(el, mod, device):
    """An Exec of an example built as ``bench.py``'s RTF leg builds it:
    ``SIMULATION_RATE`` or ``1 / SIM_TIME_STEP``, no history kept."""
    el.set_float_policy("f64")
    rate = getattr(mod, "SIMULATION_RATE", None) or 1.0 / mod.SIM_TIME_STEP
    exec_ = mod.build_world().build(mod.build_system(), simulation_rate=rate, device=device)
    exec_.record_history = False
    return exec_, rate


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _rtf(el, example, mod, device):
    """Phase 21 for one example on one device: a warm-up run, then
    RTF_REPEATS timed runs of RTF_TICKS ticks (a host clock around each,
    ended by a synchronise); returns (the Exec, each run's real-time
    factor)."""
    ticks = RTF_TICKS[example]
    exec_, rate = _rtf_exec(el, mod, device)
    exec_.run(RTF_WARMUP_TICKS, show_progress=False)
    rtfs = []
    for _ in range(RTF_REPEATS):
        _sync(device)
        t0 = time.perf_counter()
        exec_.run(ticks, show_progress=False)
        _sync(device)
        rtfs.append(ticks / rate / (time.perf_counter() - t0))
    med = statistics.median(rtfs)
    print(f"{example} RTF on {device} (f64, {ticks} ticks at {rate:g} Hz = {ticks / rate:g} "
          f"simulated s, {RTF_REPEATS} runs after a {RTF_WARMUP_TICKS}-tick warm-up): median "
          f"{med:.4g} (min {min(rtfs):.4g}, max {max(rtfs):.4g}, spread "
          f"{(max(rtfs) - min(rtfs)) / med:.1%} of the median), {1e3 / rate / med:.4g} ms/tick "
          f"at the median; runs " + ", ".join(f"{r:.4g}" for r in rtfs))
    _all_finite(f"{example} on {device}", exec_)
    return exec_, rtfs


def _all_finite(label, exec_):
    for name, col in exec_.cols.items():
        if col.is_floating_point() and not torch.isfinite(col).all():
            raise AssertionError(f"{label}: {name} is not finite")


def _rtf_trace_profile(el, examples):
    """Phases 21-22 (and 25's) for each example: the real-time factor on the
    card and on the CPU, then the device trace and a cProfile of the host
    on the card."""
    from elodin_tpu_torch import regress

    for example in examples:
        mod = regress.baselined_examples()[example]
        card, card_rtf = _no_launches(f"{example} RTF on the card",
                                      lambda: _rtf(el, example, mod, "cuda"))
        _, cpu_rtf = _no_launches(f"{example} RTF on the CPU",
                                  lambda: _rtf(el, example, mod, "cpu"))
        print(f"{example}: the CPU over the card, median RTF "
              f"{statistics.median(cpu_rtf) / statistics.median(card_rtf):.3g}x")
        _clock(f"RTF, {example}")
        _trace_exec(f"{example} on the card (f64, Exec.run({SINGLE_TRACE_TICKS}), no history)",
                    card)


def _trace_exec(label, exec_):
    """The device trace and a cProfile of SINGLE_TRACE_TICKS ticks of an
    Exec on the card."""
    n = SINGLE_TRACE_TICKS
    ops, busy, wall = _no_launches(
        f"{label} device trace",
        lambda: _device_trace(lambda: exec_.run(n, show_progress=False)))
    print(f"device trace, {label}: {ops / n:.1f} device ops/tick, device busy "
          f"{busy / n:.4g} ms/tick, wall {wall / n:.4g} ms/tick, idle share {1 - busy / wall:.2%}")
    _host_profile(f"host profile, {label}", lambda: exec_.run(n, show_progress=False), n)


def _single_entity(el):
    """Phases 19-23: the drone and the cube-sat (no hand kernel)."""
    from elodin_tpu_torch import regress

    examples = ("drone", "cube-sat")
    # 19. the CSV gate on the card
    for example in examples:
        _baselined(el, example)
    _clock("phase 19, Exec and the CSV gate")
    # 20. the card against the CPU
    for example in examples:
        mod = regress.baselined_examples()[example]
        el.set_float_policy("f64")
        _verify(example, mod.build_world(), mod.build_system(), regress.simulation_rate(mod))
    _clock("phase 20, verify")
    # 21. real-time factor on the card and on the CPU; 22. trace and profile
    _rtf_trace_profile(el, examples)
    _clock("phases 21-22")
    # 23. card facts
    try:
        import pyarrow
        arrow = f"pyarrow {pyarrow.__version__} imports"
    except ImportError as e:
        arrow = f"pyarrow does not import ({e})"
    print(f"card facts: torch.cuda.device_count() {torch.cuda.device_count()}; {arrow}")


def _ulps(ref, ours) -> float:
    """The largest |ours - ref| in ulps of ref, in ref's dtype."""
    ref, ours = ref.cpu().numpy(), ours.cpu().numpy()
    d = np.abs(ours.astype(np.float64) - ref.astype(np.float64))
    return float((d / np.spacing(np.abs(ref)).astype(np.float64)).max())


def _threefry_draws(tf, seed, n, device):
    """Every threefry output phase 24 holds, for one seed and n counters."""
    key = tf.key(torch.tensor(seed, dtype=torch.int64, device=device))
    data = torch.tensor([-3, -1, 0, 1, 6, 2**31 - 1], dtype=torch.int32, device=device)
    hi, lo = tf.bits(key, (n,), 64)
    return {
        "key": key, "fold_in": tf.fold_in(key, data), "split 2": tf.split(key, 2),
        "split 4": tf.split(key, 4), "bits 32": tf.bits(key, (n,)), "bits 64 hi": hi,
        "bits 64 lo": lo, "uniform f32": tf.uniform(key, (n,), torch.float32),
        "uniform f64": tf.uniform(key, (n,), torch.float64, -3.0, 5.0),
        "normal f32": tf.normal(key, (n,), torch.float32),
        "normal f64": tf.normal(key, (n,), torch.float64),
    }


def _threefry(el):
    """Phase 24: JAX's threefry on the card against the CPU, and the cost
    of the falcon9 suite's noise."""
    from elodin_tpu_torch.examples.falcon9 import sensors as f9_sensors
    from elodin_tpu_torch.ops import threefry as tf

    import scipy.special

    worst, exact = {}, {}
    cases = [(0, THREEFRY_COUNTERS), (20170814, THREEFRY_COUNTERS)] + [
        (seed, THREEFRY_CORNER_COUNTERS) for seed in (2**32 + 5, -7, 2**40)]
    for seed, n in cases:
        card = _no_launches(f"threefry seed {seed}, {n} counters",
                            lambda: _threefry_draws(tf, seed, n, "cuda"))
        cpu = _threefry_draws(tf, seed, n, "cpu")
        for name, ref in cpu.items():
            if not name.startswith("normal"):
                if not torch.equal(ref, card[name].cpu()):
                    raise AssertionError(f"threefry seed {seed}: {name} differs on the card")
                continue
            dtype = ref.dtype
            worst[dtype] = max(worst.get(dtype, 0.0), _ulps(ref, card[name]))
            # sqrt(2) * a correctly rounded erfinv of the same uniform
            u = tf.uniform(cpu["key"], (n,), dtype, tf._lowest(dtype), 1.0)
            best = torch.as_tensor(np.sqrt(2.0) * scipy.special.erfinv(u.double().numpy())).to(dtype)
            for side, value in (("card", card[name]), ("cpu", ref)):
                exact[side, dtype] = max(exact.get((side, dtype), 0.0), _ulps(best, value))
    print(f"threefry on the card vs the CPU ({len(cases)} seeds, up to {THREEFRY_COUNTERS} "
          f"counters): key, fold_in, split, bits 32/64 and uniform f32/f64 bit for bit; normals, "
          f"largest difference card vs CPU "
          + ", ".join(f"{d} {worst[d]:g} ulps (at most {NORMAL_ULPS[d]})" for d in worst)
          + "; against sqrt(2) * scipy's erfinv of the same uniform: "
          + ", ".join(f"{side} {d} {v:g} ulps" for (side, d), v in exact.items()))
    if any(worst[d] > NORMAL_ULPS[d] for d in worst):
        raise AssertionError(f"threefry normals on the card differ by {worst} ulps")

    # the falcon9 suite's noise: one tick's six streams, batched and one by one
    count = torch.tensor(1234.0, dtype=torch.float64, device="cuda")
    tick = torch.tensor(1234, dtype=torch.int64, device="cuda")
    draws = [(tick, 1, (3,), f9_sensors.IMU_ACCEL_SIGMA), (tick, 2, (3,), f9_sensors.IMU_GYRO_SIGMA),
             (count, 3, (3,), f9_sensors.GPS_POS_SIGMA), (count, 4, (3,), f9_sensors.GPS_VEL_SIGMA),
             (count, 5, (), f9_sensors.RADAR_SIGMA_M), (tick, 6, (4,), f9_sensors.PRESSURE_SIGMA_PA)]
    one_by_one = lambda: [f9_sensors.noise(*d) for d in draws]  # noqa: E731
    batched = lambda: f9_sensors.noise_streams(draws)  # noqa: E731
    if not all(torch.equal(a, b) for a, b in zip(batched(), one_by_one())):
        raise AssertionError("noise_streams differs from noise on the card")
    for label, fn in (("one noise call (3 lanes)", lambda: f9_sensors.noise(*draws[0])),
                      ("six noise calls (one tick's streams)", one_by_one),
                      ("one noise_streams call (the six streams, 17 lanes)", batched)):
        ops, busy, _ = _no_launches(f"falcon9 {label} trace", lambda: _device_trace(fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NOISE_CALLS):
            fn()
        host_us = (time.perf_counter() - t0) / NOISE_CALLS * 1e6
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / NOISE_CALLS * 1e6
        print(f"falcon9 noise on the card, {label}: {ops} device ops, device busy "
              f"{busy * 1e3:.4g} us; host {host_us:.4g} us a call ({NOISE_CALLS} calls back to "
              f"back), {wall_us:.4g} us a call with the card synchronised at the end")


def _baselined_examples_phase(el):
    """Phase 25: ball, linalg and stablehlo through the CSV gate, verify,
    the real-time factor, the device trace and a host profile."""
    from elodin_tpu_torch import regress

    examples = ("ball", "linalg", "stablehlo")
    for example in examples:
        _baselined(el, example)
    for example in examples:
        mod = regress.baselined_examples()[example]
        el.set_float_policy("f64")
        _verify(example, mod.build_world(), mod.build_system(), regress.simulation_rate(mod))
    _clock("phase 25, the CSV gate and verify")
    _rtf_trace_profile(el, examples)


def _f9_exec(el, sensors, policy="f64", history=False):
    """The falcon9 mission, ``build(None, sensors=sensors)``, through
    ``World.build`` on the card."""
    from elodin_tpu_torch.examples.falcon9 import sim as f9_sim

    el.set_float_policy(policy)
    world, system = f9_sim.build(None, sensors=sensors)
    exec_ = world.build(system, simulation_rate=f9_sim.SIM_RATE_HZ, device="cuda")
    exec_.record_history = history
    return exec_


def _falcon9_sensors(el):
    """Phase 26: falcon9 with sensors through verify under f64 and the mixed
    policy, and its tick with and without sensors."""
    from elodin_tpu_torch.examples.falcon9 import sim as f9_sim

    for policy, leg in (("f64", "the JAX bench's f64 leg"), ("mixed", "its mixed leg")):
        el.set_float_policy(policy)
        world, system = f9_sim.build(None)
        summary = _verify(f"falcon9 with sensors, {policy} policy ({leg})", world, system,
                          f9_sim.SIM_RATE_HZ)
        if not summary["metric_rel"] <= F9_MIXED_TOL:
            raise AssertionError(f"falcon9 with sensors, {policy}: max |Δ|/(1+|x|) "
                                 f"{summary['metric_rel']:.3e} exceeds {F9_MIXED_TOL:g}")
    el.set_float_policy("f64")
    _clock("phase 26, verify")
    for sensors in (True, False):
        label = "with" if sensors else "without"
        exec_ = _f9_exec(el, sensors)
        exec_.run(10, show_progress=False)
        wall = _no_launches(f"falcon9 {label} sensors Exec.run({F9_SENSOR_TICKS})",
                            lambda: _run_timed(exec_, F9_SENSOR_TICKS))
        _all_finite(f"falcon9 {label} sensors", exec_)
        print(f"falcon9 {label} sensors on the card (f64, one mission, Exec.run("
              f"{F9_SENSOR_TICKS}) from tick 10, no history): {wall / F9_SENSOR_TICKS * 1e3:.4g} "
              f"ms/tick, RTF {F9_SENSOR_TICKS / f9_sim.SIM_RATE_HZ / wall:.4g}")
        _trace_exec(f"falcon9 {label} sensors on the card (f64, Exec.run("
                    f"{SINGLE_TRACE_TICKS}), no history)", exec_)


def _checkpoints(el):
    """Phase 27: restore, save_checkpoint / load_checkpoint and
    checkpoint_first_tick on the card."""
    import shutil
    import tempfile

    from elodin_tpu_torch import verify

    exec_ = _f9_exec(el, True, history=True)
    exec_._history.max_bytes = CKPT_HISTORY_BYTES
    tmp = tempfile.mkdtemp(prefix="chip-smoke-checkpoint-")
    try:
        _no_launches(f"falcon9 Exec.run({CKPT_TICKS})", lambda: exec_.run(CKPT_TICKS))
        first = {k: v.clone() for k, v in exec_.cols.items()}
        spills = len(exec_._history._spills["world_pos"])
        path = os.path.join(tmp, "state.npz")
        exec_.save_checkpoint(path)
        exec_.restore(CKPT_RESTORE)
        rows = len(exec_._history.series("world_pos"))
        if exec_.tick() != CKPT_RESTORE or rows != CKPT_RESTORE + 1:
            raise AssertionError(f"restore({CKPT_RESTORE}): tick {exec_.tick()}, {rows} rows")
        _no_launches(f"falcon9 Exec.run({CKPT_TICKS - CKPT_RESTORE}) after restore",
                     lambda: exec_.run(CKPT_TICKS - CKPT_RESTORE))
        rerun = [k for k in first if not torch.equal(first[k], exec_.cols[k])]
        rows = len(exec_._history.series("world_pos"))
        if rerun or rows != CKPT_TICKS + 1:
            raise AssertionError(f"after restore and re-run: {rows} rows, differing {rerun}")
        exec_.run(CKPT_MORE)
        exec_.load_checkpoint(path)
        loaded = [k for k in first if not torch.equal(first[k], exec_.cols[k])]
        if loaded:
            raise AssertionError(f"load_checkpoint differs in {loaded}")
        os.environ[verify.DEBUG_DIR_ENV] = os.path.join(tmp, "debug")
        out = verify.checkpoint_first_tick(exec_)
        with np.load(os.path.join(out, "tick1_outputs.npz")) as tick1:
            if int(tick1["tick"][0]) != CKPT_TICKS + 1:
                raise AssertionError(f"checkpoint_first_tick: tick {tick1['tick']}")
        print(f"checkpoints on the card (falcon9 with sensors, f64, history spilled to its spool "
              f"in {spills} chunks by tick {CKPT_TICKS}): restore({CKPT_RESTORE}) cut the history "
              f"to {CKPT_RESTORE + 1} rows, {CKPT_TICKS - CKPT_RESTORE} ticks more gave all "
              f"{len(first)} columns bitwise equal to the first run's tick {CKPT_TICKS}; "
              f"save_checkpoint -> {CKPT_MORE} ticks -> load_checkpoint bitwise; "
              f"checkpoint_first_tick wrote {sorted(os.listdir(out))}")
    finally:
        os.environ.pop(verify.DEBUG_DIR_ENV, None)
        shutil.rmtree(tmp, ignore_errors=True)
        if exec_._history._spool_dir:
            shutil.rmtree(exec_._history._spool_dir, ignore_errors=True)


def _trace_and_profile(label, campaign, trace_ticks=TRACE_TICKS):
    """The device trace of ``trace_ticks`` ticks of a campaign, then a
    cProfile of TRACE_TICKS ticks."""
    ops, busy, wall = _device_trace(lambda: campaign.run(trace_ticks))
    print(f"device trace, {label}, run({trace_ticks})): {ops / trace_ticks:.1f} device ops/tick, "
          f"device busy {busy / trace_ticks:.4g} ms/tick, wall {wall / trace_ticks:.4g} ms/tick, "
          f"idle share {1 - busy / wall:.2%}")
    _host_profile(f"host profile, {label}, run({TRACE_TICKS}))",
                  lambda: campaign.run(TRACE_TICKS), TRACE_TICKS)


def _f9_projection(gated_ms, plain_ms, ticks, every):
    """Seconds for ``ticks`` ticks: guidance on 1 tick in ``every`` until
    the first sample reaches DESCENT, on every tick after."""
    early = min(ticks, JAX_F9_FIRST_DESCENT_TICK)
    n_gated = early // every + (ticks - early)
    return (n_gated * gated_ms + (ticks - n_gated) * plain_ms) / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1

    import elodin_tpu_torch as el
    from elodin_tpu_torch import interop
    from elodin_tpu_torch.ops import _build, pairwise, sixdof_kernel

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        for job in [pool.submit(m.build) for m in (sixdof_kernel, pairwise)]:
            job.result()
    print(f"build: sixdof_rk4 and pairwise_gravity in {time.perf_counter() - t0:.2f} s")
    for name in ("sixdof_rk4", "pairwise_gravity"):
        print(_build.build_log(name).strip())

    _clock("phases 1-2")
    kernels = [_sixdof(el, interop)]
    _clock("phases 3-6")
    kernels.append(_nbody(el, interop))
    _clock("phases 7-12")
    _falcon9(el)
    _clock("phase 13")
    _examples(el)
    _single_entity(el)
    _threefry(el)
    _clock("phase 24")
    _baselined_examples_phase(el)
    _clock("phase 25")
    _falcon9_sensors(el)
    _clock("phase 26")
    _checkpoints(el)
    _clock("phase 27")

    if any(m == "jax" or m.startswith(("jax.", "elodin_tpu.")) or m == "elodin_tpu"
           for m in sys.modules):
        raise AssertionError("the port's run imported JAX or the JAX package")

    # 28. results
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
