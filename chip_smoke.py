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
   events, f32 and f64, at 1024 bodies, at the main path's width (8192),
   at a shard's (32768 bodies, a quarter of phase 35's) and at the JAX
   bench's kernel width, 131072 bodies, with the card's SM clock and its
   maximum read just after the kernel's timed calls; the bound of a tick
   at the last three, from the function's operations and SFU results
   (``SIXDOF_TICK_OPS``), beside the launch plan, the registers (ptxas)
   and the loop of the kernel's SASS (cuobjdump, read by
   ``scripts/sass_loops.py``).
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
10. the fold as ``examples/n-body/main.py`` writes it (no additive hint;
    the port's ``examples.n_body.main.gravity``) on ``build_nbody(128)``,
    f64, ``Exec.run(10)``: the additive probe must
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
    device="cuda")`` (LHS draws, f64), then ``BatchedCampaign.run(200,
    history_every=100, history_components=[world_pos, world_vel, phase,
    prop_kg], until=phase == DOWN)``: 2 s of the mission (spool-up,
    release from the hold-down, liftoff, 40 guidance ticks; 300 ticks until
    phase 40 took its time).  Both kernels'
    launch counts are set to 0 before and read after (the path has no
    hand kernel).  Checks: every column finite, tick == 200 and lifted ==
    1 in every sample, guidance on 40 ticks, the last history emit equal
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
    SIM_TIME_STEP``, no history), run ``RTF_TICKS`` ticks (drone 60 at
    300 Hz, cut from bench.py's 1200 to keep the script inside its time;
    cube-sat 60 at 120 Hz, cut from 240) after a 30-tick warm-up,
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
    (``RTF_TICKS``: ball 120 ticks, cut from bench.py's 2400; stablehlo
    300, cut from 1200; linalg 150, cut from 600), the device trace and a
    cProfile of the host.
26. falcon9 with its sensors (``build(None)``): ``verify_trajectory``, the
    card against the CPU, 100 ticks, under f64 (the JAX bench's leg) and
    under the mixed policy at max |Δ|/(1+|x|) ≤ 1e-6 (its mixed leg); then
    ``Exec.run`` of the mission with and without sensors on the card (no
    history): ms/tick over 50 ticks (cut from 100), device ops per tick and
    idle share,
    and a cProfile of the tick with sensors.
27. Exec checkpoints on the card, on falcon9 with sensors and a history
    small enough to spill to its spool: 30 ticks, ``restore(10)`` (the
    history cut to 11 rows, spilled chunks included), 20 more ticks, and
    every column bitwise equal to the first run's tick 30;
    ``save_checkpoint`` then ``load_checkpoint`` after 5 more ticks,
    bitwise; ``verify.checkpoint_first_tick`` writes its three files.

The sim's own entry points: the CLI, lockstep, the telemetry pump and the
process-per-sample campaign (eager PyTorch ops; no hand kernel: both
kernels' launch counts are set to 0 before each of phases 28-31 and must
read 0 after it, in this process; the children of phases 28 and 31 run
the same code).  Every child is started with ``subprocess`` from this
process (never a fork of it), and a nonzero exit fails the script; each
timed figure of phases 29-30 is taken 2 times (median and spread; 3
until phases 32-34 took their time):

28. the CLI on the card: ``python -m elodin_tpu_torch.examples.drone.main
    bench --ticks 150`` and ``python -m
    elodin_tpu_torch.examples.cube_sat.main bench --ticks 120`` (300 and
    240 until phase 39 took its time), 1 child each (3 until phases 32-34
    took their time): the printed tick time and
    RTF beside phase 21's in-process RTF;
    each child's wall split into the interpreter's start, the torch and
    port import and the CUDA initialisation (one probe child) and the
    ticks (the printed tick time); ``components`` of the drone (run by the
    probe child as ``python -m`` runs it) parses and names every file of
    its CSV baseline.
29. lockstep at the betaflight-sitl hover's 1 kHz
    (``examples.betaflight_sitl``): ``run(ticks=2000)`` pipelined with the
    ``controller.py`` process, strict at 1000 ticks, and
    ``run_batched(trips=40, hold=64)``, on the card and on the CPU: Hz,
    missed replies and the altitude held within 0.5 m (the gate); then the
    session on the card against the CPU for the same 50 commands at hold 1
    and 4, within 1e-12.
30. the telemetry pump on the card: the cube-sat, 80 ticks in 1 window
    (``REPEATS``; 2 until phase 40), without history, with history through the pump and through the
    synchronous path (``Exec._sync_history``), the windows interleaved:
    ms per tick of the step loop and of the pump's drain after it; the two
    histories bitwise equal (the gate); the pump's stall count; a device
    trace of 10 ticks with history: device ops per tick and idle share.
31. the process campaign on the card: ``monte_carlo.run_campaign`` on
    ``examples/monte_carlo/main.py``, 4 landing samples (LHS seed 0, the
    five dispersions; 8 until phases 32-34 took their time) at the full
    2400 ticks, 4 workers, ``device="cuda"``; then rows 0-3 of the same
    plan with ``device="cpu"`` (a resume that lists the plan's later rows,
    if any, as done).  Every run valid; each card
    sample's ``touchdown_vz`` and ``landing_offset`` within 1e-9 of the
    CPU's from the same row; the campaign's wall, each run's ``wall_s``,
    RTF and start-up share (``perf.csv``), the peak RSS
    (``resources.csv``) and the card's memory in use while it ran
    (nvidia-smi); samples/s beside phase 18's batched campaign.

Differentiable rollouts, the rest of adcs and gravity/j2 (eager PyTorch
ops and autograd; no hand kernel: both kernels' launch counts are set to
0 before each of phases 32-34 and must read 0 after it), in f64; card
against CPU at ``GRAD_TOL`` (1e-9, max |Δ| / max |ref|) unless named:

32. orbit-retarget (``examples.orbit_retarget``, ``el.rollout`` through
    its 504 RK4 ticks): the gradient at 60 ticks on the card against the
    central finite difference (eps 1e-6, rtol 1e-5, atol 1e-8); 1 Adam
    step from ``solve``'s start (``torch.optim.Adam(lr=3e-2)``), cut to
    168 ticks (``ORBIT_ADAM_TICKS``; 504 until the script overran its
    time), on the card and on the CPU, its loss, gradient and iterate held card
    against CPU, ms per value-and-grad and step, the peak card memory
    above what was allocated before it; one step with 8 remat segments
    on the card, cut to 88 ticks (``ORBIT_REMAT_TICKS``; 504 until phase
    39 took its time), held against a plain step at that depth (value
    rtol 1e-12, gradient 1e-9; bitwise printed), the ms and peak memory
    of each; the device
    trace of one value-and-grad cut to 16 ticks (device ops a tick,
    forward and backward, idle share).
33. neural-hover (``examples.neural_hover``) at its full width and
    horizon, 16 starts x 240 ticks under ``torch.func.vmap``: 1 Adam
    step from the threefry initialisation on the card and on the CPU,
    losses, gradients and weights held card against CPU, ms per step,
    the peak card memory; the device trace of one value-and-grad cut to
    24 ticks; ``evaluate`` finite.
34. cube-sat-pysim (``examples.cube_sat_pysim``, ``World.to_jax`` /
    ``TorchSim``) on the card, 2 chunks of 30 ticks, against ``Exec`` on
    the card: the angular speeds and every column ≤ 1e-12; the UKF (50
    updates, 1e-10), ``MagKal`` (300 readings, 1e-8: its covariance
    shrinks by 10 orders), ``magical_calibrate``, ``triad`` and ``J2``
    (1e-12), card against CPU; ``sixdof_rollout`` and
    ``pairwise_gravity`` refuse an input that requires grad on the card.

The split over cards (``parallel/mesh.py``), on a mesh of 4 shards
(``["cuda:0"] * 4`` on one card: repeated entries; ``cuda:0..3`` on four)
and, with 2 or more cards other than 4, on every card too; the devices of
each mesh are printed:

35. the sharded path at full width, with both launch counts set to 0 just
    before and read just after: ``sixdof_rollout_sharded`` at 131072
    bodies x 4000 ticks and ``pairwise_gravity_sharded`` at 16384 bodies,
    each in f32 and f64, must launch each kernel once a shard and call.
    Then K1 sharded bitwise equal to one card's ``sixdof_rollout`` and,
    at 20 ticks, held to the plain version; µs/tick of the sharded call
    beside one card's call and one shard's launch alone.  K2 sharded held
    against one card's call and the plain version (≤ 1e-4 f32, ≤ 1e-12
    f64, max |Δ| / max |ref|); µs per call (20 back-to-back calls between
    CUDA events) beside one card's re-timed call and each shard's row
    block alone.  Each against the bound of the work its busiest card does (its
    bodies, or its rows x N pairs).  The falcon9 campaign at 10000 samples (phase 13's
    dispersions) from two starts in which the reductions across shards
    decide: in flight with one DESCENT sample in the last shard (guidance
    escalates in every shard on all 10 ticks) and all DOWN but two landers
    in the last shard (``until=`` DOWN holds at tick 6, not before); 2-tick
    segments, unsharded and sharded: every column within 1e-13 relative of
    the unsharded run, those tick and guidance counts, no kernel launched;
    ms/tick of each; the device trace of 3 sharded ticks, busy and idle
    share per card.  Then ``parallel.dryrun.dryrun_multichip(4)`` on the
    mesh (its ``ep = 2`` program in 4 processes, one a device; gloo where
    a card repeats).

The split across processes (``parallel/distributed.py``: ranks started
once a run by ``distributed.launch``, each a new interpreter that imports
this script's functions; a rank that fails fails the phase):

36. two ranks on ``cuda:0`` over gloo (each collective staged through the
    host): in each rank, the ``ep = 2`` six-dof step at 8192 bodies x 5
    ticks, f64, bitwise equal to one process; with both launch counts set
    to 0 just before and read just after, the kernels' rank forms
    (``sixdof_rollout_sharded`` at 131072 bodies x 4000 ticks, f32 and
    f64: one launch a call) and n-body at 16384 bodies, f32 and f64,
    through ``World.build(device=mesh)`` and ``Exec.run(100)`` on K2's row
    blocks from the all-gathered bodies (one launch a tick), ms/tick; K1's
    block bitwise one card's call and, at 20 ticks, within 1e-4 / 1e-12 of
    the plain version; K2's all-gather form against one card's call and
    the plain version of the rank's rows (1e-4 / 1e-12); µs a tick and a
    call, every rank started together; falcon9 at phase 13's 10000
    samples over the ranks from phase 35's two starts (after a warm-up),
    ms/tick, the escalation start twice over (10000 a rank) and a device
    trace of 3 ticks a rank.  The parent holds n-body within 1e-4 / 1e-12
    of one process's ``Exec.run`` (beside its ms/tick) and falcon9 bitwise,
    with the same stop tick and guidance count, beside one process's
    ms/tick and sample-ticks/s.  Then a world of one rank on nccl: n-body
    through ``Exec`` on the mesh (a real NCCL communicator on the card),
    bitwise equal to one process.  With 4 cards, four nccl ranks, one a
    card: the kernels' rank forms timed and held as above.

The core API and the world's editor hooks (eager PyTorch ops; with both
launch counts set to 0 just before and read just after, the examples and
the apollo campaign launch no kernel and n-body's batched runner launches
K2 once a tick):

37. the eight core-API examples through ``World.build`` and ``Exec.run``
    on the card and on the CPU in one process, f64: rotating-cube 120
    ticks, geo-frames 30, ellipsoid 240, covariance-ellipsoids 97,
    sensor-camera 240, voyager 240, the apollo-lander descent 240 and
    n-body's ``main`` (4 asteroids) 100; every column card against CPU
    within 1e-9 (max |Δ| / max |ref| per channel group), the ``Exec``'s
    ``schematic_content`` the world's and the sensor cameras registered;
    ms/tick of each and a device trace of 10 ticks.  Then
    ``examples.n_body.batched.run(8192, 200)`` in f32 and f64 (a warm and
    a timed pass): 400 K2 launches a call, 200 of them timed, a finite
    momentum drift, pairs/s and entity-steps/s; the first 5 ticks held
    against the same runner on the dense edge fold (1e-4 / 1e-12); a
    device trace of 20 ticks.  Then apollo-lander's ``run_dispersed(1024,
    seed=0)`` campaign cut to ``APOLLO_TICKS`` (500 of 9000) on the card
    and on the CPU: the final state within 1e-9, sample-ticks/s of each,
    a device trace of 10 ticks.
The last four core-API examples, the ECI frames and the World Magnetic
Model (eager PyTorch ops and host numpy; with both launch counts set to 0
just before and read just after, the phase launches neither kernel):

38. in f64, on the card and on the CPU in one process, through
    ``World.build`` and ``Exec.run``: frames' ball drop in ENU and NED
    (120 ticks each; the card's falls the right way, ENU = -NED within
    1e-12) and its two-body orbit (600 ticks, the energy drift under 1e-6
    on the card); rocket-barrowman (1200 ticks on the card: altitude
    over 300 m, nose within 25 deg of the velocity); crazyflie-edu (1000
    of the lab's 8500 ticks: hovering at 0.6 ± 0.05 m on the card);
    rc-jet (600 of 11520).  Every column card against CPU within 1e-9
    (max |Δ| / max |ref| per channel group), rocket-barrowman at 300
    ticks (``RB_COMPARE_TICKS``: its angle of attack is an arccos near 1,
    and where the JAX package's own result moves by ~1e-8 under its
    compiler's FMA contraction, card and CPU do too); ms/tick of each on
    each device (the last three without history, as their JAX tests run)
    and a device trace of 10 ticks.  ``eci_to_ecef`` at
    2022-06-15 06:30 UTC without IERS data is orthonormal and
    ``ecef_to_eci`` its transpose.  ``wmm.field_ned`` on a global 0.25
    deg grid at sea level (1440 x 720 = 1,036,800 points) on the card: ms
    a call (CUDA events after a warm call), points/s, device ops a call,
    idle share, peak card memory; every 4th point held to the CPU within
    1e-12 of max |B|; one point's ms and device ops.
The telemetry database on the card (``elodin_tpu_torch.db``; with both
launch counts set to 0 just before and read just after each run, the
served n-body run launches K2 once a tick, (b) and (c) neither kernel):

39. (a) n-body at 1024 bodies on K2, f64 (``build_nbody(1024, seed=2)``,
    ~5.1k stores, one an (entity, component)), built with ``db_path``,
    served by ``serve_exec`` on a free port, ``Exec.run(100)``: 100 K2
    launches and no K1 launch; a port ``Client`` reads every body's ``world_pos`` and
    ``world_vel`` series, 101 rows each, bitwise the ``Exec``'s history
    (``state_at``, ``history_frame``) with the timestamps the tap
    computes, and again from the database reopened from disk; ms/tick
    served and the same run without a server (history on in both, run to
    flush), rows a second stored, the pump's stalls, the writer's time for
    the run's one tap batch (``commit_hist``), a ``time_series`` round trip, device ops a tick
    and idle share of 10 served ticks.  (b) the three-body example
    through ``python -m elodin_tpu_torch run`` in process on the card,
    served on a free port into ``ELODIN_DB_PATH`` for 120 ticks, a client
    on a real-time stream receiving rows meanwhile; then with
    ``ELODIN_RESUME=1`` to tick 240: the database's latest rows against
    one uninterrupted ``Exec.run(240)`` on the card within 1e-12 (max
    |Δ| / max |ref| per column; bitwise expected), the tick 240; ``db
    export`` to CSV, a row a stored row.  (c) the JAX test's
    external-control world on the card: a client's ``wire_thrust`` write
    reaches the ``Exec`` from the server's thread and the next tick's
    ``wire_vel`` on the card shows it.
40. the telemetry plane's second half on phase 39 (a)'s served n-body,
    whose server stays up through (b): (a) a port ``MirrorWorld``
    subscribes to every body's ``world_pos`` and ``world_vel``, then
    ``Exec.run(100)``: 100 K2 launches and no K1 launch, counted around
    the run; once the live sink holds the last row, ``value_at`` of
    every series at every stored timestamp (phase 39's rows through
    backfill, this run's through the live sink) is bitwise the
    ``Exec``'s history; ms/tick mirrored against phase 39's unserved
    figure, device ops a tick and idle share of 10 mirrored ticks, rows
    the sink received live against those backfilled, rows a second into
    the mirror.  (b) the web viewer over loopback HTTP: ``/api/info``,
    ``/api/components`` (every store), ``/api/series`` of ``b0.world_pos``
    (bitwise the history; downsampled, the history's LTTB pick),
    ``/api/latest``, ``/api/sql`` (a count), ``/api/geoms`` and
    ``/api/drawlist`` (the world has no schematic); a ``WsClient`` reads
    the series through ``/ws``, bitwise the TCP client's; round trips
    against phase 39's TCP one.  Then the server stops and phase 39 (a)'s
    reopen check runs.  (c) ``python -m elodin_tpu_torch db export
    --format mcap --pattern 'b1??.*'`` in process, read back with
    ``read_mcap_full``: a message a stored row of each exported store (as
    the reopen read it), at its time, its numbers the row's; bytes and
    export time; the video-stream example's frames, as H.264, through a
    server into a message log of a database of their own, then ``db
    export-videos``: one MP4, a sample a frame.  (d)
    the db-client example: its ball sim an s10 child on the card on a
    free port (``ELODIN_MAX_TICKS=400``), the client sees
    ``ball.world_pos``, its SQL returns 5 rows, its write back is read
    back, and the child's process group is gone after stop; the child's
    start-up.  Neither kernel launches in (b)-(d).
41. the flight software in the loop through the database, and the OSD;
    neither kernel launches.  (a) a port database server; a truth writer
    thread publishes at 200 Hz a body turning at 0.05 rad/s about +z from
    0.6 rad: gyro readings, the magnetometer and sun vectors in the body
    frame (noise from ``np.random.default_rng(41)``) and the attitude goal.
    ``mekf_system(...).pipe(lqr_system(...))`` runs in one
    ``HzDriver(200.0)`` on the card for 400 updates, subscribed to
    ``gyro_omega``, ``mag_body``, ``sun_body`` and ``att_goal`` and
    publishing ``att_est`` and ``control_torque``; then the same on the
    card machine's CPU (``device="cpu"``).  Printed: the achieved Hz
    against the 200 asked, ms an update split into pull, update and push,
    device ops an update and the idle share of 50 card updates
    (``torch.profiler``).  Gates: |<att_est, q_true>| > 0.999 on both
    devices; the card run's inputs, recorded an update each, replayed with
    no database through both devices' loops agree to 1e-12 an update (and
    the live card run with its replay).  (b) the ball example on the card,
    built with ``db_path``, served by ``serve_exec`` for 120 ticks and
    flushed; ``MspOsdService(addr, "ball", DisplayPortBackend(BytesIO))``
    renders 3 frames: the last frame's middle row, its ``SPD`` and ``ALT``
    strings, is ``render``'s of the history's last ``ball.world_pos`` /
    ``world_vel``; the frames' bytes and ms a frame.
42. a JSON line of the kernels (time, plain version's time and bound at
    the main path's width, launches on the main path; no PyTorch call
    computes either function, so ``library_ms`` is null; under
    ``sharded``, phase 35's launches, times and bound of the sharded
    call, its max |Δ| against the plain version as ``max_abs_err`` is
    above, and against one card as ``one_card_max_abs_err``; under
    ``processes``, phase 36's launches by rank and, per dtype, the slowest
    rank's time, the bound of its rows' work, its errors and, with 4
    cards, the four nccl ranks' time; under ``core_api``, phase 37's
    launches and K2's runner figures; under ``flight_examples``, phase
    38's launches; under ``telemetry_db``, phase 39's; under
    ``telemetry_ui``, phase 40 (a)'s; under ``fsw``, phase 41's), then
    the last line ``{"ok": true, "device": {...}}``.
"""

import cProfile
import fnmatch
import gc
import json
import math
import multiprocessing
import os
import pstats
import resource
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

DT = 1.0 / 120.0
F32_TOL, F64_TOL, ECS_F64_TOL = 1e-4, 1e-12, 1e-10
SIXDOF_STATE = ("world_pos", "world_vel")
MAIN_BODIES, MAIN_TICKS = 8192, 240
BENCH_BODIES, BENCH_TICKS, PLAIN_TICKS = 131072, 4000, 20
SHARD_BODIES = 32768  # one of phase 35's four shards of BENCH_BODIES
TRACE_TICKS = 20
TRACE_ATTEMPTS = 3  # calls of fn a device trace makes at most
NBODY_BODIES, NBODY_TICKS, NBODY_DT = 16384, 100, 60.0
EDGE_BODIES, EDGE_TICKS, EDGE_TRACE_TICKS = 4096, 50, 5
PROBED_BODIES, PROBED_TICKS = 128, 10
# 200 ticks (300 until phase 40 took its time): still past liftoff, which the
# phase checks in every sample
F9_SAMPLES, F9_TICKS, F9_HISTORY_EVERY = 10000, 200, 100
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
# K1's operations per body-tick, an FMA counted as 2, counted from the
# algebra of sixdof_rk4.cu's rk4_tick, which leaves out what the function
# does not need.  sixdof_accel's frame round trip cancels (R R^T = I), so a
# stage needs only R e_x and R e_z of the stage's attitude n: |n|^2 7,
# 2/|n|^2 1, the products 2 n_i / |n|^2 and x y, x z, y z 7, the two
# columns 16 (31); the spin (T m / Izz) R e_z 3; gravity's |p|^2 5 and
# -mu ir^3 3, |v|^2 5, the drag's |v| = v^2 rsqrt(max(v^2, min normal)) 2
# and its factor 1, the linear acceleration 15 (31): 65 a stage.  Stages
# 2-4 each add the attitude step 27, the position, spin and velocity
# updates 18 and the RK4 sums 24 (12 at stage 4).  The tick's end: the
# attitude step 27, its normalisation 11, the position, spin and velocity
# 18.  What stays constant for a body (T m / Izz, drag / m) is left out.
# 511 in all.  SFU results: a reciprocal and two reciprocal square roots a
# stage, one reciprocal square root at the end (13).  In f64 the SFU's
# seeds are refined to the last bits: 6 operations a reciprocal, 8 a
# reciprocal square root (the cubic step), 96 more.
_SIXDOF_F32_OPS = 4 * 65 + 3 * (27 + 18 + 24) - 12 + (27 + 11 + 18)
SIXDOF_TICK_OPS = {torch.float32: _SIXDOF_F32_OPS,
                   torch.float64: _SIXDOF_F32_OPS + 4 * 6 + 9 * 8}
SIXDOF_TICK_SFU = 4 * 3 + 1
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
# the RTF run lengths of the single-entity sims, and the repeats: bench.py's
# cut in depth to keep the script inside its time (drone 1200 -> 60,
# cube-sat 240 -> 60, ball 2400 -> 120, stablehlo 1200 -> 300, linalg
# 600 -> 150; phase 28 runs the drone and the cube-sat through the CLI at
# 300 and 240 ticks)
RTF_TICKS = {"drone": 60, "cube-sat": 60, "ball": 120, "stablehlo": 300, "linalg": 150}
RTF_REPEATS = 1  # 3 until phases 32-34 took their time, 2 until phase 39 did
RTF_WARMUP_TICKS = 30
SINGLE_TRACE_TICKS = 10
THREEFRY_COUNTERS, THREEFRY_CORNER_COUNTERS = 10**6, 1000
# the normals' largest difference, card against CPU, in ulps: the card's
# erfinv is the CUDA math library's (documented at 2 ulps in f32 and 5 in
# f64), the CPU's is within 1 and 3 ulps of a correctly rounded erfinv
# (tests/test_torch_threefry.py holds it against scipy's)
NORMAL_ULPS = {torch.float32: 3, torch.float64: 8}
NOISE_CALLS = 50
F9_SENSOR_TICKS, F9_MIXED_TOL = 50, 1e-6
CKPT_TICKS, CKPT_RESTORE, CKPT_MORE = 30, 10, 5
# history bytes before a spill, small enough that phase 27's run spills
CKPT_HISTORY_BYTES = 16 << 10
# the JAX package's landing campaign, examples/monte-carlo/batched.py
# run_campaign(10000, 2400, seed=0), run on a CPU (JAX_PLATFORMS=cpu, f64)
JAX_MC_LANDED_FRAC, JAX_MC_SOFT_FRAC = 0.9759, 0.9401
REPO = os.path.dirname(os.path.abspath(__file__))
REPEATS = 1  # of each timed figure of phases 29-30 (3 until phases 32-34 took their time, 2 until
# phase 40 did)
CLI_REPEATS = 1  # bench children an example in phase 28 (cut from 3 for phases 32-34)
# phase 28: each CLI child (module, bench ticks), cut to half the examples'
# own 300 and 240 when phase 39 took its time
CLI_BENCH = {"drone": ("elodin_tpu_torch.examples.drone.main", 150),
             "cube-sat": ("elodin_tpu_torch.examples.cube_sat.main", 120)}
CHILD_TIMEOUT_S = 300
# a child that imports torch and the port, initialises CUDA, runs the
# drone's ``components`` as ``python -m`` would, and prints the seconds of
# each part on its last line
STARTUP_PROBE = (
    "import time; t0 = time.perf_counter(); import torch, elodin_tpu_torch; "
    "t1 = time.perf_counter(); torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
    "t2 = time.perf_counter(); import json, runpy, sys; "
    "sys.argv = [sys.argv[0], 'components']; "
    f"runpy.run_module('{CLI_BENCH['drone'][0]}', run_name='__main__', alter_sys=True); "
    "print(json.dumps({'import_s': t1 - t0, 'cuda_init_s': t2 - t1, "
    "'components_s': time.perf_counter() - t2}))")
# phase 29: the betaflight-sitl hover at its 1 kHz plant rate
# the pipelined run cut from 4000 ticks when phase 40 took its time
SITL_TICKS, SITL_STRICT_TICKS, SITL_TRIPS, SITL_HOLD = 2000, 1000, 40, 64
SESSION_COMMANDS, SESSION_TOL = 50, 1e-12
# phase 30: the cube-sat with history, REPEATS windows of 80 ticks a mode
PUMP_WINDOW_TICKS, PUMP_WARMUP_TICKS = 80, 10
# phase 31: the process campaign of the landing sim
CAMPAIGN_SAMPLES, CAMPAIGN_CPU_SAMPLES, CAMPAIGN_WORKERS = 4, 4, 4  # 8 card samples before phases 32-34
CAMPAIGN_TIMEOUT_S = 900
# phases 32-34: differentiable rollouts, the rest of adcs and gravity/j2
ORBIT_V0 = (0.1, 1.0, 0.05)  # the start of phase 32's finite difference
# Adam steps of phase 32 (3 until phase 35 took its time) and 33 (2 until then)
ORBIT_FD_TICKS, ORBIT_FD_EPS, ORBIT_ADAM_STEPS = 60, 1e-6, 1
ORBIT_TRACE_TICKS = 16  # one gradient traced, cut in depth (~3500 device ops a tick)
# the remat step against plain, cut in depth from 504 ticks (47 s on the card) for phase 39
ORBIT_REMAT_TICKS = 88
# the Adam step card against CPU, cut in depth from the example's 504 ticks (27 s on the card
# and its CPU) when the script overran its time
ORBIT_ADAM_TICKS = 168
GRAD_TOL = 1e-9  # card against CPU, values, gradients and iterates
HOVER_STEPS, HOVER_TRACE_TICKS = 1, 24
PYSIM_CHUNK, PYSIM_CHUNKS = 30, 2
MAGKAL_READINGS = 300
# phase 35: the split over cards
SPLIT_SHARDS = 4  # shards of the mesh phase 35 always runs (repeated entries on fewer cards)
SPLIT_F9_TICKS, SPLIT_F9_SEGMENT, SPLIT_F9_TOL, SPLIT_TRACE_TICKS = 10, 2, 1e-13, 3
SPLIT_PLAIN_TICKS = 20  # ticks of K1's sharded call held to the plain version
# phase 36: the split across processes
PROC_RANKS = 2  # ranks that share cuda:0 over gloo
PROC_SIXDOF_TICKS = 5  # ticks of the ep-cut six-dof step at the main width
PROC_TIMEOUT_S = 600
# phase 37: the core API's examples, card against CPU, f64, at these depths
CORE_TOL = 1e-9
CORE_TRACE_TICKS = 10
NBODY_BATCHED = (8192, 200)  # examples/n_body/batched.py's defaults
NBODY_BATCHED_PLAIN_TICKS = 5  # ticks held to the dense edge fold
NBODY_BATCHED_TRACE_TICKS = 20
APOLLO_SAMPLES = 1024  # run_dispersed's default width
APOLLO_TICKS = 500  # of its 9000: the phase's time (1000 until phase 40 took its time)
APOLLO_TRACE_TICKS = 10
# phase 38: the last four core-API examples, the ECI frames and wmm, f64
FLIGHT_TOL = 1e-9
FLIGHT_TRACE_TICKS = 10
DROP_TICKS, TWO_BODY_TICKS = 120, 600  # the JAX test's depths
# rocket-barrowman flies its whole JAX test on the card; the card is held
# to the CPU at 300 ticks, where the JAX package's own result is
# reproducible to ~1e-12 (its angle of attack is an arccos near 1, which
# magnifies a last-bit difference ~1e8-fold: card against CPU 3.9e-11 at
# 400 ticks, 7.6e-9 at 1200 on an H100 80GB HBM3 at 700 W)
RB_TICKS, RB_COMPARE_TICKS = 1200, 300
CF_TICKS = 1000  # of the lab's 8500: the JAX test's first gate, hovering at 0.6 m
RJ_TICKS = 600  # of the mission's 11520
WMM_LON, WMM_LAT = 1440, 720  # a global 0.25 deg grid of cell centres at sea level
WMM_YEAR, WMM_TOL = 2020.0, 1e-12
WMM_CPU_STRIDE = 4  # every 4th grid point held to the CPU (~10 s for the whole grid there)
WMM_CPU_CHUNK = 131072
# phase 39: the telemetry database on the card
DB_BODIES, DB_TICKS = 1024, 100  # ~5.1k stores: one a (body, component)
DB_TRACE_TICKS = 10
DB_RUN_TICKS = 120  # the three-body run's ticks, then as many again resumed
DB_STREAM_ROWS = 10  # rows the real-time stream must deliver during the run
DB_RESUME_TOL = 1e-12
DB_WAIT_S = 30.0
# phase 40: the mirror, the web viewer and /ws, MCAP and MP4 export, db-client
UI_TICKS = 100  # the mirrored run of phase 39 (a)'s Exec
UI_DRAIN_S = 120.0  # the live sink's deadline for the mirrored run's rows
UI_SERIES = "b0.world_pos"  # the series the viewer and the bridge read
UI_ROUND_TRIPS = 5
UI_LTTB_POINTS = 50  # /api/series downsampled by LTTB to this many points
UI_MCAP_PATTERN = "b1??.*"  # bodies b100-b199: 500 of the ~5.1k stores into the MCAP
UI_VIDEO_FRAMES = 30  # the video-stream example's frames, paced at its 30 Hz
DBC_TICKS = 400  # the db-client example's ball sim (the JAX test's ELODIN_MAX_TICKS)
# phase 41: the flight-software loop against a live database, and the OSD
FSW_HZ = 200.0  # the rate HzDriver is asked for, and the truth writer's
FSW_UPDATES = 400  # 2 s of the loop, on the card and on the CPU
FSW_TRACE_UPDATES = 50
FSW_TOL = 1e-12  # card against CPU on the recorded inputs (the adcs tolerance)
FSW_SEED = 41
FSW_SPIN = 0.05  # rad/s about +z, from 0.6 rad
FSW_INPUTS = ("gyro_omega", "mag_body", "sun_body", "att_goal")
FSW_OUTPUTS = ("att_est", "control_torque")
OSD_TICKS = 120  # the ball served for the OSD
OSD_FRAMES = 3


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


def _trace_events(fn, attempts=TRACE_ATTEMPTS):
    """([(card index, ms)] of the device ops, wall ms) of one call of fn()
    under torch.profiler, every card synchronised before and after.  The
    ops are read from the profiler's raw results, the same ones (and the
    same names left out) that ``prof.events()`` keeps as device events,
    without the tree of Python events that ``events()`` builds, which took
    seconds for every 10**4 device ops and most of a long trace's time.
    A ``record_function`` span (the port's ``tick_metrics.span``) also shows
    on the device's timeline, as a user annotation: it is no op.
    The profiler at times hands back a trace with no device op at all;
    fn() is then traced again, up to ``attempts`` calls in all, and if none
    of them records a device op the result is ([], wall ms of the last)."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name
    from torch.profiler import ProfilerActivity, profile

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    for attempt in range(1, attempts + 1):
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = [(e.device_index(), e.duration_ns() / 1e6)
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not _filter_name(e.name())
               and not e.is_hidden_event() and not e.is_user_annotation()]
        if dev:
            return dev, wall_ms
        print(f"device trace: the profiler recorded no device op (call {attempt} of "
              f"{attempts})")
    print("device trace: device time not measured (nan below)")
    return [], wall_ms


def _runtime_calls(fn, names):
    """How often one call of fn() called each CUDA runtime function of
    ``names``, as torch.profiler records them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    found = [e.name() for e in prof.profiler.kineto_results.events()]
    return tuple(found.count(n) for n in names)


def _device_trace(fn, attempts=TRACE_ATTEMPTS):
    """(device ops, device busy ms, wall ms) of one call of fn() under
    torch.profiler (``_trace_events``).  Busy is the sum of the durations
    of the device ops (kernels and copies), which run on one stream; with
    no device op recorded the result is (0, nan, wall ms): not measured."""
    dev, wall_ms = _trace_events(fn, attempts)
    if not dev:
        return 0, math.nan, wall_ms
    return len(dev), sum(ms for _, ms in dev), wall_ms


def _device_trace_by_card(fn):
    """({card index: (device ops, busy ms)}, wall ms) of one call of fn():
    ``_device_trace`` split by the card each op ran on (empty: not
    measured)."""
    dev, wall_ms = _trace_events(fn)
    cards = {}
    for card, ms in dev:
        ops, busy = cards.get(card, (0, 0.0))
        cards[card] = (ops + 1, busy + ms)
    return cards, wall_ms


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


def _pairwise_bound(n, dtype, eps=0.0, rows=None):
    """``_bound`` of one all-pairs call on ``n`` bodies, or of a block of
    ``rows`` of them against all n: rows x N pairs, each read and written
    value moved once (n positions and masses, rows accelerations)."""
    rows = n if rows is None else rows
    pairs = rows * n
    return _bound(pairs * (PAIR_OPS[dtype] + (eps != 0.0)), pairs,
                  (4 * n + 3 * rows) * dtype.itemsize, dtype)


def _sixdof_build_report(dtype):
    """(registers, SASS instructions of the tick loop) of K1's ``dtype``
    instance as built, from ptxas's report and cuobjdump: a diagnostic of
    the issue slots the compiler spent, beside the function's own count
    (``SIXDOF_TICK_OPS``); never the bound.  Prints the loop's FP32 or FP64
    pipe operations (an FMA counted as 2) and SFU results."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import sass_loops
    from elodin_tpu_torch.ops import _build

    tag = "sixdof_rk4_kernelI" + ("f" if dtype == torch.float32 else "d")
    (regs, spill_st, spill_ld), = sass_loops.ptxas_resources(
        _build.build_log("sixdof_rk4"), tag).values()
    text = sass_loops.sass_text(str(_build.library_path("sixdof_rk4")))
    _, start, end, count, classes, fp32, fp64, _ = max(sass_loops.loop_counts(text, tag),
                                                       key=lambda loop: loop[3])
    print(f"K1 SASS, {dtype}: {regs} registers, spills {spill_st}/{spill_ld} bytes; tick loop "
          f"0x{start:x}-0x{end:x} of {count} instructions, FP32 ops {fp32}, FP64 ops {fp64}, "
          f"MUFU {classes['MUFU']}")
    return regs, count


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
    from elodin_tpu_torch.ops import _build
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

    # 5. kernel and plain version timed at the small, the main path's, a
    # shard's and the bench width
    timing = {}
    for n in (1024, MAIN_BODIES, SHARD_BODIES, BENCH_BODIES):
        cols = batched_sixdof_init(n, seed=0)
        for dtype in (torch.float32, torch.float64):
            args = dict(device="cuda", dtype=dtype)
            dev_cols = [torch.as_tensor(c, **args) for c in cols]
            k_min, k_med = _time_ms(
                lambda: sk.sixdof_rollout(*dev_cols, DT, BENCH_TICKS, **args))
            clock = _sm_clock()  # just after the kernel's timed calls
            p_min, p_med = _time_ms(
                lambda: sk.sixdof_rollout_reference(*dev_cols, DT, PLAIN_TICKS, **args))
            k_tick, p_tick = k_min / BENCH_TICKS, p_min / PLAIN_TICKS
            timing[n, dtype] = (k_tick, p_tick)
            print(f"{n} bodies, {dtype}: kernel {BENCH_TICKS} ticks "
                  f"min {k_min:.3f} ms median {k_med:.3f} ms -> {k_tick * 1e3:.4g} us/tick, "
                  f"{n / (k_tick * 1e-3):.4g} entity-steps/s; plain "
                  f"{PLAIN_TICKS} ticks min {p_min:.3f} ms median {p_med:.3f} ms -> "
                  f"{p_tick * 1e3:.4g} us/tick, {n / (p_tick * 1e-3):.4g} "
                  f"entity-steps/s; kernel/plain speedup {p_tick / k_tick:.4g}x; SM clock "
                  f"just after the kernel's timed calls, and its maximum: {clock}")
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

    # the bound of a tick at the main path's, a shard's and the bench
    # width, from the function's operations; the plan, registers and SASS
    # loop beside it
    bounds = {}
    sm_count = _build.sm_count(torch.cuda.current_device())
    for dtype in (torch.float32, torch.float64):
        regs, loop = _sixdof_build_report(dtype)
        for n in (MAIN_BODIES, SHARD_BODIES, BENCH_BODIES):
            ops, mufu = SIXDOF_TICK_OPS[dtype], SIXDOF_TICK_SFU
            bounds[n, dtype] = _bound(n * ops, n * mufu, 30 * n * dtype.itemsize / BENCH_TICKS,
                                      dtype)
            ms, bound = timing[n, dtype][0], bounds[n, dtype][0]
            threads = sk._launch_plan(n, sm_count)
            print(f"K1 bound, {dtype}, {n} bodies: the function's {ops} ops and {mufu} SFU "
                  f"results per body-tick -> {bound * 1e3:.4g} us/tick ({bounds[n, dtype][1]}); "
                  f"kernel {ms * 1e3:.4g} us/tick, {bound / ms:.1%} of the bound; plan "
                  f"{threads} threads a block, {-(-n // threads)} blocks; {regs} registers, "
                  f"tick loop {loop} SASS instructions")

    return {
        "name": "sixdof_rk4",
        "route": "cuda",
        "source": "elodin_tpu_torch/ops/csrc/sixdof_rk4.cu",
        "replaces": "elodin_tpu/ops/sixdof_kernel.py:179",
        "launches": main_launches,
        "max_abs_err": errs[MAIN_BODIES, torch.float32][1],
        "ms": timing[BENCH_BODIES, torch.float32][0],
        "plain_ms": timing[BENCH_BODIES, torch.float32][1],
        "bound_ms": bounds[BENCH_BODIES, torch.float32][0],
        "bound_by": _bound_by(bounds[BENCH_BODIES, torch.float32][1]),
        "library_ms": None,
        "units": (f"max_abs_err: float32 vs plain at {MAIN_BODIES} bodies x "
                  f"{MAIN_TICKS} ticks; ms, plain_ms, bound_ms: per tick at "
                  f"{BENCH_BODIES} bodies, float32; launches: the two "
                  "sixdof_rollout calls of the main path (f64, f32); library_ms: "
                  "no PyTorch call computes a 6-dof RK4 rollout"),
        "float64": {"max_abs_err": errs[MAIN_BODIES, torch.float64][1],
                    "ms": timing[BENCH_BODIES, torch.float64][0],
                    "plain_ms": timing[BENCH_BODIES, torch.float64][1],
                    "bound_ms": bounds[BENCH_BODIES, torch.float64][0],
                    "bound_by": _bound_by(bounds[BENCH_BODIES, torch.float64][1])},
        **{f"at_{n}": {str(dtype).removeprefix("torch."): {
            "ms": timing[n, dtype][0], "plain_ms": timing[n, dtype][1],
            "bound_ms": bounds[n, dtype][0]}
            for dtype in (torch.float32, torch.float64)} for n in (MAIN_BODIES, SHARD_BODIES)},
    }


def _nbody_exec(el, policy, n, use_kernel, telemetry_rate=None, device="cuda"):
    """An n-body Exec on the card (or on ``device``, a mesh across
    processes): ``build_nbody(n, seed=2)`` under ``policy``, built through
    ``World.build``."""
    from elodin_tpu_torch.models import build_nbody, build_nbody_system

    el.set_float_policy(policy)
    world = build_nbody(n, seed=2)
    return world.build(build_nbody_system(NBODY_DT, use_kernel=use_kernel),
                       device=device, simulation_rate=1.0 / NBODY_DT,
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
    from elodin_tpu_torch.models import build_nbody
    from elodin_tpu_torch.models.nbody import G
    from elodin_tpu_torch.ops import pairwise as pw
    from elodin_tpu_torch.models.nbody import _gravity
    from elodin_tpu_torch.system import FOLD_SETUPS, TOTAL_FOLDS

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
    FOLD_SETUPS.update(dict.fromkeys(FOLD_SETUPS, 0))
    _gravity.fold_setups.clear()
    edge_wall = _run_timed(edge, EDGE_TICKS)
    edge_launches, folds, setups = pw.LAUNCHES, dict(TOTAL_FOLDS), dict(FOLD_SETUPS)
    kern_wall = _run_timed(kern, EDGE_TICKS)
    print(f"n-body edge-fold path (f64, {EDGE_BODIES} bodies, Exec.run({EDGE_TICKS})): "
          f"{edge_launches} launches of pairwise_gravity, folds {folds}, set-ups {setups}, "
          f"{edge_wall:.4f} s, {EDGE_BODIES * EDGE_TICKS / edge_wall:.4g} entity-steps/s; "
          f"kernel path on the same world {kern_wall:.4f} s, "
          f"{EDGE_BODIES * EDGE_TICKS / kern_wall:.4g} entity-steps/s")
    if edge_launches != 0:
        raise AssertionError(f"the edge-fold path launched the kernel {edge_launches} times")
    if folds != {"dense": EDGE_TICKS, "sequential": 0, "probes": 0}:
        raise AssertionError(f"edge folds took {folds}, not the dense path every tick")
    if setups != {"built": 1, "reused": EDGE_TICKS - 1}:
        raise AssertionError(f"edge-fold set-ups {setups}, not one build and a reuse every "
                             "later tick")
    if edge.tick() != EDGE_TICKS:
        raise AssertionError(f"edge-fold tick {edge.tick()} != {EDGE_TICKS}")
    _compare(f"n-body edge-fold vs kernel path, f64, {EDGE_BODIES} bodies x "
             f"{EDGE_TICKS} ticks", edge.cols, kern.cols, state, ECS_F64_TOL)
    ops, busy, wall = _device_trace(lambda: edge.run(EDGE_TRACE_TICKS))
    print(f"device trace, n-body edge-fold path (f64, {EDGE_BODIES} bodies, "
          f"run({EDGE_TRACE_TICKS})): {ops / EDGE_TRACE_TICKS:.1f} device ops/tick, "
          f"device busy {busy / EDGE_TRACE_TICKS:.4g} ms/tick, wall "
          f"{wall / EDGE_TRACE_TICKS:.4g} ms/tick, idle share {1 - busy / wall:.2%}")
    calls = _runtime_calls(lambda: edge.run(EDGE_TRACE_TICKS),
                           ("cudaStreamSynchronize", "cudaMemcpyAsync", "cudaLaunchKernel"))
    print(f"runtime calls, n-body edge-fold path (run({EDGE_TRACE_TICKS}), history recorded "
          "every tick): " + ", ".join(f"{name} {n / EDGE_TRACE_TICKS:.4g}" for name, n in zip(
              ("cudaStreamSynchronize", "cudaMemcpyAsync", "cudaLaunchKernel"), calls))
          + " a tick")

    # 10. the example's form of the fold (examples/n_body/main.py, no
    # additive hint): the probe runs once and rejects it (it drops the
    # carry's torque), so every tick folds sequentially
    from elodin_tpu_torch.examples.n_body.main import gravity as probed_gravity

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
                  f"launch (profiler, {ops} device ops in 10 calls) "
                  + (f"{busy / ops * 1e3:.4g} us, {bound / (busy / ops):.1%} of the bound"
                     if ops else "not measured"))
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


def _no_launches_counted(label, fn):
    """fn() with both kernels' launch counts set to 0 just before it;
    raises unless both read 0 just after.  Returns fn()'s result and the
    counts read."""
    from elodin_tpu_torch.ops import pairwise as pw
    from elodin_tpu_torch.ops import sixdof_kernel as sk

    sk.LAUNCHES = pw.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {"sixdof_rk4": sk.LAUNCHES, "pairwise_gravity": pw.LAUNCHES}
    print(f"{label}: hand-kernel launches {launches} (the path has none)")
    if any(launches.values()):
        raise AssertionError(f"{label} launched a hand kernel: {launches}")
    return out, launches


def _no_launches(label, fn):
    """fn() with both kernels' launch counts set to 0 just before it;
    raises unless both read 0 just after."""
    return _no_launches_counted(label, fn)[0]


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
    examples and falcon9 through verify (no hand kernel); returns phase
    18's rollouts/s."""
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
    rollouts_per_s = _landing(el, landing_ref)
    _clock("phase 18")
    return rollouts_per_s


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
    return result.rollouts_per_second


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

    rtfs = {}
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
        rtfs[example] = card_rtf, cpu_rtf
    return rtfs


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
    """Phases 19-23: the drone and the cube-sat (no hand kernel); returns
    the real-time factors of phase 21, ``{example: (card, cpu)}``."""
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
    rtfs = _rtf_trace_profile(el, examples)
    _clock("phases 21-22")
    # 23. card facts
    try:
        import pyarrow
        arrow = f"pyarrow {pyarrow.__version__} imports"
    except ImportError as e:
        arrow = f"pyarrow does not import ({e})"
    print(f"card facts: torch.cuda.device_count() {torch.cuda.device_count()}; {arrow}")
    return rtfs


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
        exec_.flush_telemetry()  # the spill count is read from the history
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
        exec_.flush_telemetry()
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


def _spread(values):
    """'median M (min a, max b, spread s of the median)' of a list."""
    med = statistics.median(values)
    return (f"median {med:.4g} (min {min(values):.4g}, max {max(values):.4g}, spread "
            f"{(max(values) - min(values)) / med:.1%} of the median)")


def _child(args, label, timeout=CHILD_TIMEOUT_S):
    """(stdout, wall seconds) of ``python args`` from the repo root, the
    package on its path; raises on a nonzero exit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                                                  else []))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable] + args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    return proc.stdout, wall


def _bench_figures(out):
    """(tick ms, build ms, RTF) of the three lines ``bench`` prints."""
    import re

    found = [re.search(pattern, out, re.M) for pattern in (
        r"^= tick time: +([\d.]+) ms \(batch of \d+ ticks\)$", r"^build time: +([\d.]+) ms$",
        r"^real_time_factor: +([\d.]+)$")]
    if not all(found):
        raise AssertionError(f"bench printed no three lines:\n{out}")
    return tuple(float(m.group(1)) for m in found)


def _cli_phase(single_rtfs):
    """Phase 28: the drone and the cube-sat through ``bench`` in child
    processes on the card, beside phase 21's in-process RTF; the start-up
    split; the drone's ``components`` against its CSV baseline."""
    from elodin_tpu_torch import regress

    out, probe_wall = _child(["-c", STARTUP_PROBE], "start-up probe")
    components, last = out.rstrip("\n").rsplit("\n", 1)
    probe = json.loads(last)
    interp_s = probe_wall - probe["import_s"] - probe["cuda_init_s"] - probe["components_s"]
    print(f"CLI start-up probe child: {probe_wall:.3f} s, of which the interpreter's start and "
          f"exit {interp_s:.3f} s, import torch and elodin_tpu_torch {probe['import_s']:.3f} s, "
          f"CUDA initialisation {probe['cuda_init_s']:.3f} s, the drone's components "
          f"{probe['components_s']:.3f} s")
    for example, (module, ticks) in CLI_BENCH.items():
        runs = []
        for _ in range(CLI_REPEATS):
            out, wall = _no_launches(f"{example} CLI bench child", lambda: _child(
                ["-m", module, "bench", "--ticks", str(ticks)], f"{example} bench"))
            runs.append((wall,) + _bench_figures(out))
        walls, tick_ms, build_ms, rtfs = (list(col) for col in zip(*runs))
        card_rtf, cpu_rtf = single_rtfs[example]
        med_wall, med_tick = statistics.median(walls), statistics.median(tick_ms)
        ticks_s = med_tick * ticks / 1e3
        rest = med_wall - interp_s - probe["import_s"] - probe["cuda_init_s"] - ticks_s
        print(f"CLI {example} on the card (python -m {module} bench --ticks {ticks}, {CLI_REPEATS} "
              f"children, exit 0): tick time {_spread(tick_ms)} ms, RTF {_spread(rtfs)}; "
              f"in-process RTF of phase 21 (Exec.run({RTF_TICKS[example]}), no history) "
              f"card {statistics.median(card_rtf):.4g}, CPU {statistics.median(cpu_rtf):.4g}; "
              f"build {statistics.median(build_ms):.4g} ms")
        print(f"CLI {example} child wall {_spread(walls)} s; at the median: interpreter "
              f"{interp_s:.3f} s, import {probe['import_s']:.3f} s, CUDA initialisation "
              f"{probe['cuda_init_s']:.3f} s (the probe child's), ticks {ticks_s:.3f} s "
              f"({ticks_s / med_wall:.1%}), the rest (world, build, exit) {rest:.3f} s")
    columns = {f"{entity}.{c['name']}" for c in json.loads(components)
               for entity in c["entities"]}
    baseline = sorted(f[:-len(".csv")] for f in os.listdir(regress.baseline_dir("drone"))
                      if f.endswith(".csv"))
    missing = [b for b in baseline if b not in columns]
    print(f"CLI drone components: {len(columns)} entity.component columns; every one of the "
          f"{len(baseline)} files of its CSV baseline named: {not missing}")
    if missing:
        raise AssertionError(f"drone components lacks baseline columns {missing}")


def _lockstep_phase():
    """Phase 29: the betaflight-sitl hover at 1 kHz, pipelined, strict and
    batched, on the card and on the CPU; then the session on the card
    against the CPU."""
    from elodin_tpu_torch.examples.betaflight_sitl import main as sitl

    for device in ("cuda", "cpu"):
        cases = (
            ("pipelined", f"run(ticks={SITL_TICKS})", "hz",
             lambda st: sitl.run(ticks=SITL_TICKS, device=device, stats=st)),
            ("strict", f"run(ticks={SITL_STRICT_TICKS}, pipeline=False)", "hz",
             lambda st: sitl.run(ticks=SITL_STRICT_TICKS, pipeline=False, device=device,
                                 stats=st)),
            ("batched", f"run_batched(trips={SITL_TRIPS}, hold={SITL_HOLD})", "plant_hz",
             lambda st: sitl.run_batched(trips=SITL_TRIPS, hold=SITL_HOLD, device=device,
                                         stats=st)),
        )
        for mode, call, key, fn in cases:
            runs = []
            for _ in range(REPEATS):
                stats = {}
                _no_launches(f"lockstep {mode} on {device}", lambda: fn(stats))
                runs.append(stats)
            hz = [r[key] for r in runs]
            extra = (f"control (exchanges/s) {_spread([r['control_hz'] for r in runs])}"
                     if mode == "batched" else
                     f"missed replies {[r['missed'] for r in runs]}, stale {[r['stale'] for r in runs]}")
            print(f"lockstep {mode} on {device} ({call}, 1 kHz plant, {REPEATS} runs): "
                  f"{'plant ' if mode == 'batched' else ''}Hz {_spread(hz)}; {extra}; altitude "
                  f"{[round(r['z'], 4) for r in runs]} m (each within 0.5 m of 2 m); real time at "
                  f"1 kHz: {'yes' if statistics.median(hz) >= sitl.SIM_RATE else 'no'}")
    worst = 0.0
    for hold in (1, 4):
        sessions = {dev: sitl.build(dev).lockstep_session(sitl.SEND, sitl.RECV, hold_ticks=hold)
                    for dev in ("cuda", "cpu")}
        for cmd in np.random.default_rng(3).uniform(0.0, 20.0, SESSION_COMMANDS):
            outs = {}
            for dev, session in sessions.items():
                session.cmd_bufs["thrust_cmd"][0] = cmd
                outs[dev] = session.tick()
            worst = max(worst, float(np.abs(outs["cuda"] - outs["cpu"]).max()))
    print(f"lockstep session on the card vs the CPU ({SESSION_COMMANDS} commands at hold 1 and "
          f"4): max |Δ| {worst:.3e} (tol {SESSION_TOL:g})")
    if not worst <= SESSION_TOL:
        raise AssertionError(f"lockstep session card vs CPU {worst:.3e}")


def _pump_phase(el):
    """Phase 30: the cube-sat's tick without history, through the pump and
    through the synchronous path; the histories bitwise; the stalls; a
    device trace with history."""
    from elodin_tpu_torch.examples.cube_sat import main as cube

    el.set_float_policy("f64")
    modes = {"no history": (False, False), "pump": (True, False), "synchronous": (True, True)}
    execs = {}
    for mode, (history, sync) in modes.items():
        ex = cube.build_world().build(cube.build_system(), simulation_rate=1.0 / cube.SIM_TIME_STEP,
                                      device="cuda")
        ex.record_history, ex._sync_history = history, sync
        ex.run(PUMP_WARMUP_TICKS)
        ex.flush_telemetry()
        execs[mode] = ex
    loop = {m: [] for m in modes}
    drain = {m: [] for m in modes}
    for _ in range(REPEATS):
        for mode, ex in execs.items():
            def window():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ex.run(PUMP_WINDOW_TICKS)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ex.flush_telemetry()
                return t1 - t0, time.perf_counter() - t1

            loop_s, drain_s = _no_launches(f"cube-sat {mode} window", window)
            loop[mode].append(loop_s / PUMP_WINDOW_TICKS * 1e3)
            drain[mode].append(drain_s / PUMP_WINDOW_TICKS * 1e3)
    ticks = PUMP_WARMUP_TICKS + REPEATS * PUMP_WINDOW_TICKS
    for mode in modes:
        print(f"cube-sat on the card, {mode} (f64, {REPEATS} windows of {PUMP_WINDOW_TICKS} "
              f"ticks, interleaved): step loop {_spread(loop[mode])} ms/tick; the pump's drain "
              f"after it {_spread(drain[mode])} ms/tick")
        _all_finite(f"cube-sat {mode}", execs[mode])
    pump, sync = execs["pump"], execs["synchronous"]
    rows = {}
    for mode in ("pump", "synchronous"):
        h = execs[mode]._history
        rows[mode] = h.times, {k: h.series(k) for k in execs[mode].meta.components}
    differ = [k for k in rows["synchronous"][1]
              if not np.array_equal(rows["pump"][1][k], rows["synchronous"][1][k])]
    same_times = rows["pump"][0] == rows["synchronous"][0]
    print(f"cube-sat histories, pump vs synchronous ({ticks} ticks, {len(rows['pump'][0])} rows, "
          f"{len(differ)} of {len(rows['pump'][1])} components differ; times equal: {same_times}); "
          f"the pump's stalls {pump._pump.stalls} (queue of {pump._pump.q.maxsize}), its "
          f"copy time {pump.profiler.copy_s / ticks * 1e3:.4g} ms/tick on the writer thread, the "
          f"synchronous path's {sync.profiler.copy_s / ticks * 1e3:.4g} ms/tick on the step loop")
    if differ or not same_times:
        raise AssertionError(f"the pump's history differs from the synchronous path's: {differ}")
    ops, busy, wall = _no_launches("cube-sat pump trace", lambda: _device_trace(
        lambda: (pump.run(SINGLE_TRACE_TICKS), pump.flush_telemetry())))
    n = SINGLE_TRACE_TICKS
    print(f"device trace, cube-sat on the card with history through the pump (Exec.run({n}) and "
          f"the drain): {ops / n:.1f} device ops/tick, device busy {busy / n:.4g} ms/tick, wall "
          f"{wall / n:.4g} ms/tick, idle share {1 - busy / wall:.2%}")


class _CardMemory:
    """The card's memory in use (nvidia-smi), sampled every second on a
    thread while a campaign runs: the largest reading and the first."""

    def __init__(self):
        import threading

        self.readings = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30).stdout
            self.readings.append(float(out.split()[0]))
            if self._stop.wait(1.0):
                return

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60)
        return self.readings[0], max(self.readings)


def _process_campaign_phase(batched_rollouts_per_s):
    """Phase 31: the landing sim as a process campaign on the card, then
    the same plan's first rows on the CPU."""
    import csv
    import shutil
    import tempfile

    from elodin_tpu_torch.examples.monte_carlo import main as landing
    from elodin_tpu_torch.monte_carlo import run_campaign

    config = {"monte_carlo": {
        "n_samples": CAMPAIGN_SAMPLES, "seed": 0,
        "variables": {k: {"dist": "uniform", "min": p.min, "max": p.max}
                      for k, p in landing.PARAMS.items()}}}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-campaign-")
    try:
        card_dir, cpu_dir = os.path.join(tmp, "card"), os.path.join(tmp, "cpu")
        memory = _CardMemory()
        t0 = time.perf_counter()
        card = _no_launches("process campaign on the card", lambda: run_campaign(
            landing.__file__, config, card_dir, workers=CAMPAIGN_WORKERS,
            timeout=CAMPAIGN_TIMEOUT_S, device="cuda"))
        card_wall = time.perf_counter() - t0
        mem_before, mem_peak = memory.stop()
        # rows 0-3 of the same plan on the CPU: a resume whose manifest lists
        # the plan's later rows (none at 4 samples) as done
        os.makedirs(cpu_dir)
        done = [f"{i:06d}" for i in range(CAMPAIGN_CPU_SAMPLES, CAMPAIGN_SAMPLES)]
        with open(os.path.join(cpu_dir, "campaign.manifest.json"), "w") as f:
            json.dump({"completed": done}, f)
        t0 = time.perf_counter()
        cpu = run_campaign(landing.__file__, config, cpu_dir, workers=CAMPAIGN_WORKERS,
                           timeout=CAMPAIGN_TIMEOUT_S, resume=True, device="cpu")
        cpu_wall = time.perf_counter() - t0
        for label, records, n in (("card", card, CAMPAIGN_SAMPLES),
                                  ("CPU", cpu, CAMPAIGN_CPU_SAMPLES)):
            bad = [r for r in records if not r.get("valid") or r.get("ticks") != MC_TICKS]
            if len(records) != n or bad:
                raise AssertionError(f"process campaign on the {label}: {len(records)} records, "
                                     f"invalid {bad}")
        by_row = {r["run_id"]: r for r in card}
        worst = 0.0
        for r in cpu:
            c = by_row[r["run_id"]]
            for key in ("result.touchdown_vz", "result.landing_offset"):
                d = abs(c[key] - r[key]) / max(1.0, abs(r[key]))
                worst = max(worst, d)
        print(f"process campaign ({CAMPAIGN_SAMPLES} landing samples x {MC_TICKS} ticks, "
              f"{CAMPAIGN_WORKERS} workers, device cuda; rows 0-{CAMPAIGN_CPU_SAMPLES - 1} again "
              f"on the CPU): every run valid; touchdown_vz and landing_offset, card vs CPU from "
              f"the same row, max |Δ|/max(1, |x|) {worst:.3e} (tol {EX_TOL:g}); soft "
              f"{sum(bool(r['result.soft']) for r in card)} of {len(card)}")
        if not worst <= EX_TOL:
            raise AssertionError(f"process campaign card vs CPU {worst:.3e}")
        for label, out_dir, records, wall in (("card", card_dir, card, card_wall),
                                              ("CPU", cpu_dir, cpu, cpu_wall)):
            with open(os.path.join(out_dir, "perf.csv")) as f:
                perf = list(csv.DictReader(f))
            walls = [float(p["wall_s"]) for p in perf]
            rtfs = [float(p["real_time_factor"]) for p in perf]
            loop_s = [MC_TICKS * DT / rtf for rtf in rtfs]
            startup = [(w - s) / w for w, s in zip(walls, loop_s)]
            with open(os.path.join(out_dir, "resources.csv")) as f:
                rss = [int(row["rss_kb"]) for row in csv.DictReader(f)]
            print(f"process campaign on the {label}: wall {wall:.3f} s, {len(records) / wall:.4g} "
                  f"samples/s ({len(records)} samples); per run wall_s {_spread(walls)}, RTF "
                  f"{_spread(rtfs)}, start-up share (wall_s less the run loop) {_spread(startup)}; "
                  f"peak RSS of the children together {max(rss) / 1024:.1f} MiB")
        print(f"process campaign: the card's memory in use {mem_before:.0f} MiB before, "
              f"{mem_peak:.0f} MiB at its peak with {CAMPAIGN_WORKERS} children: "
              f"{(mem_peak - mem_before) / CAMPAIGN_WORKERS:.0f} MiB a child; samples/s "
              f"{CAMPAIGN_SAMPLES / card_wall:.4g} against phase 18's batched campaign "
              f"{batched_rollouts_per_s:.4g} rollouts/s ("
              f"{batched_rollouts_per_s / (CAMPAIGN_SAMPLES / card_wall):.4g}x)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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


def _train_steps(loss_fn, params, steps, lr, device):
    """``steps`` Adam steps (``torch.optim.Adam(lr=lr)``) of ``loss_fn``
    over a copy of ``params`` on ``device``: per step (loss, gradients,
    weights after the step, on the CPU; wall ms of the step, a host clock
    ended by a synchronise) and the peak card memory of the steps above
    what was allocated before them (None on the CPU)."""
    params = {k: v.detach().clone().to(device).requires_grad_() for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    if device == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    rows = []
    for _ in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        opt.zero_grad()
        val = loss_fn(params)
        val.backward()
        opt.step()
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        rows.append((val.item(), {k: v.grad.cpu() for k, v in params.items()},
                     {k: v.detach().cpu().clone() for k, v in params.items()}, ms))
    peak = torch.cuda.max_memory_allocated() - base if device == "cuda" else None
    return rows, peak


def _hold_steps(label, card, cpu, tol=GRAD_TOL):
    """``_hold`` of every step's loss, gradients and weights, the card's
    ``_train_steps`` rows against the CPU's."""
    def flat(rows):
        out = {}
        for i, (val, grads, weights, _) in enumerate(rows, 1):
            out[f"step {i} loss"] = np.array([val])
            out.update({f"step {i} grad {k}": v.numpy() for k, v in grads.items()})
            out.update({f"step {i} {k}": v.numpy() for k, v in weights.items()})
        return out

    _hold(f"{label}, card against CPU", _errors_by_group(flat(card), flat(cpu)), tol)


def _peak_mib(peak):
    return f"{peak / 2**20:.4g} MiB"


def _orbit_phase():
    """Phase 32: orbit-retarget's value and gradient on the card
    (``el.rollout``, autograd): the finite difference at 60 ticks,
    ``ORBIT_ADAM_STEPS`` Adam steps (``solve``'s rule) at
    ``ORBIT_ADAM_TICKS`` against the CPU's,
    ms per value-and-grad, card and CPU; on the card remat (8 segments)
    against plain and the peak card memory of each (the CPU's remat is
    held in the CPU tests); a device trace of one gradient."""
    from elodin_tpu_torch.examples.orbit_retarget import main as orbit

    ticks, segs = ORBIT_ADAM_TICKS, orbit.REMAT_SEGMENTS
    v0 = torch.tensor(ORBIT_V0, dtype=torch.float64)

    # the finite difference at 60 ticks on the card
    loss = orbit.make_loss(ORBIT_FD_TICKS, None, "cuda")
    v = v0.to("cuda").requires_grad_()
    (g,) = torch.autograd.grad(loss(v), v)
    with torch.no_grad():
        fd = []
        for i in range(3):
            e = torch.zeros(3, dtype=torch.float64, device="cuda")
            e[i] = ORBIT_FD_EPS
            fd.append(((loss(v + e) - loss(v - e)) / (2 * ORBIT_FD_EPS)).item())
    g = g.cpu().numpy()
    fd_rel = np.abs(g - fd) / np.maximum(np.abs(fd), 1e-300)
    print(f"orbit-retarget on the card, {ORBIT_FD_TICKS} ticks, at v0 = {ORBIT_V0}: gradient "
          f"{g.tolist()}, central difference (eps {ORBIT_FD_EPS:g}) {fd}, relative "
          f"difference {fd_rel.max():.3e} (rtol 1e-5, atol 1e-8)")
    if not np.all(np.abs(g - fd) <= 1e-8 + 1e-5 * np.abs(fd)):
        raise AssertionError("orbit-retarget: the card's gradient misses the finite difference")

    # Adam steps from solve's start, card and CPU; then remat on the card
    start = {"v0": torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64)}
    figures = {}
    for device in ("cuda", "cpu"):
        loss = orbit.make_loss(ticks, None, device)
        rows, peak = _train_steps(lambda p: loss(p["v0"]), start, ORBIT_ADAM_STEPS,
                                  orbit.LEARNING_RATE, device)
        figures[device] = rows
        line = (f"orbit-retarget on {device}, {ticks} ticks, f64: value-and-grad and an Adam "
                f"step, plain {_spread([r[3] for r in rows])} ms over {ORBIT_ADAM_STEPS} steps "
                "(runs " + ", ".join(f"{r[3]:.6g}" for r in rows) + ")")
        if device == "cuda":
            cut = orbit.make_loss(ORBIT_REMAT_TICKS, None, device)
            prows, ppeak = _train_steps(lambda p: cut(p["v0"]), start, 1,
                                        orbit.LEARNING_RATE, device)
            remat = orbit.make_loss(ORBIT_REMAT_TICKS, segs, device)
            rrows, rpeak = _train_steps(lambda p: remat(p["v0"]), start, 1,
                                        orbit.LEARNING_RATE, device)
            bitwise = rrows[0][0] == prows[0][0] and torch.equal(rrows[0][1]["v0"],
                                                                 prows[0][1]["v0"])
            vrel = abs(rrows[0][0] - prows[0][0]) / abs(prows[0][0])
            grel = ((rrows[0][1]["v0"] - prows[0][1]["v0"]).abs().max()
                    / prows[0][1]["v0"].abs().max()).item()
            line += (f"; peak card memory above the columns {_peak_mib(peak)}; at "
                     f"{ORBIT_REMAT_TICKS} ticks, plain {prows[0][3]:.6g} ms, remat ({segs} "
                     f"segments) {rrows[0][3]:.6g} ms; remat against plain: value {vrel:.3e} "
                     f"(tol 1e-12), gradient {grel:.3e} (tol 1e-9), bitwise {bitwise}; peak "
                     f"card memory plain {_peak_mib(ppeak)}, remat {_peak_mib(rpeak)}")
            if not (vrel <= 1e-12 and grel <= 1e-9):
                raise AssertionError("orbit-retarget on the card: remat differs from plain")
        print(line)
    card, cpu = figures["cuda"], figures["cpu"]
    _hold_steps(f"orbit-retarget, {ticks} ticks, {ORBIT_ADAM_STEPS} Adam steps", card, cpu)
    print(f"orbit-retarget: first loss {card[0][0]!r} (CPU {cpu[0][0]!r}), gradient "
          f"{card[0][1]['v0'].tolist()}, v0 after {ORBIT_ADAM_STEPS} steps "
          f"{card[-1][2]['v0'].tolist()}")

    # one gradient traced (cut in depth)
    loss = orbit.make_loss(ORBIT_TRACE_TICKS, None, "cuda")
    v = v0.to("cuda").requires_grad_()
    ops, busy, wall = _device_trace(lambda: torch.autograd.grad(loss(v), v))
    print(f"device trace, orbit-retarget value-and-grad ({ORBIT_TRACE_TICKS} ticks, f64): "
          f"{ops / ORBIT_TRACE_TICKS:.1f} device ops/tick (forward and backward), device busy "
          f"{busy / ORBIT_TRACE_TICKS:.4g} ms/tick, wall {wall / ORBIT_TRACE_TICKS:.4g} "
          f"ms/tick, idle share {1 - busy / wall:.2%}")


def _hover_phase():
    """Phase 33: neural-hover's training at full width and horizon (16
    starts x 240 ticks, ``torch.func.vmap`` over the starts): 2 Adam steps
    on the card against the CPU, ms per step, a device trace of one step
    (cut to 24 ticks), and ``evaluate`` finite."""
    from elodin_tpu_torch.examples.neural_hover import main as hover

    params = hover.init_params(0, "cpu")
    steps = {}
    for device in ("cuda", "cpu"):
        loss = hover.make_loss(hover.starts(16), hover.TICKS, device)
        steps[device], peak = _train_steps(loss, params, HOVER_STEPS, hover.LEARNING_RATE, device)
        print(f"neural-hover training step on {device} (16 starts x {hover.TICKS} ticks, f64, "
              f"value-and-grad and Adam): {_spread([r[3] for r in steps[device]])} ms (runs "
              + ", ".join(f"{r[3]:.6g}" for r in steps[device]) + "); losses "
              + ", ".join(f"{r[0]!r}" for r in steps[device])
              + (f"; peak card memory {_peak_mib(peak)}" if peak is not None else ""))
    _hold_steps(f"neural-hover, 16 x {hover.TICKS}, {HOVER_STEPS} Adam steps",
                steps["cuda"], steps["cpu"])
    trained = {k: v.to("cuda") for k, v in steps["cuda"][-1][2].items()}
    loss = hover.make_loss(hover.starts(16), HOVER_TRACE_TICKS, "cuda")
    p = {k: v.clone().requires_grad_() for k, v in trained.items()}
    ops, busy, wall = _device_trace(lambda: torch.autograd.grad(loss(p), list(p.values())))
    print(f"device trace, neural-hover value-and-grad (16 x {HOVER_TRACE_TICKS} ticks, f64): "
          f"{ops / HOVER_TRACE_TICKS:.1f} device ops/tick (forward and backward), device busy "
          f"{busy / HOVER_TRACE_TICKS:.4g} ms/tick, wall {wall / HOVER_TRACE_TICKS:.4g} ms/tick, "
          f"idle share {1 - busy / wall:.2%}")
    miss, speed = hover.evaluate(trained)
    print(f"neural-hover evaluate on the card after {HOVER_STEPS} steps: miss {miss:.6g} m, "
          f"speed {speed:.6g} m/s")
    if not (np.isfinite(miss) and np.isfinite(speed)):
        raise AssertionError("neural-hover: evaluate is not finite")


def _card_vs_cpu(label, fn, tol):
    """``_hold`` of fn(device), a dict of tensors, on the card against the
    CPU."""
    card, cpu = fn("cuda"), fn("cpu")
    if any(t.device.type != "cuda" for t in card.values()):
        raise AssertionError(f"{label}: a result is not on the card")
    _hold(f"{label}, card against CPU", _errors_by_group(
        {k: v.cpu().numpy() for k, v in card.items()}, {k: v.numpy() for k, v in cpu.items()}),
        tol)


def _rest_phase():
    """Phase 34: cube-sat-pysim's TorchSim against Exec on the card; the
    UKF, MagKal, MAG.I.CAL, TRIAD and J2 card against CPU; both kernels
    refuse an input that requires grad."""
    from elodin_tpu_torch import adcs
    from elodin_tpu_torch.examples.cube_sat import main as cube
    from elodin_tpu_torch.examples.cube_sat_pysim import main as pysim
    from elodin_tpu_torch.gravity import J2
    from elodin_tpu_torch.models.sixdof_batch import batched_sixdof_init
    from elodin_tpu_torch.ops import pairwise as pw
    from elodin_tpu_torch.ops import sixdof_kernel as sk

    omegas = pysim.run(PYSIM_CHUNK, PYSIM_CHUNKS, "cuda")
    sim = cube.build_world().to_jax(cube.build_system(), device="cuda")
    exec_ = cube.build_world().build(cube.build_system(), simulation_rate=1.0 / cube.SIM_TIME_STEP,
                                     device="cuda")
    exec_.record_history = False
    ref = []
    for _ in range(PYSIM_CHUNKS):
        sim.step(PYSIM_CHUNK)
        exec_.run(PYSIM_CHUNK, show_progress=False)
        ref.append(float(np.linalg.norm(exec_.read_component("ore_sat.world_vel")[:3])))
    errs = _errors_by_group({k: v.cpu().numpy() for k, v in sim.state.items()},
                            {k: v.cpu().numpy() for k, v in exec_.cols.items()})
    omega_rel = max(abs(a - b) / abs(b) for a, b in zip(omegas, ref))
    print(f"cube-sat-pysim on the card ({PYSIM_CHUNKS} chunks of {PYSIM_CHUNK} ticks through "
          f"World.to_jax / TorchSim): angular speeds {omegas} against Exec's {ref}, relative "
          f"{omega_rel:.3e}; tick {sim.get_tick_count()} and {exec_.tick()}")
    _hold("cube-sat TorchSim against Exec on the card, every column", errs, 1e-12)
    if not (omega_rel <= 1e-12 and sim.get_tick_count() == exec_.tick()):
        raise AssertionError("cube-sat-pysim differs from Exec")

    rng = np.random.default_rng(5)
    b_true = np.array([12.0, -7.0, 4.0])
    d_true = np.array([[0.02, 0.005, 0.0], [0.005, -0.015, 0.002], [0.0, 0.002, 0.01]])
    dirs = rng.normal(size=(MAGKAL_READINGS, 3))
    fields = 45.0 * dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    readings = fields @ (np.eye(3) + d_true).T + b_true

    def magkal(device):
        kal = adcs.MagKal(device=device)
        for z, f in zip(readings, fields):
            kal.update(z, f)
        return {"x_hat": kal.state.x_hat, "covar": kal.state.covar}

    def ukf(device):
        state = adcs.UkfState(*(torch.tensor(x, dtype=torch.float64, device=device) for x in (
            [0.0, 1.0], np.eye(2), np.eye(2) * 1e-4, np.eye(1) * 1e-2)),
            config=adcs.MerweConfig(2, 1.0, 2.0, 1.0))
        for k in range(50):
            z = torch.tensor([0.07 * (k + 1) + 0.1 * np.sin(k)], dtype=torch.float64,
                             device=device)
            state = state.update(z, lambda x: torch.stack([x[0] + 0.1 * x[1], x[1]]),
                                 lambda x, _z: x[:1])
        return {"x_hat": state.x_hat, "covar": state.covar}

    y = dirs[:64] / np.linalg.norm(dirs[:64], axis=1, keepdims=True) @ np.diag([1.2, 0.9, 1.1]) \
        + np.array([0.3, -0.2, 0.5])

    def magical(device):
        m, t, h, done = adcs.magical_calibrate(torch.tensor(y, device=device))
        if not bool(done):
            raise AssertionError(f"magical_calibrate on {device} did not converge")
        return {"m": m, "t": t, "h": h}

    def triad(device):
        a, b = (torch.tensor(x, device=device) for x in (dirs[:32], readings[:32]))
        return {"dcm": adcs.triad(a, b, a.flip(0), b.flip(0))}

    def j2(device):
        r = torch.tensor(fields * 1.6e5, device=device)  # radii ~7.2e6 m
        return {"force": J2().force(r, torch.ones(len(r), dtype=r.dtype, device=device))}

    _card_vs_cpu(f"MagKal, {MAGKAL_READINGS} readings", magkal, 1e-8)
    _card_vs_cpu("UKF linear tracker, 50 updates", ukf, 1e-10)
    _card_vs_cpu("magical_calibrate, 64 readings", magical, 1e-12)
    _card_vs_cpu("triad, 32 pairs", triad, 1e-12)
    _card_vs_cpu(f"J2 force, {MAGKAL_READINGS} positions", j2, 1e-12)

    cols = batched_sixdof_init(64, seed=1)
    vel = torch.tensor(cols[1], device="cuda", requires_grad=True)
    pos = torch.tensor(fields[:64], device="cuda", requires_grad=True)
    refused = []
    for name, fn in (("sixdof_rollout", lambda: sk.sixdof_rollout(
            cols[0], vel, cols[2], DT, 5, device="cuda", dtype=torch.float64)),
            ("pairwise_gravity", lambda: pw.pairwise_gravity(pos, torch.ones_like(pos[:, 0])))):
        try:
            fn()
        except RuntimeError as e:
            if "no backward pass" in str(e):
                refused.append(name)
    print(f"kernels refusing an input that requires grad on the card: {refused}")
    if refused != ["sixdof_rollout", "pairwise_gravity"]:
        raise AssertionError(f"kernels that accepted an input requiring grad: {refused}")


def _split_meshes():
    """The device lists phase 35 runs on: ``SPLIT_SHARDS`` shards over the
    visible cards (repeated entries when there are fewer), and every card
    when there are 2 or more and that is another list."""
    count = torch.cuda.device_count()
    shards = [f"cuda:{i % count}" for i in range(SPLIT_SHARDS)]
    every = [f"cuda:{i}" for i in range(count)]
    return [shards] + ([every] if count >= 2 and every != shards else [])


def _busiest_rows(devices, n):
    """The rows the busiest card of ``devices`` holds when n rows are cut
    into one block a device (repeated devices hold several blocks)."""
    from elodin_tpu_torch.parallel.mesh import row_blocks

    rows = {}
    for d, (a, b) in zip(devices, row_blocks(n, len(devices))):
        rows[d] = rows.get(d, 0) + b - a
    return max(rows.values())


def _split_kernels(mesh, label):
    """Phase 35's kernels on ``mesh``: the counted sharded calls, then each
    held to one card and to its plain version, and timed against the bound
    of the work its busiest card does; returns the ``sharded`` entries of
    the kernels line."""
    from elodin_tpu_torch.models.nbody import G
    from elodin_tpu_torch.models.sixdof_batch import batched_sixdof_init
    from elodin_tpu_torch.ops import _build
    from elodin_tpu_torch.ops import pairwise as pw
    from elodin_tpu_torch.ops import sixdof_kernel as sk
    from elodin_tpu_torch.parallel.mesh import row_blocks

    devices = mesh.axis_devices("dp")
    shards, dtypes = len(devices), (torch.float32, torch.float64)
    cols = batched_sixdof_init(BENCH_BODIES, seed=0)
    snap = _nbody_snapshot(NBODY_BODIES)
    nb = {d: (torch.as_tensor(snap["world_pos"][:, 4:], device="cuda", dtype=d).contiguous(),
              torch.as_tensor(snap["inertia"][:, 6], device="cuda", dtype=d).contiguous())
          for d in dtypes}

    # the sharded path, counted
    sk.LAUNCHES = pw.LAUNCHES = 0
    k1 = {d: sk.sixdof_rollout_sharded(*cols, DT, BENCH_TICKS, mesh, dtype=d) for d in dtypes}
    k2 = {d: pw.pairwise_gravity_sharded(*nb[d], mesh, g=G) for d in dtypes}
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    launches = {"sixdof_rk4": sk.LAUNCHES, "pairwise_gravity": pw.LAUNCHES}
    print(f"{label}: launches of the sharded path {launches} (sixdof_rollout_sharded and "
          f"pairwise_gravity_sharded, f32 and f64, {shards} shards)")
    if launches != {"sixdof_rk4": 2 * shards, "pairwise_gravity": 2 * shards}:
        raise AssertionError(f"{label}: not one launch a shard and call: {launches}")

    out = {"sixdof_rk4": {}, "pairwise_gravity": {}}
    k1_rows = _busiest_rows(devices, BENCH_BODIES)
    k2_rows = _busiest_rows(devices, NBODY_BODIES)
    k1_first = row_blocks(BENCH_BODIES, shards)[0][1]
    k2_first = row_blocks(NBODY_BODIES, shards)[0][1]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        args = dict(device="cuda", dtype=dtype)
        dev_cols = [torch.as_tensor(c, **args) for c in cols]
        one = sk.sixdof_rollout(*dev_cols, DT, BENCH_TICKS, **args)
        if not all(torch.equal(a, b) for a, b in zip(k1[dtype], one)):
            raise AssertionError(f"{label}: sharded K1 != one card ({dtype})")
        short = sk.sixdof_rollout_sharded(*dev_cols, DT, SPLIT_PLAIN_TICKS, mesh, dtype=dtype)
        plain = sk.sixdof_rollout_reference(*dev_cols, DT, SPLIT_PLAIN_TICKS, **args)
        err, abs_err = _compare(f"{label}: K1 sharded vs plain, {BENCH_BODIES} bodies x "
                                f"{SPLIT_PLAIN_TICKS} ticks, {dtype}", _state(short),
                                _state(plain), SIXDOF_STATE, tol)
        one_ms = _time_ms(lambda: sk.sixdof_rollout(*dev_cols, DT, BENCH_TICKS, **args))[0]
        shard_ms = _time_ms(lambda: sk.sixdof_rollout_sharded(
            *dev_cols, DT, BENCH_TICKS, mesh, dtype=dtype))[0]
        first = [c[:k1_first] for c in dev_cols]
        alone_ms = _time_ms(lambda: sk.sixdof_rollout(*first, DT, BENCH_TICKS, **args))[0]
        bound = _bound(k1_rows * SIXDOF_TICK_OPS[dtype], k1_rows * SIXDOF_TICK_SFU,
                       30 * k1_rows * dtype.itemsize / BENCH_TICKS, dtype)
        tick_ms, one_tick_ms = shard_ms / BENCH_TICKS, one_ms / BENCH_TICKS
        print(f"{label}: K1 {dtype}, {BENCH_BODIES} bodies x {BENCH_TICKS} ticks: sharded "
              f"bitwise equal to one card; sharded {tick_ms * 1e3:.4g} us/tick, one card "
              f"{one_tick_ms * 1e3:.4g} us/tick, one shard's {k1_first} bodies alone on one "
              f"card {alone_ms / BENCH_TICKS * 1e3:.4g} us/tick; bound of the busiest card's "
              f"{k1_rows} bodies {bound[0] * 1e3:.4g} us/tick ({bound[1]}), "
              f"{bound[0] / tick_ms:.1%} of it")
        out["sixdof_rk4"][str(dtype)[6:]] = {
            "ms": tick_ms, "one_card_ms": one_tick_ms, "shard_alone_ms": alone_ms / BENCH_TICKS,
            "bound_ms": bound[0], "bound_by": _bound_by(bound[1]), "max_abs_err": abs_err,
            "plain_rel_err": err, "one_card_max_abs_err": 0.0}

        pos, mass = nb[dtype]
        one = pw.pairwise_gravity(pos, mass, g=G)
        ref = pw.pairwise_gravity_reference(pos, mass, g=G)
        errs = {}
        for name, base in (("one card", one), ("plain", ref)):
            d = (k2[dtype].double() - base.double()).abs().max().item()
            errs[name] = (d / base.double().abs().max().item(), d)
            if not (torch.isfinite(k2[dtype]).all() and errs[name][0] <= tol):
                raise AssertionError(f"{label}: K2 sharded vs {name} {dtype}: "
                                     f"{errs[name][0]:.3e}")
        one_ms = _time_ms(lambda: pw.pairwise_gravity(pos, mass, g=G), reps=5, calls=20)[0]
        shard_ms = _time_ms(lambda: pw.pairwise_gravity_sharded(pos, mass, mesh, g=G),
                            reps=5, calls=20)[0]
        alone = [_time_ms(lambda: pw.pairwise_gravity(pos, mass, g=G, row0=a, rows=b - a),
                          reps=5, calls=20)[0] for a, b in row_blocks(NBODY_BODIES, shards)]
        alone_ms = max(alone)
        bound = _pairwise_bound(NBODY_BODIES, dtype, rows=k2_rows)
        whole = _pairwise_bound(NBODY_BODIES, dtype)
        plans = sorted({tuple(pw._launch_plan(NBODY_BODIES, _build.sm_count(0), b - a))
                        for a, b in row_blocks(NBODY_BODIES, shards)})
        print(f"{label}: K2 {dtype}, {NBODY_BODIES} bodies, {shards} row blocks (plans "
              f"{plans}): sharded vs " + ", ".join(
                  f"{name} max|Δ|/max|ref| {rel:.3e}" for name, (rel, _) in errs.items())
              + f" (tol {tol:g}); sharded {shard_ms * 1e3:.4g} us/call, bound of the busiest "
              f"card's {k2_rows} rows {bound[0] * 1e3:.4g} us ({bound[1]}), "
              f"{bound[0] / shard_ms:.1%} of it; each shard's row block alone on one card "
              f"{[round(t * 1e3, 2) for t in alone]} us/call, the slowest "
              f"{_pairwise_bound(NBODY_BODIES, dtype, rows=k2_first)[0] / alone_ms:.1%} of its "
              f"bound; one card re-timed {one_ms * 1e3:.4g} us/call, "
              f"{whole[0] / one_ms:.1%} of its bound")
        out["pairwise_gravity"][str(dtype)[6:]] = {
            "ms": shard_ms, "one_card_ms": one_ms, "shard_alone_ms": alone_ms,
            "bound_ms": bound[0], "bound_by": _bound_by(bound[1]),
            "max_abs_err": errs["plain"][1], "plain_rel_err": errs["plain"][0],
            "one_card_max_abs_err": errs["one card"][1]}
    return {name: {"mesh": [str(d) for d in devices], "shards": shards,
                   "launches": launches[name], **entry} for name, entry in out.items()}


def _nbody_snapshot(n):
    from elodin_tpu_torch.models import build_nbody

    return build_nbody(n, seed=2).snapshot()[1]


def _f9_decision_cols(n, shards):
    """Two starts of phase 13's dispersed falcon9 campaign (``n`` samples,
    LHS seed 0) in which the reductions across shards decide something
    within phase 35's ticks, as numpy columns for ``from_columns``:

    * "escalation": every sample in ASCENT at 20 km and climbing, the last
      sample (in the last shard) in DESCENT.  Guidance escalates to full
      rate in every shard, on every tick, and the other samples' thrust
      direction moves with it (by ~4e-4 in 10 ticks): a gate that did not
      join the shards would leave them at its 1-in-5 schedule;
    * "touchdown": every sample DOWN but the last two, in LANDING 0.6 and
      0.7 m over the LZ-1 deck at 5 m/s: they touch down on ticks 4 and 6,
      so ``until_down`` holds at the tick-6 segment boundary and not
      before.  A stop that did not wait for the last shard would come at
      tick 2."""
    from elodin_tpu_torch.examples.falcon9 import batched as f9
    from elodin_tpu_torch.examples.falcon9 import sim
    from elodin_tpu_torch.interop import columns_to_numpy

    if n % shards or n // shards < 2:
        raise ValueError(f"{n} samples over {shards} shards")
    pad, _ = f9.make_campaign(n, seed=0, device="cpu")
    base = columns_to_numpy(pad.cols, pad.meta)

    esc = {k: v.copy() for k, v in base.items()}
    esc["phase"][:] = sim.ASCENT
    esc["lifted"][:] = 1.0
    esc["world_pos"][..., 4:] += sim._ENU_T @ np.array([0.0, 0.0, 20000.0])
    esc["world_vel"][..., 3:] = sim._ENU_T @ np.array([500.0, 500.0, 300.0])
    esc["phase"][-1] = sim.DESCENT

    down = {k: v.copy() for k, v in base.items()}
    down["phase"][:] = sim.DOWN
    down["lifted"][:] = 1.0
    for j, height in ((n - 2, 0.6), (n - 1, 0.7)):
        down["phase"][j] = sim.LANDING
        down["world_pos"][j, ..., 4:] += sim._ENU_T @ (sim._LZ1_ENU + [0.0, 0.0, height])
        down["world_vel"][j] = 0.0
        down["world_vel"][j, ..., 3:] = -5.0 * sim._U_HAT
    return {"escalation": esc, "touchdown": down}


def _split_campaign(mesh, label):
    """Phase 35's falcon9 campaigns on ``mesh``: each start of
    ``_f9_decision_cols`` unsharded and sharded, through ``until_down`` in
    2-tick segments, held column by column and to its decision; ms/tick,
    and the sharded escalation ticks' device traces."""
    from elodin_tpu_torch.examples.falcon9 import batched as f9
    from elodin_tpu_torch.examples.falcon9 import sim
    from elodin_tpu_torch.monte_carlo import BatchedCampaign

    shards = len(mesh.axis_devices("dp"))
    starts = _f9_decision_cols(F9_SAMPLES, shards)
    # what each start must decide: (ticks run, guidance ticks)
    decided = {"escalation": (SPLIT_F9_TICKS, SPLIT_F9_TICKS), "touchdown": (6, 6)}
    prev = os.environ.get("ELODIN_MC_SEGMENT_TICKS")
    os.environ["ELODIN_MC_SEGMENT_TICKS"] = str(SPLIT_F9_SEGMENT)
    try:
        for start, cols in starts.items():
            runs = {}
            for mode, kw in (("unsharded", dict(device="cuda")), ("sharded", dict(mesh=mesh))):
                world, system = sim.build(None, sensors=False)
                campaign = BatchedCampaign.from_columns(world, system, cols,
                                                        simulation_rate=sim.SIM_RATE_HZ, **kw)
                result = _no_launches(f"{label}: falcon9 {start}, {mode}", lambda: campaign.run(
                    SPLIT_F9_TICKS, until=f9.until_down))
                runs[mode] = (campaign, result)
                print(f"{label}: falcon9 {F9_SAMPLES} samples from the {start} start, {mode}: "
                      f"{result.ticks} ticks in {result.wall_seconds:.3f} s, "
                      f"{result.wall_seconds / result.ticks * 1e3:.4g} ms/tick, guidance on "
                      f"{campaign.gated_runs} ticks")
            (ours, result), (_, ref) = runs["sharded"], runs["unsharded"]
            seen = {mode: (r.ticks, c.gated_runs) for mode, (c, r) in runs.items()}
            if set(seen.values()) != {decided[start]}:
                raise AssertionError(f"{label}: falcon9 {start}: (ticks, guidance ticks) "
                                     f"{seen}, expected {decided[start]}")
            worst, bitwise = 0.0, True
            for k in ref.final:
                a, b = result.column(k), ref.column(k)
                np.testing.assert_allclose(a, b, rtol=SPLIT_F9_TOL, atol=0,
                                           err_msg=f"{label}: falcon9 {start} sharded != "
                                                   f"unsharded, {k}")
                bitwise &= bool(np.array_equal(a, b))
                if a.dtype.kind == "f" and (a != b).any():
                    d = np.abs(a.astype(np.float64) - b) / np.abs(b.astype(np.float64))
                    worst = max(worst, float(np.nanmax(d[a != b])))
            print(f"{label}: falcon9 {start} sharded vs unsharded: the same {result.ticks} "
                  f"ticks and {ours.gated_runs} guidance ticks, every column within "
                  f"{SPLIT_F9_TOL:g} relative (largest {worst:.3g}, bitwise {bitwise})")
            if start == "escalation":
                cards, wall = _device_trace_by_card(lambda: ours.run(SPLIT_TRACE_TICKS))
                print(f"{label}: device trace, falcon9 sharded ({F9_SAMPLES} samples, "
                      f"run({SPLIT_TRACE_TICKS})): wall {wall / SPLIT_TRACE_TICKS:.4g} ms/tick; "
                      + ("; ".join(f"cuda:{i} {ops / SPLIT_TRACE_TICKS:.1f} device ops/tick, "
                                   f"busy {busy / SPLIT_TRACE_TICKS:.4g} ms/tick, idle share "
                                   f"{1 - busy / wall:.2%}"
                                   for i, (ops, busy) in sorted(cards.items()))
                         or "device time not measured"))
    finally:
        if prev is None:
            del os.environ["ELODIN_MC_SEGMENT_TICKS"]
        else:
            os.environ["ELODIN_MC_SEGMENT_TICKS"] = prev


def _split_phase(kernels):
    """Phase 35: the split over cards, on each of ``_split_meshes``; adds
    the first mesh's ``sharded`` entries to the kernels line."""
    from elodin_tpu_torch.parallel import make_mesh
    from elodin_tpu_torch.parallel.dryrun import dryrun_multichip

    for k, devices in enumerate(_split_meshes()):
        mesh = make_mesh(devices=devices)
        label = f"phase 35, mesh {mesh.shape} of {devices}"
        print(f"{label}: devices {[str(d) for d in mesh.devices.flat]}")
        sharded = _split_kernels(mesh, label)
        if k == 0:
            for entry in kernels:
                entry["sharded"] = sharded[entry["name"]]
        _split_campaign(mesh, label)
        print(dryrun_multichip(len(devices), devices=devices))
        _clock(label)


def _proc_rank(out_dir, sections):
    """Phase 36 in one rank of a job that ``distributed.launch`` started
    (``sections`` of "sixdof", "kernels", "nbody", "falcon9"): the mesh
    spans every rank's card, the bodies over ``ep`` (one rank a device) and
    falcon9's samples over ``dp``.  Each section raises on a failed check;
    returns the rank's figures, and writes the columns the parent holds
    against one process to ``out_dir``."""
    import torch.distributed as dist

    import elodin_tpu_torch as el
    from elodin_tpu_torch.interop import columns_from_numpy
    from elodin_tpu_torch.models import build_batched_sixdof
    from elodin_tpu_torch.models.sixdof_batch import batched_sixdof_init
    from elodin_tpu_torch.ops import pairwise as pw
    from elodin_tpu_torch.ops import sixdof_kernel as sk
    from elodin_tpu_torch.parallel import distributed, make_mesh, sharded_step
    from elodin_tpu_torch.system import build_step

    job = distributed.process()
    rank, ranks = job.rank, job.world_size
    mesh = make_mesh(ep=ranks)
    comm = mesh.line_comm("ep", mesh.local_positions()[0])
    report = {"rank": rank, "device": str(job.devices[0]), "transport": comm.transport}
    label = f"phase 36, rank {rank} of {ranks} ({comm.transport})"
    dtypes = (torch.float32, torch.float64)

    if "sixdof" in sections:
        el.set_float_policy("f64")
        world, system = build_batched_sixdof(MAIN_BODIES)
        meta, cols = world.snapshot()
        step = build_step(meta, system)

        def ticks(state):
            for _ in range(PROC_SIXDOF_TICKS):
                state = step(state)
            return state

        fn, placed = sharded_step(ticks, mesh, columns_from_numpy(cols, meta, "cpu"))
        out = fn(placed)
        one = ticks(columns_from_numpy(cols, meta, job.devices[0]))
        for name, col in out.items():
            for shard in col.addressable_shards:
                if not torch.equal(shard.data, one[name][shard.index]):
                    raise AssertionError(f"{label}: six-dof {name} {shard.index} != one process")
        rows = out["world_pos"].addressable_shards[0].index[0]
        print(f"{label}: six-dof step, {MAIN_BODIES} bodies over ep={ranks}, "
              f"{PROC_SIXDOF_TICKS} ticks: rows [{rows.start}, {rows.stop}) bitwise equal to "
              "one process")

    if "kernels" in sections or "nbody" in sections:
        sk.LAUNCHES = pw.LAUNCHES = 0
        k1, execs = {}, {}
        if "kernels" in sections:
            init = batched_sixdof_init(BENCH_BODIES, seed=0)
            dev = {d: [torch.as_tensor(c, device=job.devices[0], dtype=d) for c in init]
                   for d in dtypes}
            k1 = {d: sk.sixdof_rollout_sharded(*dev[d], DT, BENCH_TICKS, mesh, axis="ep",
                                               dtype=d) for d in dtypes}
        if "nbody" in sections:
            for d, policy in zip(dtypes, ("f32", "f64")):
                execs[d] = _nbody_exec(el, policy, NBODY_BODIES, True,
                                       telemetry_rate=1.0 / (NBODY_DT * NBODY_TICKS),
                                       device=mesh)
                dist.barrier()
                wall = _run_timed(execs[d], NBODY_TICKS)
                report[f"nbody_{policy}_ms_per_tick"] = wall / NBODY_TICKS * 1e3
        torch.cuda.synchronize()
        report["launches"] = {"sixdof_rk4": sk.LAUNCHES, "pairwise_gravity": pw.LAUNCHES}
        expect = {"sixdof_rk4": 2 * ("kernels" in sections),
                  "pairwise_gravity": 2 * NBODY_TICKS * ("nbody" in sections)}
        print(f"{label}: launches of the rank's main path {report['launches']} "
              f"(expected {expect})")
        if report["launches"] != expect:
            raise AssertionError(f"{label}: launches {report['launches']} != {expect}")
        for d, ex in execs.items():
            policy = "f32" if d == torch.float32 else "f64"
            el.set_float_policy(policy)
            whole = {k: ex.column_array(k) for k in SIXDOF_STATE}
            if rank == 0:
                np.savez(os.path.join(out_dir, f"nbody_{str(d)[6:]}.npz"), **whole)
            print(f"{label}: n-body {NBODY_BODIES} bodies, {d}, Exec.run({NBODY_TICKS}) on "
                  f"K2's row blocks: {report[f'nbody_{policy}_ms_per_tick']:.4g} ms/tick, "
                  f"finite {bool(np.isfinite(whole['world_pos']).all())}")
        for d in k1:
            kr = _proc_kernels(label, mesh, k1[d], dev[d], d)
            report.setdefault("kernels", {}).update(kr)

    if "falcon9" in sections:
        report["falcon9"] = _proc_falcon9(label, out_dir)
    return report


def _proc_kernels(label, mesh, k1_out, cols, dtype):
    """One rank's holds and times of the kernels' rank forms in ``dtype``:
    K1's block bitwise against one card's call on it and, at
    ``SPLIT_PLAIN_TICKS``, against the plain version; K2's all-gather form
    against one card's whole call and the plain version of the rank's rows;
    µs a tick and a call (CUDA events, every rank started together)."""
    import torch.distributed as dist

    from elodin_tpu_torch.models.nbody import G
    from elodin_tpu_torch.ops import pairwise as pw
    from elodin_tpu_torch.ops import sixdof_kernel as sk

    tol = F32_TOL if dtype == torch.float32 else F64_TOL
    name = str(dtype)[6:]
    a, b = k1_out[0].addressable_shards[0].index[0].indices(BENCH_BODIES)[:2]
    block = [c[a:b] for c in cols]
    args = dict(device=cols[0].device, dtype=dtype)
    one = sk.sixdof_rollout(*block, DT, BENCH_TICKS, **args)
    if not all(torch.equal(s.addressable_shards[0].data, o) for s, o in zip(k1_out, one)):
        raise AssertionError(f"{label}: K1 rank form != one card's call on its block ({dtype})")
    short = sk.sixdof_rollout_sharded(*cols, DT, SPLIT_PLAIN_TICKS, mesh, axis="ep", dtype=dtype)
    plain = sk.sixdof_rollout_reference(*block, DT, SPLIT_PLAIN_TICKS, **args)
    k1_err = _compare(f"{label}: K1 rank form vs plain, bodies [{a}, {b}) x "
                      f"{SPLIT_PLAIN_TICKS} ticks, {dtype}",
                      _state([s.addressable_shards[0].data for s in short]), _state(plain),
                      SIXDOF_STATE, tol)
    dist.barrier()
    k1_ms = _time_ms(lambda: sk.sixdof_rollout_sharded(*cols, DT, BENCH_TICKS, mesh, axis="ep",
                                                       dtype=dtype))[0] / BENCH_TICKS

    snap = _nbody_snapshot(NBODY_BODIES)
    pos = torch.as_tensor(snap["world_pos"][:, 4:], **args).contiguous()
    mass = torch.as_tensor(snap["inertia"][:, 6], **args).contiguous()
    got = pw.pairwise_gravity_sharded(pos, mass, mesh, axis="ep", g=G)
    shard = got.addressable_shards[0]
    r0, r1 = shard.index[0].indices(NBODY_BODIES)[:2]
    errs = {}
    for what, ref in (("one card", pw.pairwise_gravity(pos, mass, g=G)[r0:r1]),
                      ("plain", pw.pairwise_gravity_reference(pos, mass, g=G, row0=r0,
                                                              rows=r1 - r0))):
        d = (shard.data.double() - ref.double()).abs().max().item()
        errs[what] = (d / ref.double().abs().max().item(), d)
        if not (torch.isfinite(shard.data).all() and errs[what][0] <= tol):
            raise AssertionError(f"{label}: K2 all-gather form vs {what} {dtype}: "
                                 f"{errs[what][0]:.3e}")
    dist.barrier()
    k2_ms = _time_ms(lambda: pw.pairwise_gravity_sharded(pos, mass, mesh, axis="ep", g=G),
                     reps=5, calls=20)[0]
    # the call's two parts alone: the one all-gather of the bodies, the row block's launch
    _, sizes, comm = mesh.rank_blocks("ep", NBODY_BODIES)
    dist.barrier()
    gather_ms = _time_ms(lambda: pw.gather_bodies(comm, pos[r0:r1], mass[r0:r1], sizes),
                         reps=5, calls=20)[0]
    block_ms = _time_ms(lambda: pw.pairwise_gravity(pos, mass, g=G, row0=r0, rows=r1 - r0),
                        reps=5, calls=20)[0]
    print(f"{label}: K1 rank form {dtype}, bodies [{a}, {b}): bitwise equal to one card's "
          f"call on them, {k1_ms * 1e3:.4g} us/tick; K2 all-gather form {dtype}, rows "
          f"[{r0}, {r1}): vs " + ", ".join(f"{w} max|Δ|/max|ref| {e[0]:.3e}"
                                          for w, e in errs.items())
          + f" (tol {tol:g}), {k2_ms * 1e3:.4g} us/call; alone, the all-gather of the "
          f"bodies ({comm.transport}) {gather_ms * 1e3:.4g} us, the row block's launch "
          f"{block_ms * 1e3:.4g} us")
    return {f"sixdof_rk4_{name}": {"ms": k1_ms, "rows": b - a, "max_abs_err": k1_err[1],
                                    "plain_rel_err": k1_err[0], "one_card_max_abs_err": 0.0},
            f"pairwise_gravity_{name}": {"ms": k2_ms, "rows": r1 - r0, "gather_ms": gather_ms,
                                          "block_ms": block_ms,
                                          "max_abs_err": errs["plain"][1],
                                          "plain_rel_err": errs["plain"][0],
                                          "one_card_max_abs_err": errs["one card"][1]}}


def _proc_falcon9(label, out_dir):
    """One rank's falcon9 runs from the two starts the parent wrote to
    ``out_dir`` (``_f9_decision_cols``), its samples over ``dp``; the
    rank's final columns go back to ``out_dir``.  Returns each start's
    ticks, guidance ticks, samples, ms/tick and, for the escalation start,
    the device trace of ``SPLIT_TRACE_TICKS`` ticks."""
    import torch.distributed as dist

    from elodin_tpu_torch import _config
    from elodin_tpu_torch.examples.falcon9 import batched as f9
    from elodin_tpu_torch.parallel import distributed, make_mesh

    _config.set_float_policy("f64")
    rank = distributed.process().rank
    mesh = make_mesh()
    os.environ["ELODIN_MC_SEGMENT_TICKS"] = str(SPLIT_F9_SEGMENT)
    _f9_start_campaign(out_dir, "escalation", mesh=mesh).run(SPLIT_F9_SEGMENT)  # warm-up
    out = {}
    for start in ("escalation", "touchdown"):
        campaign = _f9_start_campaign(out_dir, start, mesh=mesh)
        dist.barrier()
        result = campaign.run(SPLIT_F9_TICKS, until=f9.until_down)
        np.savez(os.path.join(out_dir, f"f9_{start}_rank{rank}.npz"),
                 **{k: result.column(k) for k in result.final})
        out[start] = {"ticks": result.ticks, "gated_runs": campaign.gated_runs,
                      "samples": [result.samples.start, result.samples.stop],
                      "ms_per_tick": result.wall_seconds / result.ticks * 1e3}
        print(f"{label}: falcon9 from the {start} start, samples [{result.samples.start}, "
              f"{result.samples.stop}): {result.ticks} ticks, guidance on "
              f"{campaign.gated_runs}, {out[start]['ms_per_tick']:.4g} ms/tick")
        if start == "escalation":
            # the same start twice over: F9_SAMPLES a rank, as many as one process holds
            twice = _f9_start_campaign(out_dir, start, copies=2, mesh=mesh)
            dist.barrier()
            result = twice.run(SPLIT_F9_TICKS, until=f9.until_down)
            out["escalation_twice_ms_per_tick"] = result.wall_seconds / result.ticks * 1e3
            print(f"{label}: falcon9 escalation start twice over, {2 * len(result.samples)} "
                  f"samples, {len(result.samples)} in this rank: "
                  f"{out['escalation_twice_ms_per_tick']:.4g} ms/tick")
            dist.barrier()
            ops, busy, wall = _device_trace(lambda: campaign.run(SPLIT_TRACE_TICKS))
            out[start].update(trace_ops_per_tick=ops / SPLIT_TRACE_TICKS,
                              trace_busy_ms_per_tick=busy / SPLIT_TRACE_TICKS,
                              trace_wall_ms_per_tick=wall / SPLIT_TRACE_TICKS)
            print(f"{label}: device trace, falcon9 run({SPLIT_TRACE_TICKS}): "
                  f"{ops / SPLIT_TRACE_TICKS:.1f} device ops/tick, busy "
                  f"{busy / SPLIT_TRACE_TICKS:.4g} of {wall / SPLIT_TRACE_TICKS:.4g} ms/tick, "
                  f"this rank's idle share {1 - busy / wall:.2%}")
    return out


def _f9_start_campaign(out_dir, start, copies=1, **placement):
    """falcon9 from the start ``_process_phase`` wrote to ``out_dir``
    (``copies`` times over along the samples), on ``placement`` (a mesh or
    a device)."""
    from elodin_tpu_torch.examples.falcon9 import sim
    from elodin_tpu_torch.monte_carlo import BatchedCampaign

    with np.load(os.path.join(out_dir, f"start_{start}.npz")) as data:
        cols = {k: np.concatenate([data[k]] * copies) for k in data.files}
    world, system = sim.build(None, sensors=False)
    return BatchedCampaign.from_columns(world, system, cols, simulation_rate=sim.SIM_RATE_HZ,
                                        **placement)


def _process_phase(el, kernels):
    """Phase 36: the split across processes.  Two ranks on ``cuda:0`` over
    gloo (staged through the host): the ep-cut six-dof step, the kernels'
    rank forms, n-body through ``Exec`` on K2's row blocks and falcon9 over
    the ranks, each held against one process; then a world of one rank on
    nccl (n-body, so that a real NCCL communicator forms on the card);
    then, with four cards, four ranks on nccl (the kernels' rank forms).
    Adds the ``processes`` entries to the kernels line."""
    import tempfile

    from elodin_tpu_torch.parallel.distributed import launch

    out_dir = tempfile.mkdtemp(prefix="elodin_phase36_")
    starts = _f9_decision_cols(F9_SAMPLES, PROC_RANKS)
    for start, cols in starts.items():
        np.savez(os.path.join(out_dir, f"start_{start}.npz"), **cols)
    t0 = time.perf_counter()
    ranks = launch("chip_smoke:_proc_rank", [["cuda:0"]] * PROC_RANKS, backend="gloo",
                   kwargs={"out_dir": out_dir,
                           "sections": ["sixdof", "kernels", "nbody", "falcon9"]},
                   timeout=PROC_TIMEOUT_S)
    print(f"phase 36: {PROC_RANKS} ranks on cuda:0 (gloo) ran in "
          f"{time.perf_counter() - t0:.2f} s, start-up included")
    _proc_hold(el, ranks, out_dir)

    t0 = time.perf_counter()
    nccl = launch("chip_smoke:_proc_rank", [["cuda:0"]], kwargs={
        "out_dir": out_dir, "sections": ["nbody"]}, timeout=PROC_TIMEOUT_S)[0]
    print(f"phase 36: a world of one rank on nccl ({nccl['transport']}) ran in "
          f"{time.perf_counter() - t0:.2f} s; n-body f32 "
          f"{nccl['nbody_f32_ms_per_tick']:.4g} ms/tick, f64 "
          f"{nccl['nbody_f64_ms_per_tick']:.4g}")
    if nccl["transport"] != "nccl on cuda":
        raise AssertionError(f"phase 36: the world of one rank ran over {nccl['transport']}")
    _proc_hold_nbody(el, out_dir, "nccl, one rank", tol={torch.float32: 0.0,
                                                          torch.float64: 0.0})
    four = None
    if torch.cuda.device_count() >= 4:
        four = launch("chip_smoke:_proc_rank", [[f"cuda:{i}"] for i in range(4)], kwargs={
            "out_dir": out_dir, "sections": ["kernels"]}, timeout=PROC_TIMEOUT_S)
    for entry in kernels:
        entry["processes"] = _proc_entry(entry["name"], ranks, four)


def _proc_hold_nbody(el, out_dir, label, tol):
    """The n-body runs a rank wrote against one process's ``Exec.run`` on
    the card, per channel group (``tol`` 0: bitwise)."""
    for dtype, policy in ((torch.float32, "f32"), (torch.float64, "f64")):
        ex = _nbody_exec(el, policy, NBODY_BODIES, True,
                         telemetry_rate=1.0 / (NBODY_DT * NBODY_TICKS))
        wall = _run_timed(ex, NBODY_TICKS)
        print(f"phase 36, {label}: one process's n-body {dtype}, Exec.run({NBODY_TICKS}): "
              f"{wall / NBODY_TICKS * 1e3:.4g} ms/tick")
        with np.load(os.path.join(out_dir, f"nbody_{str(dtype)[6:]}.npz")) as data:
            ours = {k: torch.as_tensor(data[k]) for k in SIXDOF_STATE}
        ref = {k: torch.as_tensor(ex.column_array(k)) for k in SIXDOF_STATE}
        if tol[dtype] == 0.0:
            if not all(torch.equal(ours[k], ref[k]) for k in SIXDOF_STATE):
                raise AssertionError(f"phase 36, {label}: n-body {dtype} != one process")
            print(f"phase 36, {label}: n-body {dtype} bitwise equal to one process")
        else:
            _compare(f"phase 36, {label}: n-body {NBODY_BODIES} bodies {dtype} x "
                     f"{NBODY_TICKS} ticks vs one process", ours, ref, SIXDOF_STATE, tol[dtype])


def _proc_hold(el, ranks, out_dir):
    """The parent's holds of the two-rank run: n-body within 1e-4 / 1e-12
    of one process; falcon9 bitwise, with the same stop tick and guidance
    count, beside one process's ms/tick."""
    from elodin_tpu_torch.examples.falcon9 import batched as f9

    if {r["transport"] for r in ranks} != {"gloo, staged through the host"}:
        raise AssertionError(f"phase 36: transports {[r['transport'] for r in ranks]}")
    _proc_hold_nbody(el, out_dir, f"{PROC_RANKS} ranks",
                     tol={torch.float32: F32_TOL, torch.float64: F64_TOL})
    el.set_float_policy("f64")
    decided = {"escalation": (SPLIT_F9_TICKS, SPLIT_F9_TICKS), "touchdown": (6, 6)}
    prev = os.environ.get("ELODIN_MC_SEGMENT_TICKS")
    os.environ["ELODIN_MC_SEGMENT_TICKS"] = str(SPLIT_F9_SEGMENT)
    try:
        _f9_start_campaign(out_dir, "escalation", device="cuda").run(SPLIT_F9_SEGMENT)  # warm-up
        for start in decided:
            campaign = _f9_start_campaign(out_dir, start, device="cuda")
            ref = _no_launches(f"phase 36: falcon9 {start}, one process",
                               lambda: campaign.run(SPLIT_F9_TICKS, until=f9.until_down))
            one_ms = ref.wall_seconds / ref.ticks * 1e3
            seen = {(r["falcon9"][start]["ticks"], r["falcon9"][start]["gated_runs"])
                    for r in ranks} | {(ref.ticks, campaign.gated_runs)}
            if seen != {decided[start]}:
                raise AssertionError(f"phase 36: falcon9 {start}: (ticks, guidance ticks) "
                                     f"{seen}, expected {decided[start]}")
            for r in ranks:
                a, b = r["falcon9"][start]["samples"]
                with np.load(os.path.join(out_dir, f"f9_{start}_rank{r['rank']}.npz")) as data:
                    for k in ref.final:
                        if not np.array_equal(data[k], ref.column(k)[a:b]):
                            raise AssertionError(f"phase 36: falcon9 {start}, rank "
                                                 f"{r['rank']}: {k} != one process")
            slowest = max(r["falcon9"][start]["ms_per_tick"] for r in ranks)
            print(f"phase 36: falcon9 {F9_SAMPLES} samples from the {start} start over "
                  f"{PROC_RANKS} ranks: bitwise equal to one process, the same {ref.ticks} "
                  f"ticks and {campaign.gated_runs} guidance ticks; ms/tick by rank "
                  f"{[round(r['falcon9'][start]['ms_per_tick'], 3) for r in ranks]}, one "
                  f"process {one_ms:.4g}; sample-ticks/s {F9_SAMPLES / slowest * 1e3:.4g} "
                  f"over the ranks, {F9_SAMPLES / one_ms * 1e3:.4g} in one process")
            if start == "escalation":
                twice = max(r["falcon9"]["escalation_twice_ms_per_tick"] for r in ranks)
                print(f"phase 36: falcon9 {PROC_RANKS * F9_SAMPLES} samples ({F9_SAMPLES} a "
                      f"rank, the escalation start twice over): {twice:.4g} ms/tick, "
                      f"sample-ticks/s {PROC_RANKS * F9_SAMPLES / twice * 1e3:.4g}, "
                      f"{PROC_RANKS * one_ms / twice:.3g}x one process's")
    finally:
        if prev is None:
            del os.environ["ELODIN_MC_SEGMENT_TICKS"]
        else:
            os.environ["ELODIN_MC_SEGMENT_TICKS"] = prev


def _proc_entry(name, ranks, four):
    """The kernels line's ``processes`` entry of kernel ``name``: the
    two-rank run's launches (by rank) and, per dtype, the slowest rank's
    time, against the bound of its rows' work, and the largest errors; the
    four-card run's times beside them when there was one."""
    entry = {"ranks": len(ranks), "backend": ranks[0]["transport"],
             "launches": [r["launches"][name] for r in ranks]}
    for dtype in (torch.float32, torch.float64):
        key = f"{name}_{str(dtype)[6:]}"
        figures = [r["kernels"][key] for r in ranks]
        rows = max(f["rows"] for f in figures)
        if name == "sixdof_rk4":
            bound = _bound(rows * SIXDOF_TICK_OPS[dtype], rows * SIXDOF_TICK_SFU,
                           30 * rows * dtype.itemsize / BENCH_TICKS, dtype)
        else:
            bound = _pairwise_bound(NBODY_BODIES, dtype, rows=rows)
        entry[str(dtype)[6:]] = {
            "ms": max(f["ms"] for f in figures), "bound_ms": bound[0],
            "bound_by": _bound_by(bound[1]),
            "max_abs_err": max(f["max_abs_err"] for f in figures),
            "one_card_max_abs_err": max(f["one_card_max_abs_err"] for f in figures),
            "four_cards_ms": None if four is None else max(
                r["kernels"][key]["ms"] for r in four)}
        if name == "pairwise_gravity":  # the call's parts alone, the slowest rank's
            for part in ("gather_ms", "block_ms"):
                entry[str(dtype)[6:]][part] = max(f[part] for f in figures)
                entry[str(dtype)[6:]][f"four_cards_{part}"] = None if four is None else max(
                    r["kernels"][key][part] for r in four)
    return entry


def _core_examples():
    """(label, make, ticks, sensor cameras) of each core-API example:
    ``make()`` gives a fresh (world, system, simulation rate)."""
    from elodin_tpu_torch.examples.apollo_lander import main as apollo
    from elodin_tpu_torch.examples.covariance_ellipsoids import main as cov
    from elodin_tpu_torch.examples.ellipsoid import sim as ellipsoid
    from elodin_tpu_torch.examples.geo_frames import sim as geo
    from elodin_tpu_torch.examples.n_body import main as n_body
    from elodin_tpu_torch.examples.rotating_cube import sim as cube
    from elodin_tpu_torch.examples.sensor_camera import main as cam
    from elodin_tpu_torch.examples.voyager import main as voyager

    return [
        ("rotating-cube", lambda: (cube.world(), cube.system(), 1.0 / cube.SIM_TIME_STEP),
         120, ()),
        ("geo-frames", lambda: (geo.world(), geo.system(), 1.0 / geo.SIM_TIME_STEP), 30, ()),
        ("ellipsoid", lambda: (ellipsoid.world()[0], ellipsoid.system(), ellipsoid.SIM_RATE),
         240, ("drone.scene_cam",)),
        ("covariance-ellipsoids", lambda: (cov.world(), cov.system(), cov.SIM_RATE), 97, ()),
        ("sensor-camera", lambda: (cam.world(), cam.system(), 1.0 / cam.SIM_TIME_STEP), 240,
         ("ball_0.scene_cam", "ball_1.thermal_cam")),
        ("voyager", lambda: (*voyager.build(), voyager.SIMULATION_RATE_HZ), 240, ()),
        ("apollo-lander descent",
         lambda: (apollo.build_world(), apollo.build_system(), apollo.SIM_RATE), 240, ()),
        ("n-body main (4 asteroids)",
         lambda: (n_body.build_world(4, 1), n_body.build_system(), 1.0 / n_body.SIM_TIME_STEP),
         100, ()),
    ]


def _hold_columns(label, ours: dict, ref: dict, tol):
    """Every column of two dicts of numpy columns: a float column by max
    |Δ| / max |ref| (a (..., 7) or (..., 6) column per channel group, each
    against its own scale; an all-zero reference by max |Δ|), the rest
    equal.  Returns the worst relative error; raises past ``tol``."""
    worst, parts = 0.0, []
    for name, r in ref.items():
        o = ours[name]
        if r.dtype.kind != "f":
            if not np.array_equal(o, r):
                raise AssertionError(f"{label}: column {name} differs")
            continue
        groups = ({7: ((0, 4), (4, 7)), 6: ((0, 3), (3, 6))}.get(r.shape[-1], ((0, None),))
                  if r.ndim >= 2 else ((0, None),))
        for lo, hi in groups:
            d = float(np.abs(o[..., lo:hi] - r[..., lo:hi]).max()) if r.size else 0.0
            scale = float(np.abs(r[..., lo:hi]).max()) if r.size else 0.0
            rel = d / scale if scale > 0.0 else d
            if not np.isfinite(o[..., lo:hi]).all() or not rel <= tol:
                raise AssertionError(f"{label}: column {name}[{lo}:{hi}] {rel:.3e} "
                                     f"exceeds {tol:g} (or is not finite)")
            worst = max(worst, rel)
            parts.append(rel)
    print(f"{label}: every column within {worst:.3e} (tol {tol:g}; "
          f"{len(parts)} float channel groups)")
    return worst


def _core_example_phase(el, interop):
    """Phase 37 a: each core-API example through ``World.build`` and
    ``Exec.run`` on the card and on the CPU in one process, f64."""
    el.set_float_policy("f64")
    for label, make, ticks, cams in _core_examples():
        cols, walls = {}, {}
        for device in ("cuda", "cpu"):
            world, system, rate = make()
            exec_ = world.build(system, simulation_rate=rate, device=device)
            if exec_.schematic_content != world.schematic_content:
                raise AssertionError(f"{label}: Exec.schematic_content is not the world's")
            missing = [c for c in cams if c not in world.assets]
            if missing or sum("cam" in k for k in world.assets) != len(cams):
                raise AssertionError(f"{label}: sensor cameras {sorted(world.assets)}, "
                                     f"expected {list(cams)}")
            _sync(device)
            t0 = time.perf_counter()
            exec_.run(ticks)
            _sync(device)
            walls[device] = time.perf_counter() - t0
            cols[device] = interop.columns_to_numpy(exec_.cols, exec_.meta)
            if exec_.tick() != ticks:
                raise AssertionError(f"{label}: tick {exec_.tick()} != {ticks}")
            if device == "cuda":
                card = exec_
        schematic = (f"schematic of {len(card.schematic_content)} characters"
                     if card.schematic_content else "no schematic")
        print(f"phase 37, {label}: {ticks} ticks, card {walls['cuda'] / ticks * 1e3:.4g} "
              f"ms/tick, CPU {walls['cpu'] / ticks * 1e3:.4g} ms/tick; {schematic}, "
              f"sensor cameras {list(cams)}")
        _hold_columns(f"phase 37, {label}, card vs CPU", cols["cuda"], cols["cpu"], CORE_TOL)
        _exec_trace(label, card, CORE_TRACE_TICKS)


def _exec_trace(label, exec_, n):
    """The device trace of ``exec_.run(n)``: device ops and busy time a
    tick, and the idle share."""
    ops, busy, wall = _device_trace(lambda: exec_.run(n))
    print(f"device trace, {label} (run({n})): {ops / n:.1f} device ops/tick, device busy "
          f"{busy / n:.4g} ms/tick, wall {wall / n:.4g} ms/tick, idle share "
          f"{1 - busy / wall:.2%}")


def _nbody_batched_phase():
    """Phase 37 b: ``examples.n_body.batched.run`` at its default 8192
    bodies x 200 ticks in f32 and f64 on the card, K2's launches counted
    over each call (a warm and a timed pass); the first ticks held to the
    same runner on the dense edge fold.  Returns the kernels-line entry."""
    from elodin_tpu_torch.examples.n_body import batched
    from elodin_tpu_torch.ops import pairwise as pw
    from elodin_tpu_torch.ops import sixdof_kernel as sk

    n, ticks = NBODY_BATCHED
    out = {}
    for dtype, tol in ((np.float32, 1e-4), (np.float64, 1e-12)):
        name = np.dtype(dtype).name
        stats = {}
        sk.LAUNCHES = pw.LAUNCHES = 0
        res = batched.run(n, ticks, dtype=dtype, device="cuda", stats=stats)
        torch.cuda.synchronize()
        launches = pw.LAUNCHES
        if sk.LAUNCHES:
            raise AssertionError(f"n_body.batched {name}: K1 launched {sk.LAUNCHES} times")
        print(f"phase 37, n_body.batched.run({n}, {ticks}), {name}: {res}; K2 launches "
              f"{launches} in the call, {stats['launches']} in the timed pass")
        if launches != 2 * ticks or stats["launches"] != ticks:
            raise AssertionError(f"n_body.batched {name}: {launches} launches "
                                 f"({stats['launches']} timed), not one a tick")
        if not math.isfinite(res["momentum_drift_rel"]):
            raise AssertionError(f"n_body.batched {name}: momentum drift not finite")
        states = {}
        for use_kernel in (True, False):
            step, state = batched.setup(n, use_kernel, dtype, "cuda")
            states[use_kernel] = batched.advance(step, state, NBODY_BATCHED_PLAIN_TICKS)
        _, err_abs = _compare(f"phase 37, n_body.batched {name}, K2 vs dense edge fold, "
                              f"{n} bodies x {NBODY_BATCHED_PLAIN_TICKS} ticks",
                              states[True], states[False], ("world_pos", "world_vel"), tol)
        step, state = batched.setup(n, True, dtype, "cuda")
        ops, busy, wall = _device_trace(
            lambda: batched.advance(step, state, NBODY_BATCHED_TRACE_TICKS))
        print(f"device trace, n_body.batched {name} ({n} bodies, "
              f"{NBODY_BATCHED_TRACE_TICKS} ticks): "
              f"{ops / NBODY_BATCHED_TRACE_TICKS:.1f} device ops/tick, device busy "
              f"{busy / NBODY_BATCHED_TRACE_TICKS:.4g} ms/tick, wall "
              f"{wall / NBODY_BATCHED_TRACE_TICKS:.4g} ms/tick, idle share "
              f"{1 - busy / wall:.2%}")
        out[name] = {"launches": launches, "timed_pass_launches": stats["launches"],
                     "wall_s": res["wall_s"], "pairs_per_sec": res["pairs_per_sec"],
                     "entity_steps_per_sec": res["entity_steps_per_sec"],
                     "momentum_drift_rel": res["momentum_drift_rel"],
                     "max_abs_err_vs_edge_fold": err_abs,
                     "idle_share": 1 - busy / wall}
    return out


def _apollo_campaign_phase():
    """Phase 37 c: apollo-lander's ``run_dispersed`` at its full width,
    1024 samples from seed 0, cut in depth to ``APOLLO_TICKS``: the card's
    campaign against the CPU's at ``CORE_TOL``, sample-ticks/s and the
    device trace of a few more ticks."""
    from elodin_tpu_torch.examples.apollo_lander import main as apollo

    results = {}
    for device in ("cuda", "cpu"):
        campaign = apollo.make_campaign(APOLLO_SAMPLES, 0, device=device)
        results[device] = campaign.run(APOLLO_TICKS)
        if device == "cuda":
            card = campaign
    card_result = results["cuda"]
    print(f"phase 37, apollo-lander run_dispersed({APOLLO_SAMPLES}, seed=0) cut to "
          f"{APOLLO_TICKS} of its {int(180 * apollo.SIM_RATE)} ticks: card "
          f"{card_result.wall_seconds:.4g} s "
          f"({APOLLO_SAMPLES * APOLLO_TICKS / card_result.wall_seconds:.4g} sample-ticks/s, "
          f"{card_result.wall_seconds / APOLLO_TICKS * 1e3:.4g} ms/tick), CPU "
          f"{results['cpu'].wall_seconds:.4g} s "
          f"({APOLLO_SAMPLES * APOLLO_TICKS / results['cpu'].wall_seconds:.4g} "
          "sample-ticks/s)")
    _hold_columns("phase 37, apollo-lander campaign, card vs CPU, final state",
                  {k: card_result.column(k) for k in card_result.final},
                  {k: results["cpu"].column(k) for k in results["cpu"].final}, CORE_TOL)
    s = apollo.scores(card_result)
    print(f"phase 37, apollo-lander campaign at tick {APOLLO_TICKS}: landed "
          f"{int(s['landed'].sum())}, min altitude {float(s['final'][:, 2].min()):.4g} m, "
          f"min fuel {float(s['fuel'].min()):.6g} kg")
    ops, busy, wall = _device_trace(lambda: card.run(APOLLO_TRACE_TICKS))
    print(f"device trace, apollo-lander campaign ({APOLLO_SAMPLES} samples, "
          f"run({APOLLO_TRACE_TICKS})): {ops / APOLLO_TRACE_TICKS:.1f} device ops/tick, "
          f"device busy {busy / APOLLO_TRACE_TICKS:.4g} ms/tick, wall "
          f"{wall / APOLLO_TRACE_TICKS:.4g} ms/tick, idle share {1 - busy / wall:.2%}")


def _core_phase(el, interop, kernels):
    """Phase 37: the core API and the world's editor hooks.  The examples
    and the apollo campaign launch no hand kernel; n-body's batched runner
    launches K2 once a tick.  Adds ``core_api`` entries to the kernels
    line."""
    _no_launches("phase 37, core-API examples", lambda: _core_example_phase(el, interop))
    batched = _nbody_batched_phase()
    _no_launches("phase 37, apollo-lander campaign", _apollo_campaign_phase)
    for entry in kernels:
        entry["core_api"] = (
            {"path": "examples/n_body/batched.run(8192, 200): warm and timed pass, "
                     "launches counted over the call", **batched}
            # K1's count, read after each call, raised on unless 0
            if entry["name"] == "pairwise_gravity" else {"launches": 0})



def _flight_pair(label, make, ticks, compare_ticks=None, history=True):
    """An example through ``World.build`` and ``Exec.run`` on the card
    (``ticks``) and on the CPU (``compare_ticks``, by default the same),
    every column of the two held at ``compare_ticks``; ``history=False``
    runs both without history, as the JAX tests of rocket-barrowman,
    crazyflie-edu and rc-jet do.  Returns the card's Exec."""
    from elodin_tpu_torch import interop

    compare_ticks = compare_ticks or ticks
    world, system, rate = make()
    card = world.build(system, simulation_rate=rate, device="cuda")
    world, system, rate = make()
    cpu = world.build(system, simulation_rate=rate, device="cpu")
    card.record_history = cpu.record_history = history
    card_s = _run_timed(card, compare_ticks)
    cpu_s = _run_timed(cpu, compare_ticks)
    _hold_columns(f"phase 38, {label}, card vs CPU at {compare_ticks} ticks",
                  interop.columns_to_numpy(card.cols, card.meta),
                  interop.columns_to_numpy(cpu.cols, cpu.meta), FLIGHT_TOL)
    if ticks > compare_ticks:
        card_s += _run_timed(card, ticks - compare_ticks)
    _all_finite(f"phase 38, {label} on the card", card)
    print(f"phase 38, {label}: card {ticks} ticks, {card_s / ticks * 1e3:.4g} ms/tick; CPU "
          f"{compare_ticks} ticks, {cpu_s / compare_ticks * 1e3:.4g} ms/tick "
          f"({'with' if history else 'no'} history)")
    return card


def _flight_examples_phase():
    """Phase 38 a: frames, rocket-barrowman, crazyflie-edu and rc-jet on
    the card and on the CPU in one process, f64, with the JAX tests'
    gates on the card's runs."""
    from elodin_tpu_torch.examples.crazyflie_edu import sim as cf
    from elodin_tpu_torch.examples.frames import main as fr
    from elodin_tpu_torch.examples.rc_jet import sim as rj
    from elodin_tpu_torch.examples.rocket_barrowman import main as rb
    from elodin_tpu_torch.spatial import quat_rotate

    z = {}
    for frame in ("ENU", "NED"):
        walls = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            z[frame, device] = fr.run_drop(frame, DROP_TICKS, device=device)
            walls[device] = time.perf_counter() - t0
        err = float(np.abs(z[frame, "cuda"] - z[frame, "cpu"]).max()
                    / np.abs(z[frame, "cpu"]).max())
        print(f"phase 38, frames drop {frame}: {DROP_TICKS} ticks, card "
              f"{walls['cuda'] / DROP_TICKS * 1e3:.4g} ms/tick, CPU "
              f"{walls['cpu'] / DROP_TICKS * 1e3:.4g} ms/tick (each with the world's "
              f"build), card vs CPU {err:.3e}")
        if not err <= FLIGHT_TOL:
            raise AssertionError(f"frames drop {frame}: card vs CPU {err:.3e}")
    z_enu, z_ned = z["ENU", "cuda"], z["NED", "cuda"]
    if not (z_enu[-1] < z_enu[0] and z_ned[-1] > z_ned[0]):
        raise AssertionError("frames drop: the ball fell the wrong way on the card")
    np.testing.assert_allclose(z_enu, -z_ned, atol=1e-12)

    card = _flight_pair("frames two-body", lambda: (*fr.build_two_body(), fr.SIM_RATE),
                        TWO_BODY_TICKS)
    e = fr.total_energy(card.history(["a.world_pos", "b.world_pos", "a.world_vel",
                                      "b.world_vel"]))
    drift = float(abs(e[-1] - e[0]) / abs(e[0]))
    print(f"phase 38, frames two-body on the card: energy drift {drift:.3e} over "
          f"{TWO_BODY_TICKS} ticks (gate 1e-6)")
    if not drift < 1e-6:
        raise AssertionError(f"frames two-body: energy drift {drift:.3e}")
    _exec_trace("frames two-body", card, FLIGHT_TRACE_TICKS)

    card = _flight_pair("rocket-barrowman",
                        lambda: (rb.world(), rb.system(), 1.0 / rb.SIM_TIME_STEP),
                        RB_TICKS, RB_COMPARE_TICKS, history=False)
    pos = np.asarray(card.read_component("calisto.world_pos")).ravel()
    vel = np.asarray(card.read_component("calisto.world_vel")).ravel()
    nose = quat_rotate(torch.as_tensor(pos[:4]),
                       torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)).numpy()
    angle = float(np.degrees(np.arccos(np.clip(nose @ vel[3:] / np.linalg.norm(vel[3:]),
                                               -1, 1))))
    print(f"phase 38, rocket-barrowman on the card at {RB_TICKS} ticks: altitude "
          f"{pos[6]:.6g} m (gate > 300), nose to velocity {angle:.4g} deg (gate < 25)")
    if not (pos[6] > 300.0 and angle < 25.0):
        raise AssertionError(f"rocket-barrowman: altitude {pos[6]}, angle {angle}")
    _exec_trace("rocket-barrowman", card, FLIGHT_TRACE_TICKS)

    card = _flight_pair("crazyflie-edu", lambda: (cf.world(), cf.system(), cf.SIM_RATE_HZ),
                        CF_TICKS, history=False)
    p = np.asarray(card.read_component("crazyflie.world_pos")).ravel()[4:]
    print(f"phase 38, crazyflie-edu on the card at {CF_TICKS} ticks: position {p} "
          "(gate: z within 0.05 of 0.6 m)")
    if not abs(p[2] - 0.6) < 0.05:
        raise AssertionError(f"crazyflie-edu: not hovering at 0.6 m: {p}")
    _exec_trace("crazyflie-edu", card, FLIGHT_TRACE_TICKS)

    card = _flight_pair("rc-jet", lambda: (rj.world(), rj.system(), rj.SIM_RATE_HZ), RJ_TICKS,
                        history=False)
    _exec_trace("rc-jet", card, FLIGHT_TRACE_TICKS)


def _eci_check():
    """Phase 38 b: the ECI frames are host numpy: ``eci_to_ecef`` at
    2022-06-15 06:30 UTC without IERS data is orthonormal, and
    ``ecef_to_eci`` is its transpose."""
    from elodin_tpu_torch import frames

    ep = frames.Epoch.from_gregorian_utc(2022, 6, 15, 6, 30, 0)
    dcm = frames.eci_to_ecef(ep, frames.IERS(None))
    orth = float(np.abs(dcm @ dcm.T - np.eye(3)).max())
    det = float(np.linalg.det(dcm))
    print(f"phase 38, eci_to_ecef at 2022-06-15 06:30 UTC (no IERS data): "
          f"max |R R^T - I| {orth:.3e}, det {det!r}")
    if not (orth <= 1e-12 and abs(det - 1.0) <= 1e-12):
        raise AssertionError("eci_to_ecef is not orthonormal")
    if not np.array_equal(frames.ecef_to_eci(ep, frames.IERS(None)), dcm.T):
        raise AssertionError("ecef_to_eci is not eci_to_ecef's transpose")


def _wmm_phase():
    """Phase 38 c: ``wmm.field_ned`` on a global 0.25 deg grid at sea
    level on the card: ms a call, points/s, device ops, idle share and
    peak memory; every ``WMM_CPU_STRIDE``-th point held to the CPU; then
    one point.  Returns the figures."""
    from elodin_tpu_torch import wmm

    lon = torch.arange(WMM_LON, dtype=torch.float64) * (2 * math.pi / WMM_LON) - math.pi
    lat = (torch.arange(WMM_LAT, dtype=torch.float64) + 0.5) * (math.pi / WMM_LAT) - math.pi / 2
    grid_lat, grid_lon = (g.reshape(-1) for g in torch.meshgrid(lat, lon, indexing="ij"))
    n = grid_lat.numel()
    card_lat, card_lon = grid_lat.cuda(), grid_lon.cuda()
    alt = torch.zeros_like(card_lat)

    def call():
        return wmm.field_ned(card_lat, card_lon, alt, WMM_YEAR)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    b = call()
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    ms_min, ms_med = _time_ms(call, reps=3)
    ops, busy, wall = _device_trace(call)
    print(f"phase 38, wmm.field_ned on the card, {n} points ({WMM_LON} x {WMM_LAT}, 0.25 deg, "
          f"sea level, year {WMM_YEAR}): {ms_min:.4g} ms a call (median {ms_med:.4g}, CUDA "
          f"events, 3 calls after a warm one), {n / ms_min * 1e3:.4g} points/s; "
          f"{ops} device ops a call, device busy {busy:.4g} ms of {wall:.4g} ms "
          f"(traced), idle share {1 - busy / wall:.2%}; peak card memory {peak_mib:.1f} MiB "
          "above its inputs")
    if b.shape != (n, 3) or not torch.isfinite(b).all():
        raise AssertionError("wmm.field_ned on the card: not finite or of the wrong shape")
    t0 = time.perf_counter()
    held_lat, held_lon = grid_lat[::WMM_CPU_STRIDE], grid_lon[::WMM_CPU_STRIDE]
    ref = torch.cat([wmm.field_ned(held_lat[i:i + WMM_CPU_CHUNK], held_lon[i:i + WMM_CPU_CHUNK],
                                   0.0, WMM_YEAR)
                     for i in range(0, held_lat.numel(), WMM_CPU_CHUNK)])
    cpu_s = time.perf_counter() - t0
    ours = b[::WMM_CPU_STRIDE].cpu()
    err = float((ours - ref).abs().max() / ref.abs().max())
    print(f"phase 38, wmm card vs CPU on every {WMM_CPU_STRIDE}th point ({ref.shape[0]} "
          f"points, CPU {cpu_s:.3g} s in chunks of {WMM_CPU_CHUNK}): max |Δ| / max |B| "
          f"{err:.3e} (tol {WMM_TOL:g}); max |B| {float(ref.abs().max()):.6g} nT")
    if not err <= WMM_TOL:
        raise AssertionError(f"wmm card vs CPU {err:.3e} exceeds {WMM_TOL:g}")
    one_lat, one_lon = card_lat[:1].clone(), card_lon[:1].clone()
    one_ms, _ = _time_ms(lambda: wmm.field_ned(one_lat, one_lon, 0.0, WMM_YEAR), reps=3,
                         calls=10)
    one_ops, one_busy, one_wall = _device_trace(
        lambda: wmm.field_ned(one_lat, one_lon, 0.0, WMM_YEAR))
    print(f"phase 38, wmm.field_ned of one point on the card: {one_ms:.4g} ms a call (CUDA "
          f"events, 10 back-to-back calls), {one_ops} device ops, idle share "
          f"{1 - one_busy / one_wall:.2%}")
    return {"points": n, "ms": ms_min, "points_per_s": n / ms_min * 1e3,
            "device_ops": ops, "idle_share": 1 - busy / wall, "peak_mib": peak_mib,
            "rel_err_vs_cpu": err, "one_point_ms": one_ms, "one_point_ops": one_ops}


def _flight_phase(kernels):
    """Phase 38: the last four core-API examples, the ECI frames and wmm.
    Neither hand kernel runs; adds ``flight_examples`` entries to the
    kernels line."""
    from elodin_tpu_torch import set_float_policy

    set_float_policy("f64")
    t0 = time.perf_counter()

    def run():
        _flight_examples_phase()
        _eci_check()
        return _wmm_phase()

    _no_launches("phase 38, the flight examples, ECI frames and wmm", run)
    print(f"phase 38: {time.perf_counter() - t0:.1f} s")
    for entry in kernels:
        entry["flight_examples"] = {"launches": 0}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _served_nbody(el, n, ticks, db_dir, device="cuda"):
    """Phase 39 (a): n-body on K2 (``build_nbody(n, seed=2)``, f64) built
    with ``db_path`` and served by ``serve_exec`` on a free port, then
    ``Exec.run(ticks)``.  The launch count is set to 0 just before the run
    and read just after.  A port ``Client`` reads every body's
    ``world_pos`` and ``world_vel`` series, held bitwise to the history
    the same ``Exec`` kept (``state_at`` and ``history_frame`` with it).
    Returns the figures printed, and under ``live`` the ``Exec``, the
    server, still up, and the rows read: phase 40 works on them, and
    ``_close_served`` stops the server and checks the reopened database.
    ``device`` (here and in phase 39's other parts) is the card but for a
    rehearsal on the CPU."""
    import elodin_tpu_torch.db as edb
    from elodin_tpu_torch.db.server import serve_exec
    from elodin_tpu_torch.models import build_nbody, build_nbody_system
    from elodin_tpu_torch.ops import pairwise as pw
    from elodin_tpu_torch.ops import sixdof_kernel as sk
    from elodin_tpu_torch.tick_metrics import TickMetrics

    def build(db_path):
        el.set_float_policy("f64")
        return build_nbody(n, seed=2).build(
            build_nbody_system(NBODY_DT, use_kernel=True), device=device,
            simulation_rate=1.0 / NBODY_DT, db_path=db_path)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    out = {}
    # the same run without a server, history on
    plain = build(None)
    sync()
    t0 = time.perf_counter()
    plain.run(ticks)
    plain.flush_telemetry()
    sync()
    out["plain_ms_per_tick"] = (time.perf_counter() - t0) * 1e3 / ticks
    del plain

    exec_ = build(db_dir)
    exec_.commit_hist = TickMetrics().hist["commit"]
    t0 = time.perf_counter()
    server = serve_exec(exec_, "127.0.0.1:0")
    out["serve_setup_s"] = time.perf_counter() - t0
    try:
        stores = len(server.db.components)
        sync()
        sk.LAUNCHES = pw.LAUNCHES = 0
        t0 = time.perf_counter()
        exec_.run(ticks)
        sync()
        run_s = time.perf_counter() - t0
        out["launches"] = {"sixdof_rk4": sk.LAUNCHES, "pairwise_gravity": pw.LAUNCHES}
        if out["launches"]["sixdof_rk4"]:
            raise AssertionError(f"phase 39 (a): K1 launched in the served n-body run: "
                                 f"{out['launches']}")
        exec_.flush_telemetry()
        stored_s = time.perf_counter() - t0
        out["served_run_ms_per_tick"] = run_s * 1e3 / ticks
        out["served_ms_per_tick"] = stored_s * 1e3 / ticks
        out["stores"] = stores
        out["rows_per_s"] = ticks * stores / stored_s
        out["stalls"] = exec_._pump.stalls
        hist = exec_.commit_hist
        out["commit_batches"] = hist.count
        out["commit_ms"] = hist.max_us / 1e3

        names = [q for q in exec_._history.column_names()
                 if q.endswith((".world_pos", ".world_vel"))]
        if len(names) != 2 * n:
            raise AssertionError(f"phase 39 (a): {len(names)} series, expected {2 * n}")
        series = {c: exec_._history.series(c) for c in ("world_pos", "world_vel")}
        start = exec_._history.start_timestamp.timestamp()
        times = np.asarray(exec_._history.times)
        want_ts = np.concatenate([[int(start * 1e6)],
                                  ((start + times[1:]) * 1e6).astype(np.int64)])
        client = edb.Client.connect(f"127.0.0.1:{server.port}")
        try:
            rt = []
            read = {}
            for q in names:
                t1 = time.perf_counter()
                ts, vals = client.time_series(q)
                rt.append(time.perf_counter() - t1)
                comp, row = exec_._history.resolve(q)
                if len(ts) != ticks + 1:
                    raise AssertionError(f"phase 39 (a): {q} has {len(ts)} rows, "
                                         f"expected {ticks + 1}")
                if not np.array_equal(ts, want_ts):
                    raise AssertionError(f"phase 39 (a): {q} timestamps differ")
                if not np.array_equal(np.asarray(vals).reshape(ticks + 1, -1),
                                      series[comp][:, row]):
                    raise AssertionError(f"phase 39 (a): {q} is not bitwise the history")
                read[q] = (ts, np.asarray(vals).reshape(ticks + 1, -1))
        finally:
            client.close()
        out["time_series_ms"] = statistics.median(rt) * 1e3
        last = exec_.state_at(ticks)
        frame = exec_.history_frame(names[0])
        comp0, row0 = exec_._history.resolve(names[0])
        if not (np.array_equal(np.asarray(frame[names[0]]), read[names[0]][1])
                and all(np.array_equal(last[c][row], read[q][1][-1])
                        for q in names for c, row in [exec_._history.resolve(q)])):
            raise AssertionError("phase 39 (a): the client's rows differ from "
                                 "state_at / history_frame")
        ops, busy, wall = _device_trace(lambda: exec_.run(DB_TRACE_TICKS))
        out["ops_per_tick"] = ops / DB_TRACE_TICKS
        out["idle_share"] = 1.0 - busy / wall if ops else math.nan
        if not all(np.isfinite(v[1]).all() for v in read.values()):
            raise AssertionError("phase 39 (a): non-finite rows")
    except BaseException:
        server.stop()
        raise
    # the server stays up for phase 40; _close_served stops it and reopens
    out["live"] = (exec_, server, read)
    return out


def _close_served(served, db_dir, ticks, pattern=None):
    """Phase 39 (a)'s end: stop the server ``_served_nbody`` left running
    (``served["live"]``), then reopen its database from disk: the first
    ``ticks + 1`` rows of every series read in phase 39 (a) must be the
    same there.  Returns ``{store name: (timestamps, rows)}`` of the
    reopened stores whose names match ``pattern`` (fnmatch, any case; none
    without one), read while the database is open once."""
    import fnmatch

    import elodin_tpu_torch.db as edb
    from elodin_tpu_torch.db.vtable import component_id_of

    exec_, server, read = served.pop("live")
    server.stop()
    # the served database's stores hold two files open each: close them
    # before the reopen opens as many again
    exec_.on_commit_batch = None
    del exec_, server
    gc.collect()
    db = edb.Database(db_dir)
    for q, (ts, vals) in read.items():
        store = db.components.get(component_id_of(q))
        if (store is None or store.len < ticks + 1
                or not np.array_equal(store.timestamps[:ticks + 1], ts)
                or not np.array_equal(store.values[:ticks + 1], vals)):
            raise AssertionError(f"phase 39 (a): {q} differs after the reopen")
    kept = {c.name: (np.array(c.timestamps[:c.len]), np.array(c.values[:c.len]))
            for c in db.components.values()
            if pattern and fnmatch.fnmatch(c.name.lower(), pattern.lower())}
    del db
    gc.collect()
    return kept

def _stream_rows(addr, names, rows, state, stop):
    """A client on a real-time stream of ``names`` at ``addr`` (retried
    until the server listens and holds them), appending every row it
    receives to ``rows`` until the stream is closed
    (``state["stream"].close()``, from the caller's thread) or ``stop`` is
    set."""
    import elodin_tpu_torch.db as edb

    deadline = time.perf_counter() + DB_WAIT_S
    while True:
        try:
            client = edb.Client.connect(addr)
            break
        except OSError:
            if time.perf_counter() > deadline or stop.is_set():
                return
            time.sleep(0.01)
    try:
        # the server listens before serve_exec has made the stores, and the
        # stream names the rows it receives from the components it knows
        while not set(names) <= set(client.components()):
            if time.perf_counter() > deadline or stop.is_set():
                return
            time.sleep(0.01)
        state["stream"] = stream = client.stream(names)
        if stop.is_set():  # the run ended before the stream was made
            stream.close()
        for row in stream:
            rows.append(row)
    finally:
        client.close()


def _db_run_resume(el, db_dir, csv_dir, device="cuda"):
    """Phase 39 (b): the three-body example through ``python -m
    elodin_tpu_torch run`` in process on the card, served on a free port
    into ``db_dir`` (``ELODIN_DB_PATH``, ``ELODIN_MAX_TICKS``), with a
    client on a real-time stream; then again with ``ELODIN_RESUME=1`` to
    twice the ticks.  The resumed run's final rows must agree with one
    uninterrupted ``Exec.run`` on the card; then ``db export`` to CSV."""
    import threading

    from elodin_tpu_torch import __main__ as cli
    from elodin_tpu_torch.db.__main__ import main as db_main
    from elodin_tpu_torch.db.storage import Database
    from elodin_tpu_torch.db.vtable import component_id_of, store_name
    from elodin_tpu_torch.examples.three_body import main as tb
    from elodin_tpu_torch.interop import columns_to_numpy

    el.set_float_policy("f64")
    module = "elodin_tpu_torch.examples.three_body.main"
    env = {"ELODIN_DB_PATH": db_dir, "ELODIN_MAX_TICKS": str(DB_RUN_TICKS)}
    saved = {k: os.environ.get(k) for k in (*env, "ELODIN_RESUME")}
    argv = sys.argv
    out = {}
    try:
        os.environ.update(env)
        addr = f"127.0.0.1:{_free_port()}"
        rows, state, stop = [], {}, threading.Event()
        reader = threading.Thread(target=_stream_rows, args=(
            addr, ["a.world_pos", "b.world_pos", "c.world_pos"], rows, state, stop),
            daemon=True)
        reader.start()
        t0 = time.perf_counter()
        try:
            cli.main(["run", module, addr, "--device", device])
        finally:
            stop.set()
            if "stream" in state:
                state["stream"].close()
            reader.join(timeout=DB_WAIT_S)
        out["run_s"] = time.perf_counter() - t0
        out["stream_rows"] = len(rows)
        if reader.is_alive() or len(rows) < DB_STREAM_ROWS:
            raise AssertionError(f"phase 39 (b): the real-time stream received {len(rows)} "
                                 f"rows during the run, expected >= {DB_STREAM_ROWS}")
        if not all(np.isfinite(np.asarray(r[k], dtype=np.float64)).all()
                   for r in rows for k in r.keys()):
            raise AssertionError("phase 39 (b): non-finite streamed rows")

        os.environ["ELODIN_RESUME"] = "1"
        os.environ["ELODIN_MAX_TICKS"] = str(2 * DB_RUN_TICKS)
        t0 = time.perf_counter()
        cli.main(["run", module, f"127.0.0.1:{_free_port()}", "--device", device])
        out["resume_s"] = time.perf_counter() - t0
    finally:
        sys.argv = argv
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    ref = tb.build_world().build(tb.build_system(), simulation_rate=1.0 / tb.SIM_TIME_STEP,
                                 device=device)
    ref.run(2 * DB_RUN_TICKS)
    want = columns_to_numpy(ref.cols, ref.meta)
    db = Database(db_dir)
    worst = 0.0
    for comp, ids in ref.meta.comp_entities.items():
        quals = [store_name(ref.meta, comp, eid) for eid in ids]
        got = np.stack([db.components[component_id_of(q)].latest()[1]
                        for q in quals]).reshape(want[comp].shape)
        ref_col = want[comp]
        if ref_col.dtype.kind != "f":
            if not np.array_equal(got.astype(ref_col.dtype), ref_col):
                raise AssertionError(f"phase 39 (b): resumed {comp} differs: "
                                     f"{got.ravel()[:6]} against {ref_col.ravel()[:6]}")
            continue
        scale = float(np.max(np.abs(ref_col))) or 1.0
        worst = max(worst, float(np.max(np.abs(got - ref_col))) / scale)
    out["resume_rel_err"] = worst
    if worst > DB_RESUME_TOL:
        raise AssertionError(f"phase 39 (b): resumed run max|Δ|/max|ref| {worst:.3e} "
                             f"> {DB_RESUME_TOL}")
    tick = db.components[component_id_of("Globals.tick")].latest()[1]
    if int(np.asarray(tick).reshape(-1)[0]) != 2 * DB_RUN_TICKS:
        raise AssertionError(f"phase 39 (b): resumed run ended at tick {tick}")
    out["rows"] = db.components[component_id_of("a.world_pos")].len
    db_main(["export", db_dir, "--output", csv_dir, "--format", "csv"])
    with open(os.path.join(csv_dir, "a.world_pos.csv")) as f:
        out["csv_rows"] = sum(1 for _ in f) - 1
    if out["csv_rows"] != out["rows"]:
        raise AssertionError(f"phase 39 (b): the CSV holds {out['csv_rows']} rows of "
                             f"{out['rows']}")
    return out


def _wire_world(el):
    """The JAX test's external-control world (``tests/test_db.py``,
    ``test_external_control_over_wire``) on the port: ``wire_thrust``,
    written from outside, integrated into ``wire_vel`` every tick."""
    import typing as ty
    from dataclasses import dataclass, field

    Thrust = ty.Annotated[torch.Tensor, el.Component(
        "wire_thrust", el.ComponentType(el.PrimitiveType.F64, ()),
        metadata={"external_control": "true"})]
    Vel = ty.Annotated[torch.Tensor, el.Component(
        "wire_vel", el.ComponentType(el.PrimitiveType.F64, ()))]

    @dataclass
    class Craft(el.Archetype):
        wire_thrust: Thrust = field(default_factory=lambda: np.float64(0.0))
        wire_vel: Vel = field(default_factory=lambda: np.float64(0.0))

    @el.system
    def integrate(q: el.Query[Thrust, Vel]) -> el.Query[Vel]:
        return q.map(Vel, lambda t, v: v + t)

    w = el.World()
    w.spawn(Craft(), "craft")
    return w, integrate


def _db_external_control(el, db_dir, device="cuda"):
    """Phase 39 (c): a client writes the external-control ``wire_thrust``
    over the wire while the ``Exec`` on the card is served; the write is
    applied before the next tick, whose state on the card shows it."""
    import elodin_tpu_torch.db as edb
    from elodin_tpu_torch.db.server import serve_exec

    el.set_float_policy("f64")
    w, system = _wire_world(el)
    exec_ = w.build(system, db_path=db_dir, device=device)
    server = serve_exec(exec_, "127.0.0.1:0")
    try:
        exec_.run(3)
        client = edb.Client.connect(f"127.0.0.1:{server.port}")
        writer = client.table_writer({"craft.wire_thrust": edb.f64})
        t0 = time.perf_counter()
        writer.write(timestamp_us=10, values={"craft.wire_thrust": 2.5})
        while float(exec_.read_component("craft.wire_thrust")[0]) != 2.5:
            if time.perf_counter() - t0 > DB_WAIT_S:
                raise AssertionError("phase 39 (c): the write never reached the Exec")
            time.sleep(0.001)
        seen_ms = (time.perf_counter() - t0) * 1e3
        exec_.run(1)
        after_one = float(exec_.column_array("wire_vel")[0])
        exec_.run(3)
        after_four = float(exec_.column_array("wire_vel")[0])
        writer.close()
        client.close()
    finally:
        server.stop()
    if exec_.cols["wire_vel"].device.type != device or (after_one, after_four) != (2.5, 10.0):
        raise AssertionError(f"phase 39 (c): wire_vel {after_one}, {after_four} on "
                             f"{exec_.cols['wire_vel'].device}, expected 2.5, 10.0 on the card")
    return {"write_seen_ms": seen_ms}


def _sm_clock():
    """The card's SM clock and its maximum, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _history_rows(exec_, names):
    """(timestamps the tap stores, {series name: its rows}) of ``exec_``'s
    history, flushed."""
    hist = exec_._history
    start = hist.start_timestamp.timestamp()
    times = np.asarray(hist.times)
    ts = np.concatenate([[int(start * 1e6)], ((start + times[1:]) * 1e6).astype(np.int64)])
    cols = {c: hist.series(c) for c in {hist.resolve(q)[0] for q in names}}
    rows = {}
    for q in names:
        comp, row = hist.resolve(q)
        rows[q] = cols[comp][:, row]
        if len(rows[q]) != len(ts):
            raise AssertionError(f"{q}: {len(rows[q])} rows in the history, {len(ts)} times")
    return ts, rows


def _mirror_phase(served, ticks, device="cuda"):
    """Phase 40 (a): a port ``MirrorWorld`` subscribes to every body's
    ``world_pos`` and ``world_vel`` of phase 39 (a)'s served n-body, then
    ``Exec.run(ticks)`` with both launch counts set to 0 just before and
    read just after (K2 ``ticks`` times, K1 never), a flush, and a device
    trace of ``DB_TRACE_TICKS`` more mirrored ticks.  Once the live sink
    holds the last row, every series is backfilled over the whole history
    and ``value_at`` at every stored timestamp must be bitwise the
    ``Exec``'s history: phase 39's rows come through backfill, this run's
    through the live sink."""
    from elodin_tpu_torch.db.mirror import MirrorWorld
    from elodin_tpu_torch.ops import pairwise as pw
    from elodin_tpu_torch.ops import sixdof_kernel as sk

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    exec_, server, _read = served["live"]
    names = [q for q in exec_._history.column_names()
             if q.endswith((".world_pos", ".world_vel"))]
    live = {"rows": 0}

    def count(_name, _ts, _value):  # the sink thread's callback
        live["rows"] += 1

    out = {"series": len(names)}
    before = len(exec_._history.times)
    t0 = time.perf_counter()
    mirror = MirrorWorld.connect(f"127.0.0.1:{server.port}", names)
    out["subscribe_s"] = time.perf_counter() - t0
    try:
        mirror.on_update(count)
        sync()
        sk.LAUNCHES = pw.LAUNCHES = 0
        t0 = time.perf_counter()
        exec_.run(ticks)
        sync()
        run_s = time.perf_counter() - t0
        out["launches"] = {"sixdof_rk4": sk.LAUNCHES, "pairwise_gravity": pw.LAUNCHES}
        if out["launches"] != {"sixdof_rk4": 0, "pairwise_gravity": ticks}:
            raise AssertionError(f"phase 40 (a): launches {out['launches']} in "
                                 f"Exec.run({ticks}), expected K2 {ticks} and K1 0")
        exec_.flush_telemetry()
        out["run_ms_per_tick"] = run_s * 1e3 / ticks
        out["ms_per_tick"] = (time.perf_counter() - t0) * 1e3 / ticks
        ops, busy, wall = _device_trace(lambda: exec_.run(DB_TRACE_TICKS))
        out["ops_per_tick"] = ops / DB_TRACE_TICKS
        out["idle_share"] = 1.0 - busy / wall if ops else math.nan
        exec_.flush_telemetry()
        want_ts, rows = _history_rows(exec_, names)
        last = int(want_ts[-1])
        # every row committed after the subscription reaches the live sink
        live_want = len(names) * (len(want_ts) - before)
        deadline = time.perf_counter() + UI_DRAIN_S
        while live["rows"] < live_want:
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase 40 (a): the live sink received {live['rows']} of "
                                     f"{live_want} rows in {UI_DRAIN_S} s")
            time.sleep(0.02)
        out["sink_s"] = time.perf_counter() - t0
        stale = [q for q in names if mirror.cache.peek(q).latest()[0] != last]
        if stale:
            raise AssertionError(f"phase 40 (a): the live sink lacks the last row of "
                                 f"{len(stale)} series ({stale[:3]} ...)")
        out["live_rows"] = live["rows"]
        out["live_rows_per_s"] = live["rows"] / out["sink_s"]
        if mirror.sink_errors:
            raise AssertionError(f"phase 40 (a): {mirror.sink_errors} rows the sink refused")
        t1 = time.perf_counter()
        out["backfilled_rows"] = 0
        for q in names:
            out["backfilled_rows"] += mirror.backfill(q, int(want_ts[0]), last)
            hist = rows[q]
            for k, t in enumerate(want_ts):
                v = mirror.value_at(q, int(t))
                if v is None or not np.array_equal(np.ravel(v), hist[k]):
                    raise AssertionError(f"phase 40 (a): {q} at {t} (row {k}) is not bitwise "
                                         f"the history")
        out["check_s"] = time.perf_counter() - t1
        out["rows"] = len(want_ts)
        if not all(np.isfinite(r).all() for r in rows.values()):
            raise AssertionError("phase 40 (a): non-finite rows")
    finally:
        mirror.close()
    return out


def _get(url):
    """(status, content type, body) of an HTTP GET over loopback."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=DB_WAIT_S) as r:
        return r.status, r.headers.get_content_type(), r.read()


def _ws_time_series(ws, name, prim, shape, req_id=7):
    """``Client.time_series`` of ``name`` over the ``/ws`` bridge: one
    GetTimeSeries request, its reply decoded as the TCP client decodes it."""
    from elodin_tpu_torch.db import msgs as M
    from elodin_tpu_torch.db.vtable import PRIM_NP, component_id_of

    ws.send_bytes(M.GetTimeSeries(b"\x00\x01", -(2**62), 2**62, component_id_of(name),
                                  None).packet(req_id))
    buf = bytearray()
    while True:
        buf += ws.recv_bytes()
        while len(buf) >= 4:
            n = int.from_bytes(buf[:4], "little")
            if len(buf) - 4 < n:
                break
            pkt = M.parse_packet(bytes(buf[4:4 + n]))
            del buf[:4 + n]
            if pkt.req_id != req_id:
                continue
            if pkt.ty == M.TY_MSG and pkt.id == M.ErrorResponse.ID:
                raise AssertionError(M.ErrorResponse.decode(pkt.body).description)
            rows = int.from_bytes(pkt.body[:8], "little")
            ts = np.frombuffer(pkt.body[8:8 + rows * 8], dtype="<i8")
            vals = np.frombuffer(pkt.body[8 + rows * 8:], dtype=PRIM_NP[prim])
            return ts, vals.reshape((rows,) + tuple(shape))


def _viewer_phase(served):
    """Phase 40 (b): the web viewer and the ``/ws`` bridge of phase 39
    (a)'s server, over loopback.  ``/api/info`` and ``/api/components``
    (every store listed), ``/api/series`` of ``UI_SERIES`` (all rows
    bitwise the history; downsampled to ``UI_LTTB_POINTS``, the history's
    LTTB pick), ``/api/latest``, ``/api/sql`` (a count of rows),
    ``/api/geoms`` (the n-body world has no schematic) and ``/api/drawlist``;
    a ``WsClient`` reads ``UI_SERIES`` through ``/ws``, bitwise the TCP
    client's."""
    import urllib.parse

    import elodin_tpu_torch.db as edb
    from elodin_tpu_torch.db.downsample import lttb
    from elodin_tpu_torch.db.ws import WsClient

    exec_, server, _read = served["live"]
    base = f"http://127.0.0.1:{server.port + 1}"
    out = {}
    stores = {c.name for c in server.db.components.values()}
    info = json.loads(_get(base + "/api/info")[2])
    if info["components"] != len(stores) or info["rows"] <= 0:
        raise AssertionError(f"phase 40 (b): /api/info {info}, {len(stores)} stores")
    listed = {c["name"] for c in json.loads(_get(base + "/api/components")[2])}
    if listed != stores:
        raise AssertionError(f"phase 40 (b): /api/components lists {len(listed)} of "
                             f"{len(stores)} stores")
    want_ts, rows = _history_rows(exec_, [UI_SERIES])
    hist = rows[UI_SERIES]
    q = urllib.parse.quote(UI_SERIES)
    rt = []
    for _ in range(UI_ROUND_TRIPS):
        t0 = time.perf_counter()
        body = _get(f"{base}/api/series?name={q}&max_points=4000")[2]
        rt.append(time.perf_counter() - t0)
    s = json.loads(body)
    if not (np.array_equal(np.asarray(s["t"], dtype=np.int64), want_ts)
            and np.array_equal(np.asarray(s["v"], dtype=np.float64), hist)):
        raise AssertionError("phase 40 (b): /api/series is not bitwise the history")
    out["series_ms"] = statistics.median(rt) * 1e3
    s = json.loads(_get(f"{base}/api/series?name={q}&max_points={UI_LTTB_POINTS}")[2])
    idx = lttb(want_ts.astype(np.float64), hist[:, 0], UI_LTTB_POINTS)
    if not (len(s["t"]) == len(idx) <= UI_LTTB_POINTS
            and np.array_equal(np.asarray(s["t"], dtype=np.int64), want_ts[idx])
            and np.array_equal(np.asarray(s["v"], dtype=np.float64), hist[idx])):
        raise AssertionError("phase 40 (b): the downsampled /api/series is not the "
                             "history's LTTB pick")
    latest = json.loads(_get(f"{base}/api/latest?name={q}")[2])
    if latest["t"] != int(want_ts[-1]) or not np.array_equal(latest["v"], hist[-1]):
        raise AssertionError(f"phase 40 (b): /api/latest {latest}")
    table = edb.sql_table_name(UI_SERIES)
    sql = json.loads(_get(base + "/api/sql?q=" + urllib.parse.quote(
        f"select count(*) from {table}"))[2])
    if sql["rows"] != [[len(want_ts)]]:
        raise AssertionError(f"phase 40 (b): /api/sql count {sql['rows']}, "
                             f"expected {len(want_ts)}")
    geoms = json.loads(_get(base + "/api/geoms")[2])
    if set(geoms) != {"cube", "sphere", "cylinder", "cone"}:
        raise AssertionError(f"phase 40 (b): /api/geoms {sorted(geoms)}")
    drawlist = json.loads(_get(base + "/api/drawlist")[2])
    if drawlist.get("solids"):
        raise AssertionError("phase 40 (b): a draw list for a world with no schematic")

    client = edb.Client.connect(f"127.0.0.1:{server.port}")
    ws = WsClient("127.0.0.1", server.port + 1)
    try:
        tcp = client.time_series(UI_SERIES)
        rt = []
        for _ in range(UI_ROUND_TRIPS):
            t0 = time.perf_counter()
            got = _ws_time_series(ws, UI_SERIES, "f64", (7,))
            rt.append(time.perf_counter() - t0)
        if not (np.array_equal(got[0], tcp[0]) and np.array_equal(got[1], tcp[1])
                and np.array_equal(got[1], hist)):
            raise AssertionError("phase 40 (b): /ws time_series is not bitwise the TCP "
                                 "client's")
        out["ws_ms"] = statistics.median(rt) * 1e3
    finally:
        ws.close()
        client.close()

    out["stores"] = len(stores)
    out["rows"] = len(want_ts)
    return out


def _mp4_samples(mp4: bytes) -> int:
    """The sample count of an MP4's one track (its stsz box)."""
    at = mp4.index(b"stsz")
    return int.from_bytes(mp4[at + 12:at + 16], "big")


def _video_db(db_dir):
    """The video-stream example's producer, its frames as H.264
    (``stream_frames(h264=True)``, paced at its 30 Hz), into a message log
    of a port server on a database of its own; ``/api/videos`` lists the
    log once every frame is stored."""
    import elodin_tpu_torch.db as edb
    from elodin_tpu_torch.examples.video_stream import main as video_stream

    server = edb.Server.start(db_dir)
    try:
        video_stream.stream_frames(server.addr, UI_VIDEO_FRAMES, h264=True)
        base = f"http://127.0.0.1:{server.port + 1}"
        deadline = time.perf_counter() + DB_WAIT_S
        while True:
            videos = json.loads(_get(base + "/api/videos")[2])
            if [v["frames"] for v in videos] == [UI_VIDEO_FRAMES]:
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase 40 (c): /api/videos {videos}")
            time.sleep(0.01)
    finally:
        server.stop()


def _export_phase(db_dir, stored, out_dir):
    """Phase 40 (c): ``python -m elodin_tpu_torch db export --format mcap
    --pattern UI_MCAP_PATTERN`` in process, of the database phase 39 (a)
    and 40 (a) left, closed; read back with ``read_mcap_full``, each
    exported store's channel holds one message a stored row, in order, at
    the row's time, its numbers the row's (``stored``: the rows the
    reopen read).  Then the video-stream example's frames into a message
    log and ``db export-videos``: one MP4, a sample a frame."""
    import contextlib
    import io

    from elodin_tpu_torch.__main__ import main as cli
    from elodin_tpu_torch.db.export_mcap import read_mcap_full

    out = {}
    want = {f"b{i}.{c}" for i in range(DB_BODIES) for c in ("world_pos", "world_vel")
            if fnmatch.fnmatch(f"b{i}.{c}", UI_MCAP_PATTERN)}
    if not want or not want <= set(stored):
        raise AssertionError(f"phase 40 (c): {len(stored)} stores match {UI_MCAP_PATTERN}, "
                             f"without every body's world_pos and world_vel")
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        cli(["db", "export", db_dir, "--output", out_dir, "--format", "mcap",
             "--pattern", UI_MCAP_PATTERN])
    out["mcap_s"] = time.perf_counter() - t0
    gc.collect()  # the export's database: its files close
    path = os.path.join(out_dir, os.path.basename(db_dir) + ".mcap")
    out["mcap_bytes"] = os.path.getsize(path)
    mcap = read_mcap_full(path)
    out["messages"] = len(mcap.messages)
    by_topic = {c["topic"]: cid for cid, c in mcap.channels.items()}
    msgs = {}
    for cid, log_time, data in mcap.messages:
        msgs.setdefault(cid, []).append((log_time, data))

    def leaves(obj):
        if isinstance(obj, dict):
            return [x for v in obj.values() for x in leaves(v)]
        return [obj]

    for name, (ts, values) in stored.items():
        got = msgs.get(by_topic.get("/" + name.replace(".", "/")), [])
        if len(got) != len(ts):
            raise AssertionError(f"phase 40 (c): {name} has {len(got)} messages, "
                                 f"{len(ts)} rows stored")
        for k, (log_time, data) in enumerate(got):
            if (log_time != int(ts[k]) * 1000
                    or not np.array_equal(np.asarray(leaves(json.loads(data)), dtype=np.float64),
                                          np.asarray(values[k], dtype=np.float64).ravel())):
                raise AssertionError(f"phase 40 (c): {name} message {k} is not its stored row")
    out["exported_stores"] = len(stored)
    out["exported_rows"] = sum(len(ts) for ts, _ in stored.values())

    video_db = os.path.join(out_dir, "video_db")
    _video_db(video_db)
    video_dir = os.path.join(out_dir, "videos")
    with contextlib.redirect_stdout(log):
        cli(["db", "export-videos", video_db, "--output", video_dir])
    # the log is named by its message id: a client's send_msg carries no name
    mp4s = sorted(f for f in os.listdir(video_dir) if f.endswith(".mp4"))
    if len(mp4s) != 1:
        raise AssertionError(f"phase 40 (c): export-videos wrote {mp4s}, expected one MP4")
    with open(os.path.join(video_dir, mp4s[0]), "rb") as f:
        mp4 = f.read()
    out["mp4_samples"], out["mp4_bytes"] = _mp4_samples(mp4), len(mp4)
    if out["mp4_samples"] != UI_VIDEO_FRAMES:
        raise AssertionError(f"phase 40 (c): the MP4 holds {out['mp4_samples']} samples, "
                             f"{UI_VIDEO_FRAMES} frames were streamed")
    return out

def _db_client_phase(device=None):
    """Phase 40 (d): the db-client example end to end.  Its ball sim is an
    s10 child (``python -m elodin_tpu_torch run ...``, no ``--device``: the
    sim CLI's default, the card, with no CPU fallback) on a free port for
    ``DBC_TICKS`` ticks; the client sees ``ball.world_pos``, its SQL returns
    5 rows and its write back is read back; then the child's whole process
    group is gone."""
    from elodin_tpu_torch.examples.db_client import main as db_client

    out = db_client.run(f"127.0.0.1:{_free_port()}", device=device,
                        env={"ELODIN_MAX_TICKS": str(DBC_TICKS)})
    if "ball.world_pos" not in out["components"] or out["sql_rows"] != 5:
        raise AssertionError(f"phase 40 (d): components {out['components'][:8]}, "
                             f"sql rows {out['sql_rows']}")
    if float(out["written"]) != 21.5 or len(out["latest"]) != 7:
        raise AssertionError(f"phase 40 (d): wrote {out['written']}, latest {out['latest']}")
    try:
        os.killpg(out["pgid"], 0)
    except ProcessLookupError:
        pass
    else:
        raise AssertionError(f"phase 40 (d): the sim's process group {out['pgid']} outlived "
                             f"stop")
    return out


def _telemetry_ui_phase(kernels, served, tmp, plain_ms, tcp_ms, device="cuda"):
    """Phase 40: the mirror, the web viewer and ``/ws``, MCAP and MP4
    export, and db-client, on phase 39 (a)'s served n-body.  Adds the
    mirrored run's K1 and K2 launches (``telemetry_ui``) to the kernels
    line."""
    t0 = time.perf_counter()
    db_dir = os.path.join(tmp, "nbody")
    a = _mirror_phase(served, UI_TICKS, device)
    t1 = time.perf_counter()
    print(f"phase 40 (a), a MirrorWorld on phase 39's served n-body ({DB_BODIES} bodies on "
          f"K2, f64, {a['series']} series): launches {a['launches']} in "
          f"Exec.run({UI_TICKS}); {a['ms_per_tick']:.4g} ms/tick mirrored (run to flush; "
          f"{a['run_ms_per_tick']:.4g} the run alone) against phase 39's {plain_ms:.4g} "
          f"without a server; device trace of {DB_TRACE_TICKS} mirrored ticks: "
          f"{a['ops_per_tick']:.1f} device ops/tick, idle share {100 * a['idle_share']:.2f}%; "
          f"subscribed in {a['subscribe_s']:.3f} s; the live sink received {a['live_rows']} "
          f"rows ({a['live_rows_per_s']:.6g} rows/s into the mirror, run start to the last "
          f"row in {a['sink_s']:.3f} s), backfill fetched {a['backfilled_rows']}; value_at "
          f"of all {a['series']} x {a['rows']} rows bitwise the history "
          f"({a['check_s']:.2f} s); (a) {t1 - t0:.1f} s")
    b = _no_launches("phase 40 (b), the web viewer and /ws", lambda: _viewer_phase(served))
    print(f"phase 40 (b), the web viewer of that server: /api/info and /api/components "
          f"({b['stores']} stores), /api/series of {UI_SERIES} ({b['rows']} rows) bitwise the "
          f"history and its LTTB pick at {UI_LTTB_POINTS} points, /api/latest, /api/sql "
          f"count, /api/geoms, /api/drawlist; round trips: /api/series {b['series_ms']:.4g} "
          f"ms, /ws time_series {b['ws_ms']:.4g} ms (bitwise the TCP client's), phase 39's "
          f"TCP time_series {tcp_ms:.4g} ms (medians); (b) {time.perf_counter() - t1:.1f} s")
    # (d)'s child spends ~9 s importing torch: it starts now, in a thread
    # of its own, beside phase 39 (a)'s reopen and (c), which are host work
    # in this process with no figure but the export's time
    client = {}

    def db_client():
        start = time.perf_counter()
        try:
            client["out"] = _db_client_phase(None if device == "cuda" else device)
        except BaseException as e:  # noqa: BLE001  (raised again below)
            client["error"] = e
        client["s"] = time.perf_counter() - start

    def reopen_and_export():
        thread = threading.Thread(target=db_client, daemon=True)
        thread.start()
        start = time.perf_counter()
        stored = _close_served(served, db_dir, DB_TICKS, UI_MCAP_PATTERN)
        reopen_s = time.perf_counter() - start
        start = time.perf_counter()
        out = _export_phase(db_dir, stored, os.path.join(tmp, "export"))
        out["s"], out["reopen_s"] = time.perf_counter() - start, reopen_s
        thread.join(timeout=DB_WAIT_S + CHILD_TIMEOUT_S)
        if thread.is_alive():
            raise AssertionError("phase 40 (d): the db-client example never ended")
        if "error" in client:
            raise client["error"]
        return out

    c = _no_launches("phase 40 (c) and (d), export and db-client", reopen_and_export)
    d = client["out"]
    print(f"phase 39 (a)'s reopen: {DB_BODIES * 2} series as read, {c['reopen_s']:.1f} s")
    print(f"phase 40 (c), db export --format mcap --pattern {UI_MCAP_PATTERN!r} of the "
          f"closed database: {c['messages']} messages, {c['mcap_bytes']} bytes in "
          f"{c['mcap_s']:.3f} s; {c['exported_stores']} stores, {c['exported_rows']} rows, "
          f"one message a row, bitwise; the video-stream example's frames (H.264) through a "
          f"server into a log of its own, export-videos: {c['mp4_samples']} samples "
          f"({c['mp4_bytes']} bytes) for {UI_VIDEO_FRAMES} frames; (c) {c['s']:.1f} s")
    print(f"phase 40 (d), the db-client example, beside the reopen and (c): its ball sim an "
          f"s10 child on the card, start-up (spawn to 5 rows served) {d['startup_s']:.3f} s; "
          f"{len(d['components'])} components, SQL {d['sql_rows']} rows, the write back read "
          f"back ({float(d['written'])}); the child's process group gone after stop; (d) "
          f"{client['s']:.1f} s")
    print(f"phase 40: {time.perf_counter() - t0:.1f} s, phase 39 (a)'s reopen "
          f"{c['reopen_s']:.1f} s of it")
    for entry in kernels:
        entry["telemetry_ui"] = {"launches": a["launches"][entry["name"]]}


def _db_phase(kernels):
    """Phases 39 and 40: the telemetry database fed from the card.  Adds the
    served run's K1 and K2 launches (``telemetry_db``) to the kernels line;
    phase 40 (``_telemetry_ui_phase``) mirrors, views and exports phase 39
    (a)'s served n-body, whose server stays up until phase 40 (b) is done."""
    import shutil
    import tempfile

    import elodin_tpu_torch as el

    t0 = time.perf_counter()
    # two files open a store, ~5.1k stores, and the reopen as many again
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = 4 * 5 * DB_BODIES + 1024
    if soft < want:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard if hard < want else want, hard))
    print(f"phase 39: open files {resource.getrlimit(resource.RLIMIT_NOFILE)} (was {soft})")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-db-", dir=os.path.join(REPO, "build"))
    a = {}
    try:
        a = _served_nbody(el, DB_BODIES, DB_TICKS, os.path.join(tmp, "nbody"))
        if a["launches"]["pairwise_gravity"] != DB_TICKS:
            raise AssertionError(f"phase 39 (a): K2 launched {a['launches']} times in "
                                 f"Exec.run({DB_TICKS}), expected {DB_TICKS}")
        print(f"phase 39 (a), n-body {DB_BODIES} bodies on K2 served, f64: launches "
              f"{a['launches']} in Exec.run({DB_TICKS}); {a['stores']} stores set up in "
              f"{a['serve_setup_s']:.3f} s; {a['served_ms_per_tick']:.4g} ms/tick served "
              f"(run to flush; {a['served_run_ms_per_tick']:.4g} the run alone), "
              f"{a['plain_ms_per_tick']:.4g} ms/tick without a server (run to flush, history "
              f"on in both); {a['rows_per_s']:.6g} rows/s stored (run to flush); pump stalls "
              f"{a['stalls']}; writer time for the run's {a['commit_batches']} batch of "
              f"{DB_TICKS} commits (commit_hist) {a['commit_ms']:.4g} ms; client "
              f"time_series round trip {a['time_series_ms']:.4g} ms (median of "
              f"{2 * DB_BODIES}); {2 * DB_BODIES} series of {DB_TICKS + 1} rows bitwise the "
              f"history (and after the reopen, checked once phase 40 (b) is done); device "
              f"trace of {DB_TRACE_TICKS} served ticks: {a['ops_per_tick']:.1f} device "
              f"ops/tick, idle share "
              f"{100 * a['idle_share']:.2f}%")
        b = _no_launches("phase 39 (b), three-body through run and resume", lambda: _db_run_resume(
            el, os.path.join(tmp, "three_body"), os.path.join(tmp, "csv")))
        print(f"phase 39 (b), three-body through `run` on the card: {DB_RUN_TICKS} ticks in "
              f"{b['run_s']:.2f} s (paced at 120 Hz), {b['stream_rows']} rows on the "
              f"real-time stream; resumed to tick {2 * DB_RUN_TICKS} in {b['resume_s']:.2f} s, "
              f"final rows vs one uninterrupted Exec.run max|Δ|/max|ref| "
              f"{b['resume_rel_err']:.3e} (tol {DB_RESUME_TOL}); CSV export {b['csv_rows']} "
              f"rows of a.world_pos")
        c = _no_launches("phase 39 (c), external control",
                         lambda: _db_external_control(el, os.path.join(tmp, "wire")))
        print(f"phase 39 (c), external control on the card: the client's write reached the "
              f"Exec in {c['write_seen_ms']:.3g} ms; wire_vel 2.5 after the next tick, 10.0 "
              f"after 4")
        print(f"phase 39: {time.perf_counter() - t0:.1f} s")
        for entry in kernels:
            entry["telemetry_db"] = {"launches": a["launches"][entry["name"]]}
        _clock("phase 39")
        _telemetry_ui_phase(kernels, a, tmp, a["plain_ms_per_tick"], a["time_series_ms"])
    finally:
        if "live" in a:  # a failure before phase 40 closed it
            a["live"][1].stop()
            del a["live"]
        shutil.rmtree(tmp, ignore_errors=True)


def _fsw_truth(k, rng):
    """The truth writer's ``k``-th sample: a body turning at ``FSW_SPIN``
    about +z from 0.6 rad; the gyro and the magnetometer and sun vectors in
    the body frame, with noise from ``rng``; the attitude goal (identity).
    Returns (the angle, the components)."""
    theta = 0.6 + FSW_SPIN * k / FSW_HZ
    return theta, {
        "gyro_omega": np.array([0.0, 0.0, FSW_SPIN]) + rng.normal(0.0, 0.001, 3),
        "mag_body": np.array([math.cos(theta), -math.sin(theta), 0.0]) + rng.normal(0.0, 0.003, 3),
        "sun_body": np.array([0.0, 0.0, 1.0]) + rng.normal(0.0, 0.003, 3),
        "att_goal": np.array([0.0, 0.0, 0.0, 1.0]),
    }


def _fsw_loop(device):
    """``mekf_system`` piped into ``lqr_system`` on ``device``: the MEKF
    at the driver's rate over the magnetometer and sun vectors, then the
    Yang LQR toward ``att_goal``."""
    from elodin_tpu_torch import fsw

    return fsw.mekf_system(
        sigma_g=[0.01] * 3, sigma_b=[0.001] * 3, dt=1.0 / FSW_HZ,
        refs_fields=["mag_ref", "sun_ref"], body_fields=["mag_body", "sun_body"],
        sigmas=[0.03, 0.03], device=device,
    ).pipe(fsw.lqr_system(j=[0.1, 0.2, 0.3], q_ang_vel=[1.0] * 3, q_pos=[2.0] * 3,
                          r=[0.5] * 3, device=device))


def _fsw_world():
    """A fresh flight-software world: a dataclass of annotated components,
    host numpy, as ``HzDriver`` synchronises them."""
    import typing
    from dataclasses import dataclass, field

    import elodin_tpu_torch as el

    def comp(name, n):
        return typing.Annotated[torch.Tensor,
                                el.Component(name, el.ComponentType(el.PrimitiveType.F64, (n,)))]

    @dataclass
    class FswWorld:
        gyro_omega: comp("gyro_omega", 3) = field(default_factory=lambda: np.zeros(3))
        mag_body: comp("mag_body", 3) = field(default_factory=lambda: np.zeros(3))
        mag_ref: comp("mag_ref", 3) = field(default_factory=lambda: np.array([1.0, 0, 0]))
        sun_body: comp("sun_body", 3) = field(default_factory=lambda: np.zeros(3))
        sun_ref: comp("sun_ref", 3) = field(default_factory=lambda: np.array([0.0, 0, 1.0]))
        att_goal: comp("att_goal", 4) = field(default_factory=lambda: np.array([0.0, 0, 0, 1.0]))
        att_est: comp("att_est", 4) = field(default_factory=lambda: np.array([0.0, 0, 0, 1.0]))
        control_torque: comp("control_torque", 3) = field(default_factory=lambda: np.zeros(3))

    return FswWorld()


def _fsw_drive(addr, device, truth):
    """One live run of the loop on ``device``: ``HzDriver(FSW_HZ)`` for
    ``FSW_UPDATES`` updates against the database at ``addr``, subscribed
    to ``FSW_INPUTS`` and publishing ``FSW_OUTPUTS``.  Each update's pull,
    update and push are timed apart, and the inputs it pulled and the
    outputs it computed are recorded.  Returns the figures, the records
    and the estimate's agreement with the truth writer's last attitude."""
    from elodin_tpu_torch import fsw

    driver = fsw.HzDriver(FSW_HZ, _fsw_loop(device), _fsw_world(), db_addr=addr,
                          subscribe=list(FSW_INPUTS), publish=list(FSW_OUTPUTS))
    # the driver's own step, with its pull, update and push wrapped on the
    # instance to time them and record what each update read and wrote
    records, times, tick = [], [], {}
    pull, update, push = driver._pull, driver.system.update, driver._push

    def timed_pull():
        t0 = time.perf_counter()
        pull()
        tick["pull"] = time.perf_counter() - t0

    def timed_update(world):
        inputs = {f: np.array(getattr(world, f)) for f in FSW_INPUTS}
        t0 = time.perf_counter()
        update(world)
        tick["update"] = time.perf_counter() - t0
        records.append((inputs, {f: np.array(getattr(world, f)) for f in FSW_OUTPUTS}))

    def timed_push(t_us):
        t0 = time.perf_counter()
        push(t_us)
        times.append((tick["pull"], tick["update"], time.perf_counter() - t0))

    driver._pull, driver.system.update, driver._push = timed_pull, timed_update, timed_push
    try:
        t0 = time.perf_counter()
        driver.run(max_ticks=FSW_UPDATES)
        wall = time.perf_counter() - t0
    finally:
        driver.close()
    theta = truth["theta"]
    q_true = np.array([0.0, 0.0, math.sin(theta / 2), math.cos(theta / 2)])
    times = np.array(times) * 1e3
    return {"hz": FSW_UPDATES / wall, "wall_s": wall,
            "pull_ms": float(np.median(times[:, 0])), "update_ms": float(np.median(times[:, 1])),
            "push_ms": float(np.median(times[:, 2])),
            "update_ms_mean": float(times[:, 1].mean()),
            "step_ms": float(np.median(times.sum(axis=1))),
            "dot": abs(float(np.dot(driver.world.att_est, q_true))),
            "records": records, "world": driver.world}


def _fsw_replay(records, device):
    """The recorded inputs, a world each, through a fresh loop on
    ``device`` with no database: the outputs of every update."""
    system, world = _fsw_loop(device), _fsw_world()
    out = []
    for inputs, _ in records:
        for f, v in inputs.items():
            setattr(world, f, v.copy())
        system.update(world)
        out.append({f: getattr(world, f).copy() for f in FSW_OUTPUTS})
    return out


def _fsw_phase(tmp, devices=("cuda", "cpu")):
    """Phase 41 (a): the flight-software loop through a live port database.
    A truth writer thread publishes at ``FSW_HZ``; the MEKF -> LQR loop runs
    in one ``HzDriver`` on the card, then on the card machine's CPU; the
    card run's recorded inputs are replayed through both devices' loops
    with no database and held to ``FSW_TOL`` a tick (and the live card run
    to its replay); the card loop's device ops an update and idle share
    over ``FSW_TRACE_UPDATES`` updates.  ``devices`` are the card and its
    CPU but for a rehearsal on the CPU."""
    import elodin_tpu_torch.db as edb

    card, host = devices
    t0 = time.perf_counter()
    server = edb.Server.start(os.path.join(tmp, "fsw"))
    truth, stop = {}, threading.Event()

    def write():
        client = edb.Client.connect(server.addr)
        writer = client.table_writer({"gyro_omega": edb.f64[3], "mag_body": edb.f64[3],
                                      "sun_body": edb.f64[3], "att_goal": edb.f64[4]})
        rng = np.random.default_rng(FSW_SEED)
        t0, k = time.perf_counter(), 0
        try:
            while not stop.is_set():
                theta, values = _fsw_truth(k, rng)
                writer.write(timestamp_us=time.time_ns() // 1000, values=values)
                truth["theta"], truth["k"] = theta, k
                k += 1
                stop.wait(max(0.0, t0 + k / FSW_HZ - time.perf_counter()))
        finally:
            writer.close()
            client.close()

    thread = threading.Thread(target=write, daemon=True, name="fsw-truth")
    thread.start()
    try:
        probe = edb.Client.connect(server.addr)
        deadline = time.monotonic() + DB_WAIT_S
        while probe.latest("att_goal") is None:
            if time.monotonic() > deadline or not thread.is_alive():
                raise AssertionError("phase 41 (a): the truth writer's rows never arrived")
            time.sleep(0.01)
        probe.close()
        split = {"start": time.perf_counter() - t0}
        runs = {}
        for label, dev in (("card", card), ("cpu", host)):
            t1 = time.perf_counter()
            runs[label] = _fsw_drive(server.addr, dev, truth)
            split[label] = time.perf_counter() - t1
        written = truth["k"] + 1
    finally:
        stop.set()
        thread.join(timeout=DB_WAIT_S)
        server.stop()
    if thread.is_alive():
        raise AssertionError("phase 41 (a): the truth writer never ended")
    for dev, run in runs.items():
        if not run["dot"] > 0.999:
            raise AssertionError(f"phase 41 (a): the MEKF on {dev} did not converge: "
                                 f"|<att_est, q_true>| {run['dot']}")
    records = runs["card"]["records"]
    t1 = time.perf_counter()
    on_card, on_cpu = _fsw_replay(records, card), _fsw_replay(records, host)
    split["replay"] = time.perf_counter() - t1
    errs = {f: max(float(np.abs(a[f] - b[f]).max()) for a, b in zip(on_card, on_cpu))
            for f in FSW_OUTPUTS}
    live = {f: max(float(np.abs(rec[1][f] - b[f]).max()) for rec, b in zip(records, on_card))
            for f in FSW_OUTPUTS}
    for label, e in (("card against CPU", errs), ("the live card run against its replay", live)):
        if not max(e.values()) <= FSW_TOL:
            raise AssertionError(f"phase 41 (a): {label} {e} exceeds {FSW_TOL}")
    system, world = _fsw_loop(card), _fsw_world()
    for f, v in records[-1][0].items():
        setattr(world, f, v)
    t1 = time.perf_counter()
    ops, busy, wall = _device_trace(lambda: [system.update(world)
                                             for _ in range(FSW_TRACE_UPDATES)])
    split["trace"] = time.perf_counter() - t1
    return {"runs": runs, "errs": errs, "live": live, "written": written, "split": split,
            "ops": ops / FSW_TRACE_UPDATES, "idle": 1.0 - busy / wall if ops else math.nan,
            "trace_ms": wall / FSW_TRACE_UPDATES}


def _osd_phase(tmp, device="cuda"):
    """Phase 41 (b): the MSP OSD on a served sim.  The ball example's
    ``Exec`` on the card, built with ``db_path``, served by ``serve_exec``
    for ``OSD_TICKS`` ticks and flushed; ``MspOsdService`` renders
    ``OSD_FRAMES`` frames of ``ball`` into a DisplayPort byte stream; the
    last frame's middle row (speed, horizon, altitude) must be ``render``'s
    of the history's last ``ball.world_pos`` / ``world_vel``.  ``device``
    is the card but for a rehearsal on the CPU."""
    import io

    import elodin_tpu_torch as el
    from elodin_tpu_torch import msp_osd
    from elodin_tpu_torch.db.server import serve_exec
    from elodin_tpu_torch.examples.ball import sim as ball

    el.set_float_policy("f64")
    exec_ = ball.world().build(ball.system(), device=device,
                               simulation_rate=1.0 / ball.SIM_TIME_STEP,
                               db_path=os.path.join(tmp, "ball"))
    server = serve_exec(exec_, "127.0.0.1:0")
    try:
        t0 = time.perf_counter()
        exec_.run(OSD_TICKS)
        exec_.flush_telemetry()
        run_s = time.perf_counter() - t0
        _, rows = _history_rows(exec_, ["ball.world_pos", "ball.world_vel"])
        buf = io.BytesIO()
        svc = msp_osd.MspOsdService(f"127.0.0.1:{server.port}", "ball",
                                    msp_osd.DisplayPortBackend(buf), rate_hz=1000.0)
        step, frame_s = svc.step, []

        def timed(client):
            start = time.perf_counter()
            step(client)
            frame_s.append(time.perf_counter() - start)

        svc.step = timed
        if svc.run(max_frames=OSD_FRAMES) != OSD_FRAMES:
            raise AssertionError("phase 41 (b): the OSD rendered too few frames")
    finally:
        server.stop()
    want = msp_osd.TelemetryState()
    want.update_world_pos(rows["ball.world_pos"][-1])
    want.update_world_vel(rows["ball.world_vel"][-1])
    grid = msp_osd.OsdGrid()
    msp_osd.render(grid, want)
    mid = grid.rows // 2
    data, pos, texts = buf.getvalue(), 0, {}
    while pos < len(data):  # MSP v1 frames: $M> size cmd payload checksum
        size, cmd = data[pos + 3], data[pos + 4]
        payload = data[pos + 5:pos + 5 + size]
        if cmd == msp_osd.MSP_DISPLAYPORT and payload[0] == msp_osd.MSP_DP_WRITE_STRING:
            texts[payload[1]] = payload[4:-1].decode()
        pos += 6 + size
    alt = f"ALT {want.altitude_m():7.1f}"
    spd = f"SPD {want.speed_ms():6.1f}"
    got = texts.get(mid, "")
    if got != grid.line(mid).strip() or alt not in got or spd not in got:
        raise AssertionError(f"phase 41 (b): the OSD's row {mid} reads {got!r}, the "
                             f"history's last state renders {grid.line(mid).strip()!r}")
    if not svc.state.db_connected or svc.state.update_count != OSD_FRAMES:
        raise AssertionError(f"phase 41 (b): the OSD saw the database "
                             f"{svc.state.update_count} of {OSD_FRAMES} frames")
    return {"bytes": len(data), "frame_ms": [1e3 * t for t in frame_s], "row": got,
            "run_ms_per_tick": run_s * 1e3 / OSD_TICKS}


def _fsw_osd_phase(kernels):
    """Phase 41: the flight-software loop (a) and the OSD (b), with neither
    kernel launched.  Adds ``fsw`` (the launches counted in (a) and (b))
    to the kernels line."""
    import shutil
    import tempfile

    import elodin_tpu_torch as el

    t0 = time.perf_counter()
    el.set_float_policy("f64")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-fsw-", dir=os.path.join(REPO, "build"))
    try:
        a, launches_a = _no_launches_counted("phase 41 (a), the FSW loop",
                                             lambda: _fsw_phase(tmp))
        t1 = time.perf_counter()
        for dev, label in (("card", "the card"), ("cpu", "the card machine's CPU")):
            r = a["runs"][dev]
            print(f"phase 41 (a), mekf_system -> lqr_system in HzDriver({FSW_HZ:g}) on {label}, "
                  f"against a live database: {FSW_UPDATES} updates at {r['hz']:.2f} Hz of "
                  f"{FSW_HZ:g} asked ({r['wall_s']:.3f} s); ms an update (medians): pull "
                  f"{r['pull_ms']:.4g} (4 latest round trips), update {r['update_ms']:.4g} "
                  f"(mean {r['update_ms_mean']:.4g}), push {r['push_ms']:.4g}, the step "
                  f"{r['step_ms']:.4g}; |<att_est, q_true>| {r['dot']:.9f} (gate > 0.999)")
        print(f"phase 41 (a): the truth writer published {a['written']} rows at {FSW_HZ:g} Hz; "
              f"the card run's {FSW_UPDATES} recorded inputs replayed with no database, card "
              f"against CPU max|Δ| att_est {a['errs']['att_est']:.3e}, control_torque "
              f"{a['errs']['control_torque']:.3e} (tol {FSW_TOL:g}); the live card run against "
              f"its replay {max(a['live'].values()):.3e}; device trace of "
              f"{FSW_TRACE_UPDATES} card updates: {a['ops']:.1f} device ops an update, "
              f"{a['trace_ms']:.4g} ms an update under the profiler, idle share "
              f"{100 * a['idle']:.2f}%; (a) {t1 - t0:.1f} s: "
              + ", ".join(f"{k} {v:.1f} s" for k, v in a["split"].items()))
        b, launches_b = _no_launches_counted("phase 41 (b), the OSD on a served ball",
                                             lambda: _osd_phase(tmp))
        print(f"phase 41 (b), MspOsdService on the ball served from the card "
              f"({OSD_TICKS} ticks, {b['run_ms_per_tick']:.4g} ms/tick served): {OSD_FRAMES} "
              f"frames, {b['bytes']} DisplayPort bytes, ms a frame "
              f"{', '.join(f'{t:.4g}' for t in b['frame_ms'])}; the middle row {b['row']!r} "
              f"is render's of the history's last state; (b) {time.perf_counter() - t1:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 41: {time.perf_counter() - t0:.1f} s")
    for entry in kernels:
        name = entry["name"]
        entry["fsw"] = {"launches": launches_a[name] + launches_b[name]}


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
    landing_rollouts_per_s = _examples(el)
    single_rtfs = _single_entity(el)
    _threefry(el)
    _clock("phase 24")
    _baselined_examples_phase(el)
    _clock("phase 25")
    _falcon9_sensors(el)
    _clock("phase 26")
    _checkpoints(el)
    _clock("phase 27")
    _cli_phase(single_rtfs)
    _clock("phase 28")
    _lockstep_phase()
    _clock("phase 29")
    _pump_phase(el)
    _clock("phase 30")
    _process_campaign_phase(landing_rollouts_per_s)
    _clock("phase 31")

    _no_launches("phase 32, orbit-retarget", _orbit_phase)
    _clock("phase 32")
    _no_launches("phase 33, neural-hover", _hover_phase)
    _clock("phase 33")
    _no_launches("phase 34, cube-sat-pysim, adcs and J2", _rest_phase)
    _clock("phase 34")
    _split_phase(kernels)
    _clock("phase 35")
    _process_phase(el, kernels)
    _clock("phase 36")
    _core_phase(el, interop, kernels)
    _clock("phase 37")
    _flight_phase(kernels)
    _clock("phase 38")
    _db_phase(kernels)
    _clock("phase 40")
    _fsw_osd_phase(kernels)
    _clock("phase 41")

    if any(m == "jax" or m.startswith(("jax.", "elodin_tpu.")) or m == "elodin_tpu"
           for m in sys.modules):
        raise AssertionError("the port's run imported JAX or the JAX package")

    # 42. results
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
