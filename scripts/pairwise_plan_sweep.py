#!/usr/bin/env python3
"""Time the all-pairs gravity kernel (elodin_tpu_torch/ops/csrc/pairwise_gravity.cu)
over launch plans on one CUDA card, with three f64 reciprocal square roots.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 scripts/pairwise_plan_sweep.py [--out build/pairwise_sweep.json]
                                           [--parent DIR]

It builds the kernel as it ships (v0) and two copies of its source whose
first sweep takes another f64 reciprocal square root: CUDA's rsqrt(double)
(v1), and an f32 MUFU seed with two Newton steps in f64 where d2 lies in
f32's normal range, rsqrt(double) elsewhere (v2); it prints ptxas's report
of each.  Then, for the n-body world
``build_nbody(N, seed=2)`` at N = 300, 1024, 4096 and 16384 in f32 and f64,
it launches every plan of a grid (32 to 512 threads, 1/2 rows a thread,
1/2/4/8 CTAs a cluster, the j-slice cut to match) and the plan
``_launch_plan`` picks, and in f64 the two other builds at the picked plan
and at the fastest one.  Each launch is held against the plain PyTorch
version (max |Δ| / max |ref| ≤ 1e-4 in f32, ≤ 1e-12 in f64) and timed by
CUDA events: the min and median over 7 runs of 10 back-to-back launches,
after a warm-up.  It then runs the picked plan at 16384 bodies for about
two seconds a dtype while nvidia-smi samples the SM clock and the power
draw.  With ``--parent DIR`` it also times ``pairwise_gravity``, the
wrapper a caller uses, of the checkout at DIR (an older kernel) and of this
one at the same sizes, each in a process of its own, in the order parent,
this, this, parent: CUDA events around 10 back-to-back calls, as above,
and the host's time inside one call (the median of 200 calls, by the
host's clock).  The card's name and power limit head the output; the rows
and the JSON file give times in µs.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SIZES = (300, 1024, 4096, 16384)
TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
REPS, LAUNCHES_PER_REP, HOST_CALLS = 7, 10, 200
# the body of the shipped rsqrt_fast(double), and what v1 and v2 put there
SHIPPED_F64_RSQRT = """  const double y = rsqrt_approx(d2);
  const double e = fma(-(y * y), d2, 1.0);
  return fma(fma(e, 0.375, 0.5), y * e, y);
"""
F64_RSQRT = {
    1: "  return rsqrt(d2);\n",
    2: """  // d2 in [2^-126, 2^127), tested on the high word (a NaN or a negative
  // d2 falls outside)
  constexpr unsigned kLo = 0x38100000u, kHi = 0x47E00000u;
  if (static_cast<unsigned>(__double2hiint(d2)) - kLo < kHi - kLo) {
    double y = double(rsqrt_approx(float(d2)));
    const double h = 0.5 * d2;
    y = fma(y, fma(-h, y * y, 0.5), y);
    return fma(y, fma(-h, y * y, 0.5), y);
  }
  return rsqrt(d2);
""",
}


def _time_us(fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES_PER_REP):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) * 1e3 / LAUNCHES_PER_REP)
    return min(times), statistics.median(times)


def _build_variant(variant):
    """(library, ptxas report) of the kernel's source with the body of
    ``F64_RSQRT[variant]`` in rsqrt_fast(double), built beside the
    shipped one."""
    from elodin_tpu_torch.ops import _build

    src = (_build.CSRC / "pairwise_gravity.cu").read_text()
    if src.count(SHIPPED_F64_RSQRT) != 1:
        raise RuntimeError("rsqrt_fast(double) in pairwise_gravity.cu is not the body "
                           "this script replaces")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"pairwise_gravity-v{variant}.cu"
    cu.write_text(src.replace(SHIPPED_F64_RSQRT, F64_RSQRT[variant]))
    lib = cu.with_suffix(".so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stdout + proc.stderr


def _inputs(n, dtype):
    from elodin_tpu_torch.models import build_nbody

    _, cols = build_nbody(n, seed=2).snapshot()
    pos = torch.as_tensor(cols["world_pos"][:, 4:], device="cuda", dtype=dtype).contiguous()
    mass = torch.as_tensor(cols["inertia"][:, 6], device="cuda", dtype=dtype).contiguous()
    return pos, mass


def _time_wrapper(root):
    """µs (min, median) of ``pairwise_gravity`` of the checkout at ``root``,
    in a process of its own; one JSON line on stdout."""
    sys.path.insert(0, str(root))
    from elodin_tpu_torch.models.nbody import G
    from elodin_tpu_torch.ops import pairwise as pw

    rows = []
    for n in SIZES:
        for dtype in (torch.float32, torch.float64):
            pos, mass = _inputs(n, dtype)
            out = pw.pairwise_gravity(pos, mass, g=G)
            ref = pw.pairwise_gravity_reference(pos, mass, g=G).double()
            rel = (out.double() - ref).abs().max().item() / ref.abs().max().item()
            t_min, t_med = _time_us(lambda: pw.pairwise_gravity(pos, mass, g=G))
            host = []
            for _ in range(HOST_CALLS):
                t0 = time.perf_counter()
                pw.pairwise_gravity(pos, mass, g=G)
                host.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
            rows.append({"n": n, "dtype": str(dtype), "us_min": t_min, "us_median": t_med,
                         "host_us_median": statistics.median(host), "rel_err": rel})
    print(json.dumps(rows))


def _wrapper_rows(label, root):
    """``_time_wrapper`` of the checkout at ``root``, printed as ``label``."""
    root = Path(root).resolve()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--time-wrapper",
                           str(root)], capture_output=True, text=True, timeout=600, cwd=root)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{proc.stderr}")
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    for row in rows:
        print(f"wrapper {label} {row['n']:6d} {row['dtype']:14s}: min {row['us_min']:9.2f} us "
              f"median {row['us_median']:9.2f} us, host time in a call median "
              f"{row['host_us_median']:7.2f} us, rel err {row['rel_err']:.2e}")
    return rows


def _sampled(fn, seconds):
    """Run fn() for about ``seconds`` while nvidia-smi samples the SM clock
    (MHz) and the power draw (W); returns their medians and launches/s."""
    samples, done = [], threading.Event()

    def sample():
        while not done.is_set():
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                  "--format=csv,noheader,nounits"], capture_output=True,
                                 text=True, timeout=30).stdout.strip().split(",")
            samples.append((float(out[0]), float(out[1])))
            time.sleep(0.1)

    fn()
    torch.cuda.synchronize()
    thread = threading.Thread(target=sample)
    thread.start()
    t0, count = time.perf_counter(), 0
    while time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        count += 50
    rate = count / (time.perf_counter() - t0)
    done.set()
    thread.join()
    clocks = [c for c, _ in samples[1:]] or [c for c, _ in samples]
    power = [p for _, p in samples[1:]] or [p for _, p in samples]
    return statistics.median(clocks), statistics.median(power), rate


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/pairwise_sweep.json")
    parser.add_argument("--parent", help="a checkout whose pairwise_gravity is timed too")
    parser.add_argument("--time-wrapper", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("pairwise_plan_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    if args.time_wrapper:
        _time_wrapper(Path(args.time_wrapper).resolve())
        return 0

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from elodin_tpu_torch.models.nbody import G
    from elodin_tpu_torch.ops import _build
    from elodin_tpu_torch.ops import pairwise as pw

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(f"gpu: {smi}")
    here = Path(__file__).resolve().parents[1]
    wrappers = []
    if args.parent:  # parent, change, change, parent
        wrappers += [_wrapper_rows("parent", args.parent), _wrapper_rows("change", here)]
    with ThreadPoolExecutor() as pool:
        shipped = pool.submit(pw.build)
        jobs = {v: pool.submit(_build_variant, v) for v in F64_RSQRT}
        shipped.result()
        built = {v: j.result() for v, j in jobs.items()}
    libs = {0: pw._library(), **{v: lib for v, (lib, _) in built.items()}}
    print(f"ptxas, v0:\n{_build.build_log('pairwise_gravity').strip()}")
    for v, (_, log) in built.items():
        print(f"ptxas, v{v}:\n{log.strip()}")
    for lib in libs.values():
        for name in pw._LAUNCHERS.values():
            fn = getattr(lib, name)
            fn.argtypes = getattr(pw._library(), name).argtypes
            fn.restype = ctypes.c_int

    def launch(variant, pos, mass, out, plan):
        fn = getattr(libs[variant], pw._LAUNCHERS[pos.dtype])
        err = fn(pos.data_ptr(), mass.data_ptr(), out.data_ptr(), pos.shape[0], 0,
                 pos.shape[0], G, 0.0, *plan, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}, plan {plan}")

    sm = _build.sm_count(torch.cuda.current_device())
    rows = []

    def run(n, dtype, variant, plan, chosen, pos, mass, ref, scale):
        out = torch.empty_like(pos)
        launch(variant, pos, mass, out, plan)
        torch.cuda.synchronize()
        rel = (out.double() - ref).abs().max().item() / scale
        if not (torch.isfinite(out).all() and rel <= TOL[dtype]):
            raise AssertionError(f"{n} {dtype} variant {variant} {plan}: {rel:.3e}")
        t_min, t_med = _time_us(lambda: launch(variant, pos, mass, out, plan))
        row = {"n": n, "dtype": str(dtype), "variant": variant, "plan": plan._asdict(),
               "chosen": plan == chosen, "us_min": t_min, "us_median": t_med,
               "rel_err": rel, "ctas": plan.grid(n)}
        rows.append(row)
        print(f"{n:6d} {str(dtype):14s} v{variant} threads {plan.threads:3d} r {plan.r} "
              f"s {plan.s} slice {plan.slice:5d} ctas {row['ctas']:5d}: min "
              f"{t_min:9.2f} us median {t_med:9.2f} us, rel err {rel:.2e}"
              + ("  <- _launch_plan" if plan == chosen else ""))
        return row

    for n in SIZES:
        for dtype in (torch.float32, torch.float64):
            pos, mass = _inputs(n, dtype)
            ref = pw.pairwise_gravity_reference(pos, mass, g=G).double()
            scale = ref.abs().max().item()
            chosen = pw._launch_plan(n, sm)
            plans = {pw._plan(n, t, r, s) for t in (32, 64, 128, 256, 512)
                     for r in (1, 2) for s in (1, 2, 4, 8)} | {chosen}
            best = min((run(n, dtype, 0, p, chosen, pos, mass, ref, scale) for p in sorted(plans)),
                       key=lambda row: row["us_min"])
            for variant in (1, 2) if dtype == torch.float64 else ():
                for plan in {chosen, pw.Plan(**best["plan"])}:
                    run(n, dtype, variant, plan, chosen, pos, mass, ref, scale)

    for n in SIZES:
        for dtype in ("torch.float32", "torch.float64"):
            mine = [r for r in rows if r["n"] == n and r["dtype"] == dtype]
            best = min(mine, key=lambda r: r["us_min"])
            chosen = next(r for r in mine if r["chosen"] and r["variant"] == 0)
            print(f"best {n} {dtype}: v{best['variant']} {best['plan']} {best['us_min']:.2f} us; "
                  f"_launch_plan {chosen['plan']} {chosen['us_min']:.2f} us")

    clocks = {}
    for dtype in (torch.float32, torch.float64):
        pos, mass = _inputs(16384, dtype)
        out = torch.empty_like(pos)
        plan = pw._launch_plan(16384, sm)
        mhz, watts, rate = _sampled(lambda: launch(0, pos, mass, out, plan), 2.0)
        clocks[str(dtype)] = {"sm_mhz": mhz, "power_w": watts, "us_per_launch": 1e6 / rate}
        print(f"sustained {dtype} at 16384 bodies, {plan}: SM clock median {mhz:.0f} MHz, "
              f"power draw median {watts:.1f} W, {1e6 / rate:.2f} us per launch")

    if args.parent:
        wrappers += [_wrapper_rows("change", here), _wrapper_rows("parent", args.parent)]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"gpu": smi, "rows": rows, "sustained": clocks,
                   "wrappers": wrappers}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
