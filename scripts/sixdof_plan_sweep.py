#!/usr/bin/env python3
"""Time the whole-rollout 6-dof RK4 kernel (elodin_tpu_torch/ops/csrc/sixdof_rk4.cu)
over its launch plans on one CUDA card, beside an older copy of the kernel.

Run from the root of a checkout, on a machine with a card and nvcc:

    git show REV:elodin_tpu_torch/ops/csrc/sixdof_rk4.cu > build/sixdof_rk4_parent.cu
    python3 scripts/sixdof_plan_sweep.py [--parent-cu build/sixdof_rk4_parent.cu]
                                         [--out build/sixdof_sweep.json]

It builds the kernel as it ships and prints its registers and spills
(ptxas) and the instructions of its tick loop (cuobjdump, read by
``scripts/sass_loops.py``).  Then, for the flagship model's bodies
(``batched_sixdof_init(N, seed=0)``) at N = 8192, 32768 and 131072 in f32
and f64, it launches it at 32 to 256 threads a block; ``_launch_plan``'s
pick is among them.  Each launch's result after 20 ticks is held against
the plain PyTorch version (max |Δ| / max |ref| per channel group ≤ 1e-4 in
f32, ≤ 1e-12 in f64), must be bitwise equal to every other's, and a repeat
launch bitwise equal to the first.  Each is timed by CUDA events around
one launch of 2000 ticks, the min and median of 7 launches after a
warm-up, beside the bound of a tick (``chip_smoke._bound`` of the
function's operations, ``SIXDOF_TICK_OPS``).

With ``--parent-cu FILE`` (an older sixdof_rk4.cu, whose launchers take a
block size as this one's do, or none) it also builds that file and times it and the picked plan at
each point in the order parent, change, change, parent, to bound the noise
between the two, each with its share of the same bound.  The card's name
and power limit head the output, the SM clock ends it; the JSON file holds
every row in µs a tick.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SIZES = (8192, 32768, 131072)
DT, CHECK_TICKS, TICKS, REPS = 1.0 / 120.0, 20, 2000, 7
TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
THREADS = (32, 64, 128, 256)


def _time_us(fn, ticks):
    """(min, median) µs a tick of fn() (one launch of ``ticks`` ticks) by
    CUDA events, over REPS launches after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) * 1e3 / ticks)
    return min(times), statistics.median(times)


def _rel(out, ref):
    """max |Δ| / max |ref| over the channel groups of a (13, N) state."""
    worst = 0.0
    for a, b in ((0, 4), (4, 7), (7, 10), (10, 13)):
        o, r = out[a:b].double(), ref[a:b].double()
        worst = max(worst, (o - r).abs().max().item() / r.abs().max().item())
    return worst


def _build(name, cu, stem, plan=True):
    """(library, launcher stem, path, ptxas report, whether its launchers
    take a block size) of ``cu`` built with the shipped kernel's flags; its
    launchers ``stem``_f32/_f64 take one unless ``plan`` is False (an older
    source)."""
    from elodin_tpu_torch.ops import _build as build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = build.BUILD_DIR / f"{name}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    for suffix in ("_f32", "_f64"):
        fn = getattr(dll, stem + suffix)
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_double] * 5
                       + [ctypes.c_int] * plan + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return dll, stem, lib, proc.stdout + proc.stderr, plan


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/sixdof_sweep.json")
    parser.add_argument("--parent-cu", help="an older sixdof_rk4.cu to time beside this one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("sixdof_plan_sweep: needs a CUDA card", file=sys.stderr)
        return 1

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import chip_smoke
    import sass_loops
    from elodin_tpu_torch.models import sixdof_batch as model
    from elodin_tpu_torch.models.sixdof_batch import batched_sixdof_init
    from elodin_tpu_torch.ops import _build as build
    from elodin_tpu_torch.ops import sixdof_kernel as sk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(f"gpu: {smi}")
    shipped = _build("sixdof_rk4_shipped", build.CSRC / "sixdof_rk4.cu", "sixdof_rk4")
    parent = None
    if args.parent_cu:
        parent_cu = Path(args.parent_cu).resolve()
        parent = _build("sixdof_rk4_parent", parent_cu, "sixdof_rk4",
                        plan="int threads" in parent_cu.read_text())
    builds = {}
    for label, (_, stem, lib, log, _) in [("shipped", shipped),
                                          *([("parent", parent)] if parent else [])]:
        sass = sass_loops.sass_text(str(lib))
        for name, (regs, st, ld) in sass_loops.ptxas_resources(log, stem + "_kernel").items():
            counts = [loop[3] for loop in sass_loops.loop_counts(sass, name)]
            dtype = "f32" if f"{stem}_kernelIf" in name else "f64"
            builds[f"{label} {dtype}"] = {"registers": regs, "spill_stores": st,
                                          "spill_loads": ld, "loop_instructions": counts}
            print(f"build {label}, {dtype}: {regs} registers, spills {st}/{ld} bytes, "
                  f"tick loops of {counts} SASS instructions")

    def launcher(built, dtype, u, par, out, n):
        dll, stem, _, _, takes_threads = built
        fn = getattr(dll, stem + ("_f32" if dtype == torch.float32 else "_f64"))
        stream = torch.cuda.current_stream().cuda_stream
        consts = (DT, model.MU, model.THRUST, model.TORQUE, model.DRAG)

        def go(ticks, threads):
            plan = (threads,) if takes_threads else ()
            err = fn(u.data_ptr(), par.data_ptr(), out.data_ptr(), n, ticks, *consts, *plan,
                     stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
        return go

    sm = build.sm_count(torch.cuda.current_device())
    rows, pairs = [], []
    for n in SIZES:
        cols = batched_sixdof_init(n, seed=0)
        for dtype in (torch.float32, torch.float64):
            u, par = sk.pack_state(*cols, device="cuda", dtype=dtype)
            ref = sk._rollout_reference(u, par, DT, CHECK_TICKS)
            chosen = sk._launch_plan(n, sm)
            if chosen not in THREADS:
                raise AssertionError(f"_launch_plan's {chosen} threads are not among the swept")
            bound = chip_smoke._bound(n * chip_smoke.SIXDOF_TICK_OPS[dtype],
                                      n * chip_smoke.SIXDOF_TICK_SFU,
                                      30 * n * dtype.itemsize / TICKS, dtype)[0] * 1e3
            first = None
            out, again = torch.empty_like(u), torch.empty_like(u)
            go = launcher(shipped, dtype, u, par, out, n)
            for threads in THREADS:
                go(CHECK_TICKS, threads)
                launcher(shipped, dtype, u, par, again, n)(CHECK_TICKS, threads)
                torch.cuda.synchronize()
                rel = _rel(out, ref)
                what = f"{n} {dtype} {threads} threads"
                if not (torch.isfinite(out).all() and rel <= TOL[dtype]):
                    raise AssertionError(f"{what}: {rel:.3e} against the plain version")
                if not torch.equal(out, again):
                    raise AssertionError(f"{what}: a repeat launch differs")
                if first is None:
                    first = out.clone()
                elif not torch.equal(out, first):
                    raise AssertionError(f"{what}: not bitwise the first launch's result")
                t_min, t_med = _time_us(lambda: go(TICKS, threads), TICKS)
                row = {"n": n, "dtype": str(dtype), "threads": threads,
                       "chosen": threads == chosen, "us_min": t_min, "us_median": t_med,
                       "rel_err": rel, "bound_us": bound, "share": bound / t_min}
                rows.append(row)
                print(f"{n:6d} {str(dtype):14s} threads {threads:3d}: min {t_min:.4f} median "
                      f"{t_med:.4f} us/tick, {row['share']:.1%} of the bound {bound:.4f}, "
                      f"rel err {rel:.2e}" + ("  <- _launch_plan" if row["chosen"] else ""))
            if parent is not None:
                p_out = torch.empty_like(u)
                old = launcher(parent, dtype, u, par, p_out, n)
                new = launcher(shipped, dtype, u, par, torch.empty_like(u), n)
                old(CHECK_TICKS, chosen)
                torch.cuda.synchronize()
                p_rel = _rel(p_out, ref)
                order = []
                for who in ("parent", "change", "change", "parent"):
                    fn_t = ((lambda: old(TICKS, chosen)) if who == "parent" else
                            (lambda: new(TICKS, chosen)))
                    order.append((who, _time_us(fn_t, TICKS)[0]))
                pairs.append({"n": n, "dtype": str(dtype), "threads": chosen,
                              "order": order, "parent_rel_err": p_rel, "bound_us": bound})
                print(f"{n:6d} {str(dtype):14s} parent/change/change/parent, {chosen} threads: "
                      + ", ".join(f"{who} {t:.4f} ({bound / t:.1%})" for who, t in order)
                      + f" us/tick (share of the bound {bound:.4f}); parent rel err {p_rel:.2e}")

    for n in SIZES:
        for dtype in ("torch.float32", "torch.float64"):
            mine = [r for r in rows if r["n"] == n and r["dtype"] == dtype]
            best = min(mine, key=lambda r: r["us_min"])
            chosen = next(r for r in mine if r["chosen"])
            print(f"best {n} {dtype}: {best['threads']} threads "
                  f"{best['us_min']:.4f} us/tick ({best['share']:.1%}); _launch_plan "
                  f"{chosen['threads']} threads {chosen['us_min']:.4f} ({chosen['share']:.1%})")
    clock = chip_smoke._sm_clock()
    print(f"SM clock and its maximum after the sweep: {clock}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"gpu": smi, "sm_clock": clock, "rows": rows, "parent": pairs,
                   "builds": builds}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
