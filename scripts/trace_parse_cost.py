#!/usr/bin/env python3
"""What reading a ``torch.profiler`` trace costs, by the way it is read.

    python3 scripts/trace_parse_cost.py [--ops 2000 20000]

On one CUDA card, traces ``N`` iterations of two small eager ops (2N
device ops) under ``torch.profiler`` with CPU and CUDA activity, then reads
the device ops two ways and prints each way's count, busy milliseconds
(the sum of the ops' durations) and seconds: from the profiler's raw
results (``prof.profiler.kineto_results.events()``, the filter
``chip_smoke.py``'s ``_trace_events`` applies) and through
``prof.events()``, which builds a tree of Python events first.  The two
must give the same ops and busy time.
"""

import argparse
import sys
import time

import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ops", type=int, nargs="+", default=[2000, 20000],
                        help="iterations traced, two device ops each")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("trace_parse_cost: no CUDA device", file=sys.stderr)
        return 1

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(4, device="cuda")
    for n in args.ops:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                x = x * 1.0001 + 1
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        raw = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not _filter_name(e.name())
               and not e.is_hidden_event() and not e.is_user_annotation()]
        raw_busy = sum(e.duration_ns() for e in raw) / 1e6
        t2 = time.perf_counter()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        t3 = time.perf_counter()
        print(f"{n} iterations: traced run and the profiler's exit {t1 - t0:.2f} s; raw "
              f"results {len(raw)} device ops, busy {raw_busy:.4f} ms, read in {t2 - t1:.3f} s; "
              f"prof.events() {len(dev)} device ops, busy {busy:.4f} ms, read in "
              f"{t3 - t2:.2f} s")
        if len(raw) != len(dev):
            raise AssertionError("the two readings differ in their device ops")
    return 0


if __name__ == "__main__":
    sys.exit(main())
