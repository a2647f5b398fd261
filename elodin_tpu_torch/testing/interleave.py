"""Deterministic thread-interleaving explorer (loom-style concurrency
checker).

The reference relies on Rust's type system plus loom/Miri-style checking
for its lock-free protocols (bbqueue SPSC ring, libs/bbq/; stellarator
executor state); this is the repo's systematic analog for its
Python-level shared-state code: run N thread bodies under a cooperative
scheduler that parks every thread at each traced line and picks the next
runner with a seeded RNG.

Guarantees:

- **One seed = one exact interleaving.** The scheduler is the only source
  of thread switching (workers are parked at every line event), so a
  failing seed replays the identical schedule — print the seed, rerun,
  debug.
- **Seed sweeps = schedule exploration.** `explore()` runs an invariant
  check over a range of seeds; distinct seeds produce distinct
  preemption patterns, including the adversarial ones (preempt between a
  load and the dependent store) that wall-clock stress tests almost never
  hit.

Blocking primitives (a `queue.Queue.put` on a full queue, a lock held by a
parked thread) are handled with a parking timeout: a granted thread that
does not reach its next yield point within `block_timeout` is marked
blocked and other threads are scheduled until it parks again.  While a
thread is blocked-and-running, true parallelism exists, so determinism is
only exact for code that never blocks between yield points — which is the
case for the lock-free protocols this harness primarily targets.  For
lock-based code the checker still explores schedules and still catches
protocol bugs; it just may need a couple of seeds to reproduce one.

Limitations (documented, not checked): worker bodies must not spawn
threads that touch the shared state (they would run untraced), and C-level
operations (struct.pack_into, memoryview writes) are atomic units — the
checker explores interleavings *between* Python lines, which matches
CPython's actual preemption points (the GIL switches between bytecodes,
never inside a C call).

A host-only copy of ``elodin_tpu/testing/interleave.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import random
import sys
import threading


class InterleaveError(RuntimeError):
    """The schedule could not make progress (deadlock or step budget)."""


class Interleaver:
    """Run thread bodies to completion under one seeded schedule.

    Parameters
    ----------
    fns : callables, one per thread (no arguments).
    seed : RNG seed; the full schedule is a pure function of it (absent
        real blocking, see module docstring).
    max_steps : hard cap on scheduler grants, so a livelocked protocol
        (e.g. a consumer spinning on an empty ring that a buggy producer
        never fills) fails fast instead of hanging the suite.
    block_timeout : seconds a granted thread may run without parking
        before it is presumed blocked on a real primitive.
    yield_every : park at every Nth line event (1 = every line; raise it
        to trade coverage for speed on long bodies).

    After ``run()``, ``schedule`` holds the granted thread ids in order —
    two runs with the same seed produce the same list.
    """

    def __init__(self, *fns, seed: int = 0, max_steps: int = 500_000,
                 block_timeout: float = 0.05, yield_every: int = 1):
        if not fns:
            raise ValueError("need at least one thread body")
        self.fns = fns
        self.seed = seed
        self.max_steps = max_steps
        self.block_timeout = block_timeout
        self.yield_every = max(1, yield_every)
        self.cv = threading.Condition()
        self.alive: set[int] = set()
        self.parked: set[int] = set()
        self.blocked: set[int] = set()
        self.errors: list[BaseException] = []
        self.schedule: list[int] = []

    # -- worker side ------------------------------------------------------

    def _park(self, tid: int) -> None:
        # the grant is being REMOVED from `parked` by the scheduler: the
        # worker adds itself and waits until the token is consumed, so one
        # grant buys exactly one step (a worker can never free-run)
        with self.cv:
            self.parked.add(tid)
            self.blocked.discard(tid)
            self.cv.notify_all()
            while tid in self.parked:
                self.cv.wait()

    def _finish(self, tid: int) -> None:
        with self.cv:
            self.alive.discard(tid)
            self.parked.discard(tid)
            self.cv.notify_all()

    def _worker(self, tid: int, fn) -> None:
        counter = [0]

        def trace(frame, event, arg):
            if event == "line":
                counter[0] += 1
                if counter[0] % self.yield_every == 0:
                    self._park(tid)
            return trace

        self._park(tid)  # rendezvous: don't run until first grant
        sys.settrace(trace)
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — reported by run()
            self.errors.append(e)
        finally:
            sys.settrace(None)
            self._finish(tid)

    # -- scheduler --------------------------------------------------------

    def run(self) -> "Interleaver":
        rng = random.Random(self.seed)
        threads = []
        self.alive = set(range(len(self.fns)))
        for tid, fn in enumerate(self.fns):
            t = threading.Thread(
                target=self._worker, args=(tid, fn),
                daemon=True, name=f"interleave-{tid}",
            )
            threads.append(t)
            t.start()

        steps = 0
        with self.cv:
            # wait for every worker's rendezvous park
            self.cv.wait_for(
                lambda: self.parked | self.blocked >= self.alive
                or not self.alive
            )
            while self.alive:
                runnable = sorted(self.parked)
                if not runnable:
                    # every alive thread is running past a real blocking
                    # primitive (or about to park) — wait for one to park
                    ok = self.cv.wait_for(
                        lambda: self.parked or not self.alive,
                        timeout=10 * self.block_timeout,
                    )
                    if not ok and self.alive:
                        # a worker's own exception explains the stall far
                        # better than the secondary deadlock it causes
                        if self.errors:
                            raise self.errors[0]
                        raise InterleaveError(
                            f"deadlock: no thread reached a yield point "
                            f"(seed={self.seed}, step={steps}, "
                            f"blocked={sorted(self.blocked)})"
                        )
                    continue
                tid = runnable[rng.randrange(len(runnable))]
                self.parked.discard(tid)
                self.schedule.append(tid)
                self.cv.notify_all()
                parked_again = self.cv.wait_for(
                    lambda: tid in self.parked or tid not in self.alive,
                    timeout=self.block_timeout,
                )
                if not parked_again and tid in self.alive:
                    self.blocked.add(tid)
                steps += 1
                if steps > self.max_steps:
                    if self.errors:
                        # e.g. one thread died and its partner spins on a
                        # flag it will never set — report the root cause
                        raise self.errors[0]
                    raise InterleaveError(
                        f"step budget exhausted (seed={self.seed}, "
                        f"max_steps={self.max_steps}) — livelock or the "
                        f"bodies are too long for this budget"
                    )

        for t in threads:
            t.join(timeout=10.0)
        if self.errors:
            raise self.errors[0]
        return self


def explore(make, seeds=range(64), **kw) -> int:
    """Sweep schedules: for each seed, ``make()`` returns
    ``(fns, check)`` over *fresh* state; the fns run under that seed's
    schedule and ``check()`` asserts the invariant.  Returns the number of
    schedules explored.  On failure the AssertionError names the seed so
    the exact schedule replays.
    """
    n = 0
    for seed in seeds:
        fns, check = make()
        try:
            Interleaver(*fns, seed=seed, **kw).run()
            check()
        except AssertionError as e:
            raise AssertionError(
                f"invariant failed under schedule seed={seed}: {e}"
            ) from e
        except InterleaveError as e:
            raise InterleaveError(f"seed={seed}: {e}") from e
        n += 1
    return n
