"""Batched Monte Carlo on one torch device (counterpart of
``elodin_tpu/monte_carlo/batched.py``).

Every component column gets a leading sample axis, the per-sample
parameter draws are scattered into the initial state, and one tick of the
whole campaign is the port's ``build_step`` under ``torch.func.vmap`` over
that axis.  Where the JAX package compiles the tick loop into one program,
the port runs it eagerly, tick by tick; the state stays on the device
between segments, and ``until=`` and the history emits are read once per
segment.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch
from torch.func import vmap

from ..execimpl import History
from ..interop import campaign_columns_from_numpy, columns_to_numpy
from ..six_dof import increment_sim_tick_system
from ..system import Pipe, RateGroup, SystemBuilder, as_system, build_step


class BatchedResult:
    """A campaign run's final columns (device tensors, each
    ``(n_samples, n_entities, *shape)``), its wall time and tick count, and
    the decimated history when one was recorded."""

    def __init__(self, meta, final_cols: dict, n_samples: int,
                 wall_seconds: float, ticks: int, history=None,
                 history_times=None):
        self.meta = meta
        self.final = final_cols
        self.n_samples = n_samples
        self.wall_seconds = wall_seconds
        self.ticks = ticks
        # dict component -> (n_emits, n_samples, n_entities, *shape) numpy
        # array; None when not recorded
        self.history = history
        self.history_times = history_times  # (n_emits,) sim-time seconds
        self._resolver = History(meta)

    def column(self, component: str) -> np.ndarray:
        """Final values of a component over samples, as numpy."""
        return columns_to_numpy({component: self.final[component]}, self.meta)[component]

    def component(self, qualified: str) -> np.ndarray:
        """Final values of 'entity.component' across samples: (n, *shape)."""
        comp, row = self._resolver.resolve(qualified)
        return self.column(comp)[:, row]

    def trajectory(self, qualified: str) -> np.ndarray:
        """Decimated per-sample time series of 'entity.component':
        (n_emits, n_samples, *shape).  Needs ``run(..., history_every=K)``."""
        if self.history is None:
            raise ValueError("no trajectories recorded; pass history_every to run()")
        comp, row = self._resolver.resolve(qualified)
        if comp not in self.history:
            raise KeyError(f"{comp} not in recorded history {sorted(self.history)}")
        return self.history[comp][:, :, row]

    @property
    def rollouts_per_second(self) -> float:
        return self.n_samples / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def entity_steps_per_second(self) -> float:
        n_ent = self.meta.entity_count
        return (self.n_samples * n_ent * self.ticks / self.wall_seconds
                if self.wall_seconds else 0.0)


class BatchedCampaign:
    """``n_samples`` dispersed rollouts of one world and system, advanced
    together on ``device``."""

    def __init__(self, world, system, n_samples: int,
                 overrides: dict[str, np.ndarray] | None = None,
                 simulation_rate: float = 120.0,
                 device: str | torch.device = "cuda"):
        world.set_sim_time_step(1.0 / simulation_rate)
        meta, cols = world.snapshot()
        n = int(n_samples)
        resolver = History(meta)
        batched = {name: np.broadcast_to(v, (n,) + v.shape).copy()
                   for name, v in cols.items()}
        for qualified, values in (overrides or {}).items():
            values = np.asarray(values)
            if "." in qualified and qualified.split(".", 1)[0] in meta.entity_names:
                comp, row = resolver.resolve(qualified)
                batched[comp][:, row] = values.reshape((n,) + batched[comp].shape[2:])
            else:
                batched[qualified][:] = values.reshape((n,) + batched[qualified].shape[1:])
        self._setup(meta, batched, system, device)

    @classmethod
    def from_columns(cls, world, system, cols: dict,
                     simulation_rate: float = 120.0,
                     device: str | torch.device = "cuda") -> "BatchedCampaign":
        """A campaign that starts from given columns with a sample axis,
        such as the JAX package's ``BatchedResult.final``, each checked
        against this package's ``world``
        (``interop.campaign_columns_from_numpy``)."""
        world.set_sim_time_step(1.0 / simulation_rate)
        meta, _ = world.snapshot()
        self = cls.__new__(cls)
        self._setup(meta, {k: np.asarray(v) for k, v in cols.items()}, system, device)
        return self

    def _setup(self, meta, batched: dict, system, device) -> None:
        self.meta = meta
        self.device = torch.device(device)
        self.cols = campaign_columns_from_numpy(batched, meta, self.device)
        self.n = next(iter(self.cols.values())).shape[0]
        # the tick is sample-uniform (sample 0's, as the JAX package reads
        # it): tracked here so the rate gates need no device read
        self.tick = int(np.asarray(batched["tick"]).reshape(-1)[0])
        self.gated_runs = 0  # ticks on which a lifted RateGroup ran
        self._stages = self._build_stages(system)

    def _build_stages(self, system) -> list:
        """One batched tick as [(RateGroup or None, vmapped step)].  Each
        ``RateGroup`` of the top-level pipe is lifted outside the sample
        vmap and gated on the host (a gate inside the vmap would run both
        branches and select); the systems between gates run as one vmapped
        pipe."""
        sys_ = as_system(system)
        items = sys_.systems if isinstance(sys_, Pipe) else [sys_]
        if not any(isinstance(s, RateGroup) and s.every > 1 for s in items):
            return [(None, vmap(build_step(self.meta, system)))]
        meta = self.meta

        def vstep(target):
            def step(state):
                b = SystemBuilder(meta, dict(state))
                target.call(b)
                return b.cols

            return vmap(step)

        stages, run = [], [increment_sim_tick_system]
        for s in items:
            if isinstance(s, RateGroup) and s.every > 1:
                stages.append((None, vstep(Pipe(*run))))
                stages.append((s, vstep(s.system)))
                run = []
            else:
                run.append(s.system if isinstance(s, RateGroup) else s)
        if run:
            stages.append((None, vstep(Pipe(*run))))
        return stages

    def step(self, cols: dict) -> dict:
        """One tick of every sample."""
        self.tick += 1
        for rg, f in self._stages:
            if rg is None:
                cols = f(cols)
            elif rg.active(self.tick, cols):
                self.gated_runs += 1
                cols = f(cols)
        return cols

    def _advance(self, cols: dict, ticks: int) -> dict:
        for _ in range(ticks):
            cols = self.step(cols)
        return cols

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, ticks: int, history_every: int = 0,
            history_components: list[str] | None = None,
            until: Callable | None = None) -> BatchedResult:
        """Advance every sample ``ticks`` ticks, in segments of
        ``ELODIN_MC_SEGMENT_TICKS`` (default 20000).

        ``until``: ``cols -> bool tensor`` read at each segment boundary;
        once it holds for every sample the remaining segments are skipped
        (exact when the sim latches its terminal samples, as falcon9's DOWN
        phase does).  ``history_every=K`` records the selected columns every
        K ticks, stacked on the device and copied to the host once per
        segment.  ``result.ticks`` counts the ticks advanced, as the JAX
        package counts them."""
        seg = int(os.environ.get("ELODIN_MC_SEGMENT_TICKS", "20000"))
        seg = max(1, min(seg, ticks))

        def all_done(cols) -> bool:
            return bool(torch.all(until(cols)))

        if history_every:
            if history_components:
                resolver = History(self.meta)
                selected = tuple(sorted({resolver.resolve(q)[0] if "." in q else q
                                         for q in history_components}))
            else:
                selected = tuple(sorted(self.cols))
            n_emits, tail = divmod(ticks, history_every)
            if n_emits == 0:
                raise ValueError(f"history_every={history_every} exceeds ticks={ticks}: "
                                 "no emit would ever fire")
            # each segment covers at most ~seg ticks (at least one emit)
            emits_per_seg = max(1, min(n_emits, seg // max(1, history_every)))
            n_full, rem_emits = divmod(n_emits, emits_per_seg)
            t0 = time.perf_counter()
            cols, ticks_run, stopped, chunks = self.cols, 0, False, []
            for i in range(n_full + (1 if rem_emits else 0)):
                emits = []
                for _ in range(emits_per_seg if i < n_full else rem_emits):
                    cols = self._advance(cols, history_every)
                    emits.append({k: cols[k] for k in selected})
                chunks.append(columns_to_numpy(
                    {k: torch.stack([e[k] for e in emits]) for k in selected}, self.meta))
                ticks_run += len(emits) * history_every
                # the JAX package reads the predicate after each full
                # segment, not after the remainder
                if until is not None and i < n_full and all_done(cols):
                    stopped = True
                    break
            if tail and not stopped:
                cols = self._advance(cols, tail)
                ticks_run += tail
            self._sync()
            wall = time.perf_counter() - t0
            history = {k: np.concatenate([c[k] for c in chunks], axis=0) for k in selected}
            dt = float(cols["simulation_time_step"].reshape(-1)[0])
            n_done = next(iter(history.values())).shape[0] if history else 0
            times = np.arange(1, n_done + 1, dtype=np.float64) * history_every * dt
            self.cols = cols
            return BatchedResult(self.meta, cols, self.n, wall, ticks_run,
                                 history=history, history_times=times)

        n_full, rem = divmod(ticks, seg)
        t0 = time.perf_counter()
        cols, ticks_run, stopped = self.cols, 0, False
        for _ in range(n_full):
            cols = self._advance(cols, seg)
            ticks_run += seg
            if until is not None and all_done(cols):
                stopped = True
                break
        if rem and not stopped:
            cols = self._advance(cols, rem)
            ticks_run += rem
        self._sync()
        wall = time.perf_counter() - t0
        self.cols = cols
        return BatchedResult(self.meta, cols, self.n, wall, ticks_run)


def write_artifacts(result: BatchedResult, out_dir, draws=None, scores=None,
                    quality: dict | None = None) -> dict:
    """Write the campaign's artifact set: plan.csv (the dispersion draws),
    results.csv (per-sample params, scores and validity), perf.csv (pacing),
    summary.json (totals and quality gates) and, when the run recorded
    history, trajectories.npz.

    ``scores`` is a dict name -> (n,) array; a boolean or 0/1 'valid' entry
    drives the validity counts.  ``quality`` takes
    {'min_rollouts_per_sec': X, 'fail_on_degraded': bool}: the run is
    degraded when it ran under the floor."""
    import csv
    import json
    from pathlib import Path

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = result.n_samples
    draws = {k: np.asarray(v) for k, v in (draws or {}).items()}
    scores = {k: np.asarray(v) for k, v in (scores or {}).items()}
    run_ids = [f"mc-{i:06d}" for i in range(n)]

    with open(out / "plan.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["run_id"] + [f"param.{k}" for k in draws])
        for i in range(n):
            w.writerow([run_ids[i]] + [draws[k][i] for k in draws])

    valid = scores.get("valid")
    if valid is None:
        valid = np.ones(n, dtype=bool)
    valid = np.asarray(valid).astype(bool)

    with open(out / "results.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["run_id"] + [f"param.{k}" for k in draws]
                   + [k for k in scores if k != "valid"] + ["valid"])
        for i in range(n):
            w.writerow([run_ids[i]] + [draws[k][i] for k in draws]
                       + [scores[k][i] for k in scores if k != "valid"]
                       + [int(valid[i])])

    rps = result.rollouts_per_second
    quality = dict(quality or {})
    floor = float(quality.get("min_rollouts_per_sec", 0.0))
    degraded = bool(floor and rps < floor)
    with open(out / "perf.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["wall_s", "ticks", "n_samples", "rollouts_per_sec",
                    "entity_steps_per_sec", "degraded"])
        w.writerow([result.wall_seconds, result.ticks, n, rps,
                    result.entity_steps_per_second, int(degraded)])

    if result.history is not None:
        np.savez_compressed(out / "trajectories.npz", times=result.history_times,
                            **result.history)

    summary = {
        "total": n,
        "valid": int(valid.sum()),
        "invalid": int(n - valid.sum()),
        "degraded": int(degraded),
        "passed": int(valid.sum()) if not degraded else 0,
        "wall_s": result.wall_seconds,
        "ticks": result.ticks,
        "rollouts_per_sec": rps,
        "mode": "batched",
        "history_components": sorted(result.history) if result.history else [],
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    if quality.get("fail_on_degraded") and degraded:
        raise RuntimeError(f"campaign degraded: {rps:.1f} rollouts/s under the "
                           f"{floor:.1f} floor")
    return summary


def run_batched(world, system, n_samples: int, ticks: int,
                overrides: dict[str, np.ndarray] | None = None,
                simulation_rate: float = 120.0,
                device: str | torch.device = "cuda") -> BatchedResult:
    return BatchedCampaign(world, system, n_samples, overrides, simulation_rate,
                           device).run(ticks)
