"""Batched Monte Carlo on a torch device, or with the sample axis cut over
a mesh of devices (counterpart of ``elodin_tpu/monte_carlo/batched.py``).

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
from ..interop import campaign_columns_from_numpy, columns_to_numpy, sample_count
from ..parallel.mesh import NamedSharding, gather, on_device, put_global
from ..six_dof import increment_sim_tick_system
from ..system import Pipe, RateGroup, SystemBuilder, as_system, build_step


class BatchedResult:
    """A campaign run's final columns (device tensors, each
    ``(n_samples, n_entities, *shape)``), its wall time and tick count, and
    the decimated history when one was recorded."""

    def __init__(self, meta, final_cols: dict, n_samples: int,
                 wall_seconds: float, ticks: int, history=None,
                 history_times=None, samples=None):
        self.meta = meta
        self.final = final_cols
        self.n_samples = n_samples
        # the samples ``final`` and ``history`` hold: all of them, or this
        # rank's of a campaign across processes
        self.samples = samples if samples is not None else range(n_samples)
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
    together on ``device`` (``"cuda"`` by default), or with the sample axis
    cut over the devices of ``mesh``.

    With a mesh the samples split over its axis ``axis_name`` (or its first
    axis when it has none by that name, as in the JAX package), placed by
    ``parallel.put_global``: shard k holds samples ``[k n / s, (k + 1) n /
    s)`` on the k-th device of that axis, and a sample count the axis does
    not divide raises ``ValueError``, as ``jax.device_put`` does.  Each tick
    steps every shard with the same vmapped tick; what joins the shards is
    read on the host: a rate group's ``full_rate_when`` escalates every
    shard when any sample of any shard asks (``RateGroup.active``),
    ``until=`` stops when every sample of every shard holds it, and history
    emits and the result are gathered in sample order on the axis's first
    device.  The shards are issued in turn from the calling thread, each
    under its device; a host thread a shard was measured slower on the card
    (``PERF.md``, the split over cards).

    On a mesh across processes (``parallel.make_mesh()`` after
    ``init_multihost``; its other axes of size 1) each rank builds the same
    campaign and steps only its own shards; the joins become one
    all-reduce each over the ranks after the local vote (``until=`` an ALL,
    ``full_rate_when`` an ANY), and the result holds the rank's samples,
    ``result.samples`` of the ``n_samples``."""

    def __init__(self, world, system, n_samples: int,
                 overrides: dict[str, np.ndarray] | None = None,
                 simulation_rate: float = 120.0, mesh=None, axis_name: str = "samples",
                 device: str | torch.device | None = None):
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
        self._setup(meta, batched, system, device, mesh, axis_name)

    @classmethod
    def from_columns(cls, world, system, cols: dict,
                     simulation_rate: float = 120.0,
                     device: str | torch.device | None = None, mesh=None,
                     axis_name: str = "samples") -> "BatchedCampaign":
        """A campaign that starts from given columns with a sample axis,
        such as the JAX package's ``BatchedResult.final``, each checked
        against this package's ``world``
        (``interop.campaign_columns_from_numpy``)."""
        world.set_sim_time_step(1.0 / simulation_rate)
        meta, _ = world.snapshot()
        self = cls.__new__(cls)
        self._setup(meta, {k: np.asarray(v) for k, v in cols.items()}, system, device,
                    mesh, axis_name)
        return self

    def _setup(self, meta, batched: dict, system, device, mesh, axis_name) -> None:
        self.meta = meta
        self.mesh, self.axis_name = mesh, axis_name
        self._comm = None  # the ranks' collectives on a mesh across processes
        if mesh is None:
            self.devices = [torch.device(device if device is not None else "cuda")]
        elif device is not None:
            raise ValueError(f"pass a device or a mesh, not both (device {device}, {mesh})")
        else:
            if axis_name not in mesh.axis_names:
                self.axis_name = mesh.axis_names[0]
            if mesh.distributed:
                if any(size != 1 for a, size in mesh.shape.items() if a != self.axis_name):
                    raise ValueError(f"a campaign across processes cuts its samples over "
                                     f"{self.axis_name!r} only; the mesh is {mesh.shape}")
                self.devices = [mesh.devices[p] for p in mesh.local_positions()]
                self._comm = mesh.comm()
            else:
                self.devices = mesh.axis_devices(self.axis_name)
        self.device = self.devices[0]
        self.n = sample_count(batched)
        self.samples = range(self.n)  # the samples this process steps
        if mesh is None:
            self._parts = [campaign_columns_from_numpy(batched, meta, self.device)]
        else:
            sharding = NamedSharding(mesh, (self.axis_name,))
            placed = {k: put_global(sharding, v) for k, v in
                      campaign_columns_from_numpy(batched, meta, "cpu").items()}
            self._parts = [{k: p.shards[i] for k, p in placed.items()}
                           for i in range(len(self.devices))]
            if mesh.distributed:
                index = next(iter(placed.values())).indices
                self.samples = range(index[0][0].start, index[-1][0].stop)
        # the tick is sample-uniform (sample 0's, as the JAX package reads
        # it): tracked here so the rate gates need no device read
        self.tick = int(np.asarray(batched["tick"]).reshape(-1)[0])
        self.gated_runs = 0  # ticks on which a lifted RateGroup ran
        self._stages = self._build_stages(system)

    @property
    def cols(self) -> dict:
        """The campaign's columns, whole (gathered on ``device`` when the
        samples are cut over a mesh)."""
        return self._gather(self._parts)

    def _gather(self, parts: list[dict], dim: int = 0) -> dict:
        """The shards' columns joined along their sample dimension ``dim``
        on ``device`` (one shard's dict as it is)."""
        if len(parts) == 1:
            return parts[0]
        return {k: gather([p[k] for p in parts], self.device, dim) for k in parts[0]}

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

    def _each(self, f, parts: list[dict]) -> list[dict]:
        """``f`` of every shard's columns, each under its device, in turn."""
        out = []
        for device, cols in zip(self.devices, parts):
            with on_device(device):
                out.append(f(cols))
        return out

    def _tick(self, parts: list[dict]) -> list[dict]:
        """One tick of every sample of every shard."""
        self.tick += 1
        for rg, f in self._stages:
            if rg is None:
                parts = self._each(f, parts)
            elif rg.active(self.tick, *parts, join=self._comm.any if self._comm else None):
                self.gated_runs += 1
                parts = self._each(f, parts)
        return parts

    def step(self, cols: dict) -> dict:
        """One tick of every sample of ``cols``, the columns of a campaign
        on one device."""
        return self._tick([cols])[0]

    def _advance(self, parts: list[dict], ticks: int) -> list[dict]:
        for _ in range(ticks):
            parts = self._tick(parts)
        return parts

    def _sync(self) -> None:
        for device in dict.fromkeys(self.devices):
            if device.type == "cuda":
                torch.cuda.synchronize(device)

    def _all_done(self, until, parts: list[dict]) -> bool:
        """``until`` holds for every sample of every shard (one device
        read, then one all-reduce across processes)."""
        votes = [torch.all(until(p)).to(self.device) for p in parts]
        done = bool(torch.stack(votes).all())
        return self._comm.all(done) if self._comm else done

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

        if history_every:
            if history_components:
                resolver = History(self.meta)
                selected = tuple(sorted({resolver.resolve(q)[0] if "." in q else q
                                         for q in history_components}))
            else:
                selected = tuple(sorted(self._parts[0]))
            n_emits, tail = divmod(ticks, history_every)
            if n_emits == 0:
                raise ValueError(f"history_every={history_every} exceeds ticks={ticks}: "
                                 "no emit would ever fire")
            # each segment covers at most ~seg ticks (at least one emit)
            emits_per_seg = max(1, min(n_emits, seg // max(1, history_every)))
            n_full, rem_emits = divmod(n_emits, emits_per_seg)
            t0 = time.perf_counter()
            parts, ticks_run, stopped, chunks = self._parts, 0, False, []
            for i in range(n_full + (1 if rem_emits else 0)):
                emits = []
                for _ in range(emits_per_seg if i < n_full else rem_emits):
                    parts = self._advance(parts, history_every)
                    emits.append([{k: p[k] for k in selected} for p in parts])
                # (emits, samples, ...), the shards' samples in order
                chunks.append(columns_to_numpy(self._gather(
                    [{k: torch.stack([e[s][k] for e in emits]) for k in selected}
                     for s in range(len(parts))], dim=1), self.meta))
                ticks_run += len(emits) * history_every
                # the JAX package reads the predicate after each full
                # segment, not after the remainder
                if until is not None and i < n_full and self._all_done(until, parts):
                    stopped = True
                    break
            if tail and not stopped:
                parts = self._advance(parts, tail)
                ticks_run += tail
            self._sync()
            wall = time.perf_counter() - t0
            history = {k: np.concatenate([c[k] for c in chunks], axis=0) for k in selected}
            dt = float(parts[0]["simulation_time_step"].reshape(-1)[0])
            n_done = next(iter(history.values())).shape[0] if history else 0
            times = np.arange(1, n_done + 1, dtype=np.float64) * history_every * dt
            self._parts = parts
            return BatchedResult(self.meta, self._gather(parts), self.n, wall, ticks_run,
                                 history=history, history_times=times, samples=self.samples)

        n_full, rem = divmod(ticks, seg)
        t0 = time.perf_counter()
        parts, ticks_run, stopped = self._parts, 0, False
        for _ in range(n_full):
            parts = self._advance(parts, seg)
            ticks_run += seg
            if until is not None and self._all_done(until, parts):
                stopped = True
                break
        if rem and not stopped:
            parts = self._advance(parts, rem)
            ticks_run += rem
        self._sync()
        wall = time.perf_counter() - t0
        self._parts = parts
        return BatchedResult(self.meta, self._gather(parts), self.n, wall, ticks_run,
                             samples=self.samples)


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


def run_rank(builder: str, n_samples: int, ticks: int, *, until: str | None = None,
             out_dir: str | None = None, **builder_kwargs) -> dict:
    """One rank of a campaign a process a card: run it in every rank of
    ``parallel.distributed.launch``, e.g.

        launch("elodin_tpu_torch.monte_carlo.batched:run_rank",
               [["cuda:0"], ["cuda:1"]], kwargs={
                   "builder": "elodin_tpu_torch.examples.falcon9.batched:make_campaign",
                   "n_samples": 10000, "ticks": 300,
                   "until": "elodin_tpu_torch.examples.falcon9.batched:until_down"})

    Each rank builds the world and the system itself: ``builder``
    ("module:function", called as ``builder(n_samples, mesh=mesh,
    **builder_kwargs)``) returns a ``BatchedCampaign``, or a tuple whose
    first item is one, over ``parallel.make_mesh()``; ``until`` names the
    stop predicate the same way (a system or a predicate does not pickle,
    so the ranks import them).  The rank's final columns go to
    ``out_dir/rank<k>.npz`` when it is given.  Returns the ticks run, the
    gated ticks, the rank's samples [start, stop) and its wall seconds."""
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh

    made = distributed.import_target(builder)(n_samples, mesh=make_mesh(), **builder_kwargs)
    campaign = made[0] if isinstance(made, tuple) else made
    result = campaign.run(ticks, until=distributed.import_target(until) if until else None)
    rank = distributed.process().rank
    if out_dir is not None:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: result.column(k) for k in result.final})
    return {"rank": rank, "ticks": result.ticks, "gated_runs": campaign.gated_runs,
            "samples": [result.samples.start, result.samples.stop],
            "wall_s": result.wall_seconds}


def run_batched(world, system, n_samples: int, ticks: int,
                overrides: dict[str, np.ndarray] | None = None,
                simulation_rate: float = 120.0, mesh=None,
                device: str | torch.device | None = None) -> BatchedResult:
    return BatchedCampaign(world, system, n_samples, overrides, simulation_rate, mesh,
                           device=device).run(ticks)
