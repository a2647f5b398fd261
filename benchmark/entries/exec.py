"""Entry driver ``exec``: one continued simulation through the port's
``World.build`` and ``Exec.run``, as ``cli.py``'s ``bench`` runs it.

Set-up draws the initial columns from the seed with the configuration's
copy of the model's draws, spawns them as one batch of rigid bodies, builds
the cell's system (``system``: ``module:function``, called with the
configuration's time step and ``system_args``) and the ``Exec`` on the
card at the configuration's rate and the cell's telemetry rate, and sets
``record_history`` as the cell states.  Each call is ``Exec.run`` of
``ticks_per_call`` ticks, continuing from the last.

Three numbers are judged after the window.  ``start_gap``: the columns the
``Exec`` was built with against the harness's, exactly.  ``state_gap``:
set-up's first call, from the harness's columns, and each compared call of
the window, from the program's state before it (copied, with the state
after, outside the call's timing), against the reference's ticks from that
state.  ``late_gap``: the state after the window's last call against the
reference's every tick from the harness's columns, so that a fault between
calls, or one that drifts the state over the window, shows too.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from benchmark.harness import gaps

STATE = ("world_pos", "world_vel")
POLICY = {"float64": "f64", "float32": "f32"}


class Driver:
    def __init__(self, cell, seed: int, device: str):
        import elodin_tpu_torch as el

        t, self.config = cell.traffic, cell.config
        self.ref = cell.reference()
        self.dtype = self.config["dtype"]
        self.bodies, self.ticks_per_call = t["bodies"], t["ticks_per_call"]
        self.ticks = 0  # every tick the Exec has run since it was built
        el.set_float_policy(POLICY[self.dtype])
        pos, vel, inertia = self.ref.initial_columns(self.bodies, np.random.default_rng(seed),
                                                     self.config)
        self.start = {"world_pos": pos, "world_vel": vel, "inertia": inertia}
        self.inertia = torch.from_numpy(inertia).to(device)
        world = el.World()
        zeros = np.zeros((self.bodies, 6))
        world.spawn_batch(el.Body(
            world_pos=el.SpatialTransform.from_array(pos),
            world_vel=el.SpatialMotion.from_array(vel),
            inertia=el.SpatialInertia.from_array(inertia),
            force=el.SpatialForce.from_array(zeros),
            world_accel=el.SpatialMotion.from_array(zeros)), self.bodies, name_prefix="b")
        module, function = t["system"].split(":")
        system = getattr(importlib.import_module(module), function)(
            self.config["dt_s"], **t.get("system_args", {}))
        self.exec = world.build(system, simulation_rate=1.0 / self.config["dt_s"],
                                telemetry_rate=t["telemetry_rate_hz"], device=device)
        self.exec.record_history = t["record_history"]
        if self.exec.ticks_per_telemetry != t["telemetry_stride_ticks"]:
            raise ValueError(f"the Exec strides {self.exec.ticks_per_telemetry} ticks, the cell "
                             f"states {t['telemetry_stride_ticks']}")
        self.start_gap = max(
            float(np.max(np.abs(np.asarray(self.exec.column_array(c), np.float64) - v)))
            for c, v in self.start.items())

    def call(self, i: int):
        self.exec.run(self.ticks_per_call)
        self.ticks += self.ticks_per_call

    def warm_up(self) -> list:
        """Two calls; the first, from the harness's columns, is judged."""
        start = {c: torch.from_numpy(self.start[c]).to(self.inertia.device) for c in STATE}
        self.call(-2)
        first = self.keep(-2, start, None)
        self.call(-1)
        return [first]

    def before(self, i: int):
        return {c: self.exec.cols[c].clone() for c in STATE}

    def keep(self, i: int, before, out):
        return before, {c: self.exec.cols[c].clone() for c in STATE}

    def release(self) -> None:
        """The state after the last call is kept for ``late_gap``."""
        self.last = {c: self.exec.cols[c].clone() for c in STATE}
        del self.exec

    def _reference(self, pos, vel, ticks: int, dtype) -> dict:
        return dict(zip(STATE, self.ref.rollout(pos, vel, self.inertia, ticks, self.config,
                                                dtype=dtype)))

    def judge(self, kept: list, control: bool = False) -> tuple[dict, dict]:
        """({"start_gap", "state_gap", "late_gap"}, {group: worst gap}):
        the start against the harness's columns; each kept call against the
        reference's ticks from its state before; the last call's state
        against the reference's ticks from the harness's columns (its
        groups named ``late.<group>``).  With ``control`` the reference
        computed one precision lower is judged in the program's place."""
        full, low = getattr(torch, self.dtype), gaps.LOWER[self.dtype]
        by_group = {}
        for before, after in kept:
            pos, vel = before["world_pos"], before["world_vel"]
            ref = self._reference(pos, vel, self.ticks_per_call, full)
            if control:
                after = self._reference(pos, vel, self.ticks_per_call, low)
            for group, gap in gaps.change_gaps(before, after, ref).items():
                by_group[group] = gaps.worst([by_group.get(group, 0.0), gap])
        numbers = {"start_gap": self.start_gap, "state_gap": gaps.worst(by_group.values())}
        start = {c: torch.from_numpy(self.start[c]).to(self.inertia.device) for c in STATE}
        pos, vel = start["world_pos"], start["world_vel"]
        ref = self._reference(pos, vel, self.ticks, full)
        last = self._reference(pos, vel, self.ticks, low) if control else self.last
        late = gaps.change_gaps(start, last, ref)
        numbers["late_gap"] = gaps.worst(late.values())
        by_group.update({f"late.{g}": v for g, v in late.items()})
        return numbers, by_group
