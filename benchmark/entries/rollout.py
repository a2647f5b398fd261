"""Entry driver ``rollout``: batched 6-dof rollouts through
``elodin_tpu_torch.ops.sixdof_kernel.sixdof_rollout`` (the wrapper's
packing, K1, its unpacking).

Set-up draws ``dispersions`` sets of initial columns from the seed, with the
configuration's copy of the model's draws, and puts them on the card.  Call
i rolls set ``i % dispersions`` out for ``ticks_per_call`` ticks: a new
campaign each call, never a continued one, so the state never runs away.
The program's result of a compared call is kept (a copy, taken outside the
call's timing) and judged after the window against the configuration's
plain reference from the same columns.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import gaps


class Driver:
    def __init__(self, cell, seed: int, device: str):
        from elodin_tpu_torch.ops import sixdof_kernel

        self._rollout = sixdof_kernel.sixdof_rollout
        t, self.config = cell.traffic, cell.config
        self.ref = cell.reference()
        self.device = torch.device(device)
        self.dtype = self.config["dtype"]
        self._dtype = getattr(torch, self.dtype)
        self.bodies, self.ticks_per_call = t["bodies"], t["ticks_per_call"]
        self.dt = 1.0 / self.config["rate_hz"]
        self.inputs = [
            tuple(torch.from_numpy(c).to(self.device, self._dtype)
                  for c in self.ref.initial_columns(self.bodies, np.random.default_rng(s),
                                                    self.config))
            for s in np.random.SeedSequence(seed).spawn(t["dispersions"])]

    def call(self, i: int):
        pos, vel, inertia = self.inputs[i % len(self.inputs)]
        return self._rollout(pos, vel, inertia, self.dt, self.ticks_per_call,
                             device=self.device, dtype=self._dtype)

    def warm_up(self) -> list:
        """One call from each set; nothing of them is judged."""
        for i in range(len(self.inputs)):
            self.call(i)
        return []

    def before(self, i: int):
        return None

    def keep(self, i: int, before, out):
        return i % len(self.inputs), tuple(x.clone() for x in out)

    def release(self) -> None:
        """The program holds no state between calls."""

    def judge(self, kept: list, control: bool = False) -> tuple[dict, dict]:
        """({"state_gap": worst gap}, {group: worst gap}) of the kept calls
        against the reference's rollouts of their sets, computed in one
        stacked rollout.  With ``control`` the reference computed one
        precision lower is judged in the program's place."""
        sets = sorted({k for k, _ in kept})
        stacked = [torch.cat([self.inputs[k][c] for k in sets]) for c in range(3)]
        ref = self.ref.rollout(*stacked, self.ticks_per_call, self.config, dtype=self._dtype)
        if control:
            low = self.ref.rollout(*stacked, self.ticks_per_call, self.config,
                                   dtype=gaps.LOWER[self.dtype])
        by_group = {}
        for k, out in kept:
            rows = slice(sets.index(k) * self.bodies, (sets.index(k) + 1) * self.bodies)
            pos, vel = (low[0][rows], low[1][rows]) if control else out
            found = gaps.change_gaps(
                {"world_pos": self.inputs[k][0], "world_vel": self.inputs[k][1]},
                {"world_pos": pos, "world_vel": vel},
                {"world_pos": ref[0][rows], "world_vel": ref[1][rows]})
            for group, gap in found.items():
                by_group[group] = gaps.worst([by_group.get(group, 0.0), gap])
        return {"state_gap": gaps.worst(by_group.values())}, by_group
