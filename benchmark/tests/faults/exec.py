"""Faults planted under the ``exec`` entry, in ``Exec.run``."""

import torch

STATE = ("world_pos", "world_vel")
# the number that sees a call left out between the compared ones
LEFT_OUT_SEEN_BY = "late_gap"


def broken(kind):
    """(owner, attribute, replacement): ``Exec.run`` leaving the state
    unchanged (``unchanged``), leaving half of the bodies out (``half``),
    or altering one answer (``altered``)."""
    from elodin_tpu_torch import execimpl

    real = execimpl.Exec.run

    def broken(self, ticks=1, **kw):
        if kind == "unchanged":  # the state left as it was
            return None
        before = dict(self.cols)
        real(self, ticks, **kw)
        if kind == "half":  # half of the bodies left out
            n = before["world_pos"].shape[0] // 2
            for c in STATE:
                self.cols[c] = torch.cat([self.cols[c][:n], before[c][n:]])
        else:  # one answer altered where it is produced
            vel = self.cols["world_vel"].clone()
            vel[1, 3] *= 1 + 1e-6
            self.cols["world_vel"] = vel

    return execimpl.Exec, "run", broken


def left_out():
    """(owner, attribute, replacement): the window's first call, never
    compared (the first point lies 5 % into the window), leaves the state
    as it was."""
    from elodin_tpu_torch import execimpl

    real, runs = execimpl.Exec.run, []

    def broken(self, ticks=1, **kw):
        runs.append(ticks)
        if len(runs) == 3:  # set-up's two calls, then the window's first
            return None
        return real(self, ticks, **kw)

    return execimpl.Exec, "run", broken
