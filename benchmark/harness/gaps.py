"""The number ``correct`` compares: how far a call's result lies from the
reference's, against how far the reference moved the state.

Each channel group of the state (a body's attitude, position, spin and
velocity) is judged on its own scale: max |ours - ref| / max |ref - start|
over the bodies.  Taken against the change the call made, not against the
state's size, so a fault in the forces shows even where the state is large
(an orbit's radius is ~1e3 times what it moves in a call).  A group the
reference leaves unchanged is judged by max |ours - ref| alone.  A NaN
anywhere reads NaN, which no limit passes.
"""

from __future__ import annotations

import math

import torch

# the precision the control computes in: the nearest below the
# configuration's, the step a later change would be tempted to take
LOWER = {"float64": torch.float32, "float32": torch.bfloat16}

# (column, group, channels) of the world_pos (N, 7) and world_vel (N, 6)
# columns: quaternion xyzw then position; angular then linear velocity
GROUPS = (("world_pos", "attitude", slice(0, 4)), ("world_pos", "position", slice(4, 7)),
          ("world_vel", "spin", slice(0, 3)), ("world_vel", "velocity", slice(3, 6)))


def change_gaps(start: dict, ours: dict, ref: dict) -> dict:
    """{group: gap} of one call's result ``ours`` against ``ref``, both
    reached from ``start`` (dicts of the (N, 7) and (N, 6) columns)."""
    out = {}
    for col, group, ch in GROUPS:
        o, r, s = (x[col][:, ch].to(torch.float64) for x in (ours, ref, start))
        diff = (o - r).abs().max().item()  # torch's max propagates NaN
        moved = (r - s).abs().max().item()
        out[group] = diff / moved if moved > 0.0 else diff
    return out


def worst(gaps) -> float:
    """The largest of several gaps (NaN if any is NaN)."""
    gaps = list(gaps)
    if any(math.isnan(g) for g in gaps):
        return math.nan
    return max(gaps)
