"""Cold-gas RCS: interstage thruster geometry, wrench and torque allocation
in torch (counterpart of ``examples/falcon9/rcs.py``).  Eight nitrogen
thrusters in two pods on the +/-Y sides of the interstage; pure-torque
pairs exist for every axis, so the allocator is a per-axis table lookup.
The pair tables are derived with numpy at import."""

from __future__ import annotations

import numpy as np
import torch

from .._consts import const, f64
from .constants import RCS_STATION_M, RCS_THRUST_PER_THRUSTER_N, STAGE1_RADIUS_M

N_RCS = 8

# Geometry: (pod side sign, exhaust-opposite force direction).
_SIDE = np.array([+1, +1, -1, -1, +1, +1, -1, -1], dtype=float)
_FORCE = np.array(
    [
        [0.0, 0.0, +1.0],
        [0.0, 0.0, -1.0],
        [0.0, 0.0, +1.0],
        [0.0, 0.0, -1.0],
        [0.0, +1.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, +1.0, 0.0],
    ]
)
_POS = np.column_stack(
    [np.full(N_RCS, RCS_STATION_M), _SIDE * STAGE1_RADIUS_M, np.zeros(N_RCS)]
)
_X_HAT = np.array([1.0, 0.0, 0.0])

# Thruster pairs per torque axis whose off-axis wrench components cancel.
_AXIS_PAIRS = {
    0: ((0, 3), (1, 2)),  # roll: same-side Z pairs
    1: ((1, 3), (0, 2)),  # pitch: cross-pod Z pairs
    2: ((4, 7), (5, 6)),  # yaw: Y pairs
}


def rcs_wrench(levels, cg_station_m, thrust_n=RCS_THRUST_PER_THRUSTER_N):
    """Summed body-frame (force, torque) for thruster levels in [0, 1]."""
    levels = f64(levels)
    f_each = (thrust_n * levels)[:, None] * const(_FORCE, levels)
    arm = const(_POS, levels) - const(_X_HAT, levels) * cg_station_m
    return f_each.sum(0), torch.linalg.cross(arm, f_each, dim=-1).sum(0)


def effectiveness_matrix(cg_station_m, thrust_n=RCS_THRUST_PER_THRUSTER_N):
    """B (6 x N): [force; torque] per unit level, all thrusters at once."""
    cg = f64(cg_station_m)
    f_each = thrust_n * const(_FORCE, cg)
    arm = const(_POS, cg) - const(_X_HAT, cg) * cg
    t_each = torch.linalg.cross(arm, f_each, dim=-1)
    return torch.cat([f_each.T, t_each.T], dim=0)


def _pair_tables(cg_station_m: float):
    """(masks (3,2,N), signed authorities (3,2)) for the torque-pair groups.
    Group order along dim 1: [positive-torque group, negative-torque group]."""
    b = effectiveness_matrix(float(cg_station_m)).numpy()[3:6]
    masks = np.zeros((3, 2, N_RCS))
    auth = np.zeros((3, 2))
    for axis, groups in _AXIS_PAIRS.items():
        for g in groups:
            torque = b[axis, g[0]] + b[axis, g[1]]
            slot = 0 if torque > 0 else 1
            masks[axis, slot, list(g)] = 1.0
            auth[axis, slot] = abs(torque)
    return masks, auth


# The group structure is derived once at a nominal CG; allocate_torque
# rescales the authority at the actual CG.
_MASKS, _ = _pair_tables(20.0)
MIN_IMPULSE_FRAC = 0.02


def allocate_torque(torque_cmd_body, cg_station_m, thrust_n=RCS_THRUST_PER_THRUSTER_N):
    """Desired body torque -> thruster levels in [0, 1].  Per axis: the pair
    group whose torque sign matches the command, level = |tau| / group
    authority (clipped), and demands under the minimum-impulse floor (2 %
    of authority) dropped.  Runs under ``torch.func.vmap``."""
    cmd = f64(torque_cmd_body)
    b_t = effectiveness_matrix(cg_station_m, thrust_n)[3:6]  # (3, N)
    # the 0/1 masks at the CG's dtype (f32 under the mixed policy)
    masks = const(_MASKS, b_t)
    group_auth = masks @ b_t.T  # (3, 2, 3): torque of each group per axis
    axis_auth = torch.stack([group_auth[a, :, a] for a in range(3)])  # (3, 2)
    pick_pos = cmd >= 0.0
    auth = torch.where(pick_pos, torch.abs(axis_auth[:, 0]), torch.abs(axis_auth[:, 1]))
    level = torch.clamp(torch.abs(cmd) / torch.clamp(auth, min=1e-9), 0.0, 1.0)
    level = torch.where(torch.abs(cmd) > MIN_IMPULSE_FRAC * auth, level, 0.0)
    chosen = torch.where(pick_pos[:, None], masks[:, 0, :], masks[:, 1, :])  # (3, N)
    return torch.clamp(torch.sum(level[:, None] * chosen, dim=0), 0.0, 1.0)
