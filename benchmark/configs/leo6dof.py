"""The ``leo6dof`` configuration's initial draws and its plain reference.

Written from the model's equations (``models/sixdof_batch.py`` and
``six_dof``'s RK4), in plain PyTorch, importing nothing of the program:

* state: a body's world_pos (quaternion xyzw, position) and world_vel
  (angular, linear velocity);
* forces each stage: gravity -mu m r / |r|^3, thrust R(q) (T m, 0, 0),
  torque R(q) (0, 0, Q m), drag -D |v| v;
* accelerations: R ((R^T f) / I), the angular part by the diagonal
  inertia, the linear part by the mass;
* RK4 in six_dof's stage sequence: k1 at (normalize(q0), p0, vel0), each
  further stage at u0 (+) f dt k_prev, then u0 (+) dt (k1 + 2 k2 + 2 k3 +
  k4) / 6, where (+) moves the attitude by normalize(q + (h, 0) q) with h
  half the angular step and adds the rest.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.plain import run_ticks

GRAPH_TICKS = 50  # reference ticks a captured block on a card


def initial_columns(n: int, rng: np.random.Generator, config: dict):
    """(world_pos (N,7), world_vel (N,6), inertia (N,7)) numpy columns:
    ``batched_sixdof_init``'s draws, in its order, from ``rng``."""
    init = config["initial"]
    mu, r0 = config["mu_m3_s2"], config["earth_radius_m"]
    spread = init["altitude_spread_m"]
    alt = r0 + init["altitude_m"] + rng.uniform(-spread, spread, n)
    theta = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack([alt * np.cos(theta), alt * np.sin(theta),
                    rng.normal(0, init["out_of_plane_sigma_m"], n)], axis=-1)
    vmag = np.sqrt(mu / alt)
    vel = np.stack([-vmag * np.sin(theta), vmag * np.cos(theta), np.zeros(n)], axis=-1)
    quat = np.zeros((n, 4))
    quat[:, 3] = 1.0
    omega = rng.normal(0, init["spin_sigma_rad_s"], (n, 3))
    mass = rng.uniform(*init["mass_kg"], n)
    inertia = np.concatenate([mass[:, None] * np.array(init["inertia_per_kg"]),
                              np.zeros((n, 3)), mass[:, None]], axis=-1)
    return (np.concatenate([quat, pos], axis=-1), np.concatenate([omega, vel], axis=-1),
            inertia)


def _rotation(q):
    """(N, 3, 3) rotation of the quaternions q (N, 4), xyzw, of any norm."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz, ww = x * x, y * y, z * z, w * w
    xy, xz, xw, yz, yw, zw = x * y, x * z, x * w, y * z, y * w, z * w
    rows = torch.stack([ww + xx - yy - zz, 2 * (xy - zw), 2 * (xz + yw),
                        2 * (xy + zw), ww - xx + yy - zz, 2 * (yz - xw),
                        2 * (xz - yw), 2 * (yz + xw), ww - xx - yy + zz], dim=-1)
    return rows.view(-1, 3, 3) / (xx + yy + zz + ww)[:, None, None]


def _apply(r, v):
    return (r * v[:, None, :]).sum(-1)


def _apply_t(r, v):
    return (r * v[:, :, None]).sum(-2)


def _add_motion(pos, motion):
    """The attitude moved by the world-frame angular step motion[:, :3]
    (normalize(q + (h, 0) q), h half of it), the position by motion[:, 3:]."""
    q, h = pos[:, :4], 0.5 * motion[:, :3]
    qv, qw = q[:, :3], q[:, 3:]
    dq = torch.cat([qw * h + torch.linalg.cross(h, qv), -(h * qv).sum(-1, keepdim=True)], -1)
    q = q + dq
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.cat([q, pos[:, 4:] + motion[:, 3:]], -1)


def _accel(pos, vel, inertia, k: dict):
    """world_accel (N, 6) of the effectors and sixdof_accel."""
    r, v, m = pos[:, 4:], vel[:, 3:], inertia[:, 6:7]
    rot = _rotation(pos[:, :4])
    gravity = -k["mu"] * m * r / torch.linalg.vector_norm(r, dim=-1, keepdim=True) ** 3
    thrust = rot[:, :, 0] * (k["thrust"] * m)
    drag = -k["drag"] * torch.linalg.vector_norm(v, dim=-1, keepdim=True) * v
    torque = rot[:, :, 2] * (k["torque"] * m)
    force = gravity + thrust + drag
    angular = _apply(rot, _apply_t(rot, torque) / inertia[:, :3])
    linear = _apply(rot, _apply_t(rot, force) / m)
    return torch.cat([angular, linear], -1)


def _tick(dt: float, inertia, k: dict):
    def step(state):
        pos0, vel0 = state
        q0 = pos0[:, :4] / torch.linalg.vector_norm(pos0[:, :4], dim=-1, keepdim=True)
        pos = torch.cat([q0, pos0[:, 4:]], -1)
        ks = [(vel0, _accel(pos, vel0, inertia, k))]
        for f in (0.5 * dt, 0.5 * dt, dt):
            dv, da = ks[-1]
            pos, vel = _add_motion(pos0, f * dv), vel0 + f * da
            ks.append((vel, _accel(pos, vel, inertia, k)))
        dv = (ks[0][0] + 2 * ks[1][0] + 2 * ks[2][0] + ks[3][0]) * (1.0 / 6.0)
        da = (ks[0][1] + 2 * ks[1][1] + 2 * ks[2][1] + ks[3][1]) * (1.0 / 6.0)
        return _add_motion(pos0, dt * dv), vel0 + dt * da

    return step


def rollout(pos, vel, inertia, ticks: int, config: dict, dtype=torch.float64,
            graph_ticks: int = GRAPH_TICKS):
    """(world_pos, world_vel) after ``ticks`` RK4 ticks from the columns
    ``pos`` (N,7), ``vel`` (N,6), ``inertia`` (N,7), computed in ``dtype``
    on their device."""
    k = {"mu": config["mu_m3_s2"], "thrust": config["thrust_n_per_kg"],
         "torque": config["torque_nm_per_kg"], "drag": config["drag_n_s2_m2"]}
    pos, vel, inertia = (x.to(dtype) for x in (pos, vel, inertia))
    step = _tick(1.0 / config["rate_hz"], inertia, k)
    return run_ticks(step, (pos, vel), ticks, graph_ticks)
