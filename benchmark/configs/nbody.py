"""The ``nbody`` configuration's initial draws and its plain reference.

Written from the model's equations (``models/nbody.py`` and ``six_dof``'s
semi-implicit step), in plain PyTorch, importing nothing of the program:

* a_i = G sum_{j != i} m_j (x_j - x_i) / |x_j - x_i|^3 (eps 0), in blocks
  of rows so the (3, rows, N) intermediates fit;
* v' = v + dt a, x' = x + dt v'; the attitude moved by the (zero) spin as
  normalize(q + (h, 0) q), h = dt w' / 2.
"""

from __future__ import annotations

import numpy as np
import torch

ROWS = 1024  # rows of the (rows, N) intermediates at a time


def initial_columns(n: int, rng: np.random.Generator, config: dict):
    """(world_pos (N,7), world_vel (N,6), inertia (N,7)) numpy columns:
    ``build_nbody``'s layout and its mass draws, in its order, from
    ``rng``."""
    init, au = config["initial"], config["au_m"]
    lo, hi = init["belt_au"]
    n_ast = n - 1
    k = np.arange(n_ast)
    r = (lo + (hi - lo) * (k + 0.5) / n_ast) * au
    theta = k * (np.pi * (3.0 - np.sqrt(5.0)))
    pos = np.zeros((n, 3))
    pos[1:, 0] = r * np.cos(theta)
    pos[1:, 1] = r * np.sin(theta)
    vel = np.zeros((n, 3))
    v = np.sqrt(config["G"] * config["sun_mass_kg"] / r)
    vel[1:, 0] = -v * np.sin(theta)
    vel[1:, 1] = v * np.cos(theta)
    mass = np.concatenate([[config["sun_mass_kg"]], rng.uniform(*init["asteroid_mass_kg"], n_ast)])
    quat = np.zeros((n, 4))
    quat[:, 3] = 1.0
    inertia = np.concatenate([np.tile(mass[:, None], (1, 3)), np.zeros((n, 3)), mass[:, None]],
                             axis=-1)
    return (np.concatenate([quat, pos], axis=-1),
            np.concatenate([np.zeros((n, 3)), vel], axis=-1), inertia)


def gravity(x, m, g: float, eps: float):
    """(N, 3) accelerations of the bodies at ``x`` (N, 3) with masses ``m``
    (N,): each block's displacements d (3, rows, N), the weights
    m_j / |d|^3 with the self pair's set to 0, and the sums over j of the
    weighted displacements (elementwise ops and sums, no matrix product)."""
    n = x.shape[0]
    xt = x.T.contiguous()  # (3, N)
    out = torch.empty_like(x)
    for a in range(0, n, ROWS):
        b = min(a + ROWS, n)
        d = xt[:, None, :] - xt[:, a:b, None]  # (3, rows, N): i -> j
        s = (d * d).sum(0) + eps * eps
        w = m[None, :] / (s * s.sqrt())
        w[:, a:b].diagonal().zero_()  # the self pair: no force
        out[a:b] = g * (d * w).sum(-1).T
    return out


def rollout(pos, vel, inertia, ticks: int, config: dict, dtype=torch.float64):
    """(world_pos, world_vel) after ``ticks`` semi-implicit ticks from the
    columns ``pos`` (N,7), ``vel`` (N,6), ``inertia`` (N,7), computed in
    ``dtype`` on their device."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the reference computes in full float32 or float64")
    pos, vel, inertia = (x.to(dtype) for x in (pos, vel, inertia))
    dt, g, eps = config["dt_s"], config["G"], config["eps_m"]
    m = inertia[:, 6].contiguous()
    for _ in range(ticks):
        accel = gravity(pos[:, 4:].contiguous(), m, g, eps)
        vel = torch.cat([vel[:, :3], vel[:, 3:] + dt * accel], -1)
        q, h = pos[:, :4], 0.5 * dt * vel[:, :3]
        qv, qw = q[:, :3], q[:, 3:]
        q = q + torch.cat([qw * h + torch.linalg.cross(h, qv),
                           -(h * qv).sum(-1, keepdim=True)], -1)
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        pos = torch.cat([q, pos[:, 4:] + dt * vel[:, 3:]], -1)
    return pos, vel
