"""N-body model: all-pairs gravity (counterpart of
``elodin_tpu/models/nbody.py``).

Two gravity formulations over the same world:

* ``use_kernel=True``: ``ops.pairwise.pairwise_gravity``, the CUDA kernel on
  the card (its plain PyTorch version on the CPU), once per tick;
* ``use_kernel=False``: ``GraphQuery[TotalEdge].edge_fold``, the
  reference-compatible ``@system`` API, run as a dense masked sum
  (``additive=True``, where the JAX package folds sequentially; see
  ``_gravity``).

Initial conditions are the JAX package's, from numpy with a seed: a
golden-angle spiral over a 2-3.5 AU annulus around a sun at the origin.
"""

import numpy as np
import torch

import elodin_tpu_torch as el
from elodin_tpu_torch.entity import TotalEdge
from elodin_tpu_torch.ops.pairwise import pairwise_gravity
from elodin_tpu_torch.system import GraphQuery, LambdaSystem, Query, system

G = 6.6743e-11
M_SUN = 1.989e30
AU = 1.496e11


def build_nbody(n_bodies: int, seed: int = 0, dtype=np.float64) -> el.World:
    rng = np.random.default_rng(seed)
    n_ast = n_bodies - 1
    k = np.arange(n_ast)
    r = (2.0 + 1.5 * (k + 0.5) / n_ast) * AU
    theta = k * (np.pi * (3.0 - np.sqrt(5.0)))  # golden angle
    pos = np.zeros((n_bodies, 3))
    pos[1:, 0] = r * np.cos(theta)
    pos[1:, 1] = r * np.sin(theta)
    vel = np.zeros((n_bodies, 3))
    v = np.sqrt(G * M_SUN / r)
    vel[1:, 0] = -v * np.sin(theta)
    vel[1:, 1] = v * np.cos(theta)
    mass = np.concatenate([[M_SUN], rng.uniform(1e15, 1e20, n_ast)])

    quat = np.zeros((n_bodies, 4))
    quat[:, 3] = 1.0
    inertia = np.concatenate(
        [np.tile(mass[:, None], (1, 3)), np.zeros((n_bodies, 3)),
         mass[:, None]],
        axis=-1,
    )
    w = el.World()
    body = el.Body(
        world_pos=el.SpatialTransform.from_array(
            np.concatenate([quat, pos], axis=-1).astype(dtype)),
        world_vel=el.SpatialMotion.from_array(
            np.concatenate([np.zeros((n_bodies, 3)), vel], axis=-1).astype(dtype)),
        inertia=el.SpatialInertia.from_array(inertia.astype(dtype)),
        force=el.SpatialForce.from_array(np.zeros((n_bodies, 6), dtype=dtype)),
        world_accel=el.SpatialMotion.from_array(np.zeros((n_bodies, 6), dtype=dtype)),
    )
    w.spawn_batch(body, n_bodies, name_prefix="b")
    return w


def _kernel_gravity(builder):
    ids = builder.entities_of("world_pos")
    pos = builder.gather("world_pos", ids)
    inertia = builder.gather("inertia", ids)
    force = builder.gather("force", ids)
    m = inertia[..., 6]
    acc = pairwise_gravity(pos[..., 4:], m, g=G)
    lin = force[..., 3:] + acc.to(pos.dtype) * m[:, None]
    builder.scatter("force", ids, torch.cat([force[..., :3], lin], dim=-1))


@system
def _gravity(
    graph: GraphQuery[TotalEdge],
    query: Query[el.WorldPos, el.Inertia],
) -> Query[el.Force]:
    def gravity_fn(force, a_pos, a_inertia, b_pos, b_inertia):
        # grouped as (G*m) * ((M/|r|^3) * r), as in the JAX package, where
        # the grouping keeps TPU-emulated f64 inside float32's exponent
        # range; in IEEE f64 either grouping works, this one rounds alike
        r = a_pos.linear() - b_pos.linear()
        norm = torch.linalg.norm(r)
        f = (G * a_inertia.mass()) * ((b_inertia.mass() / norm**3) * r)
        return el.Force(linear=force.force() - f)

    # gravity_fn drops the carry's torque, so the additive probe rejects it
    # (in the JAX package too, which therefore folds sequentially).  The
    # force it accumulates is additive and the initial torque is zero, so
    # the dense sum gives the sequential fold's values up to summation
    # order: assert it, and the fold runs as one dense sum on the card.
    return graph.edge_fold(query, query, el.Force, el.Force(), gravity_fn,
                           additive=True)


def build_system(time_step: float = 60.0, use_kernel: bool = True) -> el.System:
    if use_kernel:
        effector = LambdaSystem(_kernel_gravity, "pairwise_gravity_kernel")
    else:
        effector = _gravity
    return el.six_dof(time_step=time_step, sys=effector,
                      integrator=el.Integrator.SemiImplicit)
