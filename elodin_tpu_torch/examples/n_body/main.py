"""N-body gravity over a complete digraph (``TotalEdge``) in torch
(counterpart of ``examples/n-body/main.py``): every body attracts every
other body with no explicit edge spawning.  The fold drops the carry's
torque, so the additive probe rejects it and every tick folds
sequentially, as in the JAX package.  (This module defines ``@el.system``
functions, so it must not use postponed annotations.)

    python -m elodin_tpu_torch.examples.n_body.main bench --ticks 20 --device cpu
"""

import numpy as np
import torch

import elodin_tpu_torch as el

SIM_TIME_STEP = 60.0  # one-minute steps, solar-system scale
G = 6.6743e-11

AU = 1.496e11
M_SUN = 1.989e30
M_EARTH = 5.972e24
M_MOON = 7.342e22


def build_world(n_asteroids: int = 12, seed: int = 0) -> el.World:
    w = el.World()
    rng = np.random.default_rng(seed)

    w.spawn(
        el.Body(inertia=el.Inertia(M_SUN)),
        name="sun",
    )
    v_earth = np.sqrt(G * M_SUN / AU)
    w.spawn(
        el.Body(
            world_pos=el.WorldPos(linear=np.array([AU, 0.0, 0.0])),
            world_vel=el.WorldVel(linear=np.array([0.0, v_earth, 0.0])),
            inertia=el.Inertia(M_EARTH),
        ),
        name="earth",
    )
    for i in range(n_asteroids):
        r = rng.uniform(2.0, 3.5) * AU
        theta = rng.uniform(0, 2 * np.pi)
        v = np.sqrt(G * M_SUN / r)
        w.spawn(
            el.Body(
                world_pos=el.WorldPos(
                    linear=np.array([r * np.cos(theta), r * np.sin(theta), 0.0])
                ),
                world_vel=el.WorldVel(
                    linear=np.array([-v * np.sin(theta), v * np.cos(theta), 0.0])
                ),
                inertia=el.Inertia(rng.uniform(1e15, 1e20)),
            ),
            name=f"asteroid{i}",
        )
    return w


@el.system
def gravity(
    graph: el.GraphQuery[el.TotalEdge],
    query: el.Query[el.WorldPos, el.Inertia],
) -> el.Query[el.Force]:
    def gravity_fn(force, a_pos, a_inertia, b_pos, b_inertia):
        r = a_pos.linear() - b_pos.linear()
        norm = torch.linalg.norm(r)
        # grouped as (G*m_a) * ((m_b/|r|^3) * r), as in the JAX example
        f = (G * a_inertia.mass()) * ((b_inertia.mass() / norm**3) * r)
        return el.Force(linear=force.force() - f)

    return graph.edge_fold(query, query, el.Force, el.Force(), gravity_fn)


def build_system() -> el.System:
    return el.six_dof(sys=gravity, integrator=el.Integrator.SemiImplicit)


if __name__ == "__main__":
    w = build_world()
    w.run(build_system(), simulation_rate=1.0 / SIM_TIME_STEP, max_ticks=10_000)
