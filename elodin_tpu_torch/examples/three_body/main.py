"""Three-body gravity in torch (counterpart of
``examples/three-body/main.py``): three equal masses on a figure-eight-like
periodic orbit, gravity applied through an explicit-edge fold over six
``GravityConstraint`` edges, stepped by ``six_dof`` (RK4).

The JAX example builds its world at import and ends in ``w.run``; here
``build_world`` and ``build_system`` return them.  Its ``w.schematic``
layout belongs to the interactive stack, which is not ported.  (This
module defines ``@el.system`` functions, so it must not use postponed
annotations.)
"""

import torch

import elodin_tpu_torch as el

SIM_TIME_STEP = 1.0 / 120.0
G = 6.6743e-11

GravityEdge = el.Annotated[el.Edge, el.Component("gravity_edge", el.ComponentType.Edge)]


@el.dataclass
class GravityConstraint(el.Archetype):
    a: GravityEdge

    def __init__(self, a: el.EntityId, b: el.EntityId):
        self.a = GravityEdge(a, b)


@el.system
def gravity(
    graph: el.GraphQuery[GravityEdge],
    query: el.Query[el.WorldPos, el.Inertia],
) -> el.Query[el.Force]:
    def gravity_fn(force, a_pos, a_inertia, b_pos, b_inertia):
        r = a_pos.linear() - b_pos.linear()
        m = a_inertia.mass()
        M = b_inertia.mass()
        norm = torch.linalg.norm(r)
        f = G * M * m * r / (norm * norm * norm)
        return el.Force(linear=force.force() - f)

    return graph.edge_fold(
        left_query=query,
        right_query=query,
        return_type=el.Force,
        init_value=el.Force(),
        fold_fn=gravity_fn,
    )


def _body(pos, vel) -> el.Body:
    return el.Body(
        world_pos=el.WorldPos(linear=torch.tensor(pos, dtype=torch.float64)),
        world_vel=el.WorldVel(linear=torch.tensor(vel, dtype=torch.float64)),
        inertia=el.Inertia(1.0 / G),
    )


def build_world() -> el.World:
    """Bodies A, B and C and the six gravity edges between them."""
    w = el.World()
    a = w.spawn([_body([0.8920281421, 0.0, 0.0], [0.0, 0.9957939373, 0.0])], name="A")
    b = w.spawn([_body([-0.6628498947, 0.0, 0.0], [0.0, -1.6191613336, 0.0])], name="B")
    c = w.spawn([_body([-0.2291782474, 0.0, 0.0], [0.0, 0.6233673964, 0.0])], name="C")
    w.spawn(GravityConstraint(a, b), name="A -> B")
    w.spawn(GravityConstraint(b, a), name="B -> A")
    w.spawn(GravityConstraint(a, c), name="A -> C")
    w.spawn(GravityConstraint(b, c), name="B -> C")
    w.spawn(GravityConstraint(c, a), name="C -> A")
    w.spawn(GravityConstraint(c, b), name="C -> B")
    return w


def build_system() -> el.System:
    return el.six_dof(sys=gravity)
