"""elodin_tpu_torch: the PyTorch and CUDA port of ``elodin_tpu``.

The same ``World`` / ``Body`` / ``@system`` / ``Query`` / ``GraphQuery`` /
``every`` / ``six_dof`` / ``Exec`` / ``monte_carlo.BatchedCampaign``
surface, with component columns held as torch tensors on one device.  The batched 6-dof RK4 rollout
(``ops.sixdof_kernel``) and all-pairs gravity (``ops.pairwise``) have
hand-written CUDA kernels.  The package imports torch and numpy, never
JAX.
"""

from __future__ import annotations

from dataclasses import dataclass  # noqa: F401  (el.dataclass)
from typing import Annotated  # noqa: F401  (el.Annotated)

import torch

from ._config import set_float_policy  # noqa: F401
from .component import (  # noqa: F401
    Component,
    ComponentId,
    ComponentType,
    PrimitiveType,
)
from .entity import Archetype, C, Edge, EntityId, RevEdge, TotalEdge  # noqa: F401
from .execimpl import Exec
from .six_dof import Integrator, six_dof  # noqa: F401
from .spatial import (  # noqa: F401
    Quaternion,
    SpatialForce,
    SpatialInertia,
    SpatialMotion,
    SpatialTransform,
)
from .system import (  # noqa: F401
    FnSystem,
    GraphQuery,
    LambdaSystem,
    Pipe,
    Query,
    RateGroup,
    System,
    SystemBuilder,
    every,
    map,
    map_seq,
    system,
)
from .world import DEFAULT_TIME_STEP, WorldBuilder  # noqa: F401

__version__ = "0.1.0"

# ---------------------------------------------------------------------------
# Built-in component aliases
# ---------------------------------------------------------------------------

WorldPos = Annotated[
    SpatialTransform,
    Component(
        "world_pos",
        ComponentType.SpatialPosF64,
        metadata={"element_names": "q0,q1,q2,q3,x,y,z", "priority": 5},
    ),
]
WorldVel = Annotated[
    SpatialMotion,
    Component(
        "world_vel",
        ComponentType.SpatialMotionF64,
        metadata={"element_names": "ωx,ωy,ωz,x,y,z", "priority": 5},
    ),
]
WorldAccel = Annotated[
    SpatialMotion,
    Component(
        "world_accel",
        ComponentType.SpatialMotionF64,
        metadata={"element_names": "αx,αy,αz,x,y,z", "priority": 5},
    ),
]
Force = Annotated[
    SpatialForce,
    Component(
        "force",
        ComponentType.SpatialMotionF64,
        metadata={"element_names": "τx,τy,τz,x,y,z", "priority": 5},
    ),
]
Inertia = Annotated[
    SpatialInertia,
    Component("inertia", ComponentType.SpatialPosF64, metadata={"priority": 5}),
]
# the globals: ``tick`` is u64 in the world and int64 on the device
Seed = Annotated[
    torch.Tensor, Component("seed", ComponentType.U64, metadata={"priority": 5})
]
SimulationTick = Annotated[
    torch.Tensor, Component("tick", ComponentType.U64, metadata={"priority": 7})
]
SimulationTimeStep = Annotated[
    torch.Tensor,
    Component("simulation_time_step", ComponentType.F64, metadata={"priority": 8}),
]


@dataclass
class Body(Archetype):
    """Standard rigid body bundle."""

    world_pos: WorldPos = None
    world_vel: WorldVel = None
    inertia: Inertia = None
    force: Force = None
    world_accel: WorldAccel = None

    def __post_init__(self):
        if self.world_pos is None:
            self.world_pos = SpatialTransform()
        if self.world_vel is None:
            self.world_vel = SpatialMotion()
        if self.inertia is None:
            self.inertia = SpatialInertia(mass=1.0)
        if self.force is None:
            self.force = SpatialForce()
        if self.world_accel is None:
            self.world_accel = SpatialMotion()


class World(WorldBuilder):
    """User-facing world."""

    def build(
        self,
        system,
        simulation_rate: float = 120.0,
        generate_real_time: bool = False,
        telemetry_rate: float | None = None,
        default_playback_speed: float = 1.0,
        max_ticks: int | None = None,
        optimize: bool = False,
        db_path: str | None = None,
        backend: str | None = None,
        device: str | torch.device = "cuda",
    ) -> Exec:
        """An ``Exec`` of ``system`` over this world's columns, moved to
        ``device``.  The parameters before it are the JAX package's, in its
        order; ``generate_real_time``, ``default_playback_speed``,
        ``optimize`` and ``backend`` are accepted and ignored, as there.
        ``db_path`` needs the telemetry database, which is not ported."""
        if db_path is not None:
            raise NotImplementedError("World.build(db_path=...): the telemetry "
                                      "database is not ported")
        self.set_sim_time_step(1.0 / simulation_rate)
        meta, cols = self.snapshot()
        return Exec(
            meta,
            cols,
            system,
            sim_time_step=1.0 / simulation_rate,
            max_ticks=max_ticks,
            telemetry_rate=telemetry_rate,
            device=device,
        )


from . import linalg as linalg  # noqa: E402,F401
from . import monte_carlo as monte_carlo  # noqa: E402,F401
