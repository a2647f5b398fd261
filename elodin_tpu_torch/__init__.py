"""elodin_tpu_torch: the PyTorch and CUDA port of ``elodin_tpu``.

The same ``World`` / ``Body`` / ``@system`` / ``Query`` / ``GraphQuery`` /
``every`` / ``six_dof`` / ``Exec`` / ``StepContext`` /
``monte_carlo.BatchedCampaign`` surface, with component columns held as
torch tensors on one device.  ``World.run`` makes every sim a CLI
(``cli.py``: ``run``, ``bench``, ``components``, ``params``, ``plan``);
``python -m elodin_tpu_torch`` runs a sim file or module, or a
process-per-sample Monte Carlo campaign (``monte_carlo.run_campaign``;
``monte_carlo.calibrate`` narrows its ranges).  ``lockstep.UdpLockstep``
closes the loop with an external flight-software process over UDP;
``tick_metrics`` times the run loop's phases.  ``rollout`` (``diff.py``)
makes a world and a system a differentiable function of its columns, and
``World.to_torch`` (alias ``to_jax``) a functional ``TorchSim`` handle.
The batched 6-dof RK4 rollout (``ops.sixdof_kernel``) and all-pairs
gravity (``ops.pairwise``) have hand-written CUDA kernels.
``elodin_tpu_torch.parallel`` (imported on its own, as the JAX package's
``elodin_tpu.parallel`` is) cuts the sample axis, and the kernels' rows,
over a mesh of devices: ``make_mesh``, ``sharded_step``,
``BatchedCampaign(mesh=)``, ``sixdof_rollout_sharded``,
``pairwise_gravity_sharded`` and ``parallel.dryrun.dryrun_multichip``.
``el.s10`` supervises a sim and its co-processes (recipes, restart
policies, readiness and liveness probes).  The package imports torch and numpy, never JAX.
"""

from __future__ import annotations

from dataclasses import dataclass  # noqa: F401  (el.dataclass)
from typing import Annotated  # noqa: F401  (el.Annotated)

import numpy as np
import torch

from . import interop
from ._config import set_float_policy  # noqa: F401
from .component import (  # noqa: F401
    Component,
    ComponentId,
    ComponentType,
    PrimitiveType,
    ShapeIndexer,
)
from .entity import Archetype, C, Edge, EntityId, RevEdge, TotalEdge  # noqa: F401
from .execimpl import Exec
from .six_dof import Integrator, six_dof  # noqa: F401
from .spatial import (  # noqa: F401
    MRP,
    Quaternion,
    SpatialForce,
    SpatialInertia,
    SpatialMotion,
    SpatialTransform,
)
from .step_context import StepContext  # noqa: F401
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
from .torchsim import TorchSim
from .diff import rollout  # noqa: F401

JaxSim = TorchSim  # the JAX package's name, for sources written against it

__version__ = "0.1.0"


def skew(arr):
    """Skew-symmetric (cross-product) matrix of a 3-vector; batched."""
    from . import spatial as _spatial

    # numpy's dtype rules are jnp.asarray's under x64: a float list is f64
    return _spatial.skew(arr if isinstance(arr, torch.Tensor)
                         else torch.as_tensor(np.asarray(arr)))


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
Camera = Annotated[
    torch.Tensor, Component("camera", ComponentType(PrimitiveType.U64, (1,)))
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
        ``db_path`` is the telemetry database's directory (``Exec``)."""
        self.set_sim_time_step(1.0 / simulation_rate)
        meta, cols = self.snapshot()
        exec_ = Exec(
            meta,
            cols,
            system,
            sim_time_step=1.0 / simulation_rate,
            max_ticks=max_ticks,
            telemetry_rate=telemetry_rate,
            db_path=db_path,
            device=device,
        )
        exec_.schematic_content = self.schematic_content
        return exec_

    def run(
        self,
        system,
        simulation_rate: float = 120.0,
        generate_real_time: bool = False,
        telemetry_rate: float | None = None,
        default_playback_speed: float = 1.0,
        max_ticks: int | None = None,
        optimize: bool = False,
        is_canceled=None,
        pre_step=None,
        post_step=None,
        db_path: str | None = None,
        interactive: bool = True,
        start_timestamp: int | None = None,
        log_level: str | None = None,
        backend: str = "tpu",
        device: str | torch.device = "cuda",
    ):
        """The sim as a CLI (``cli.run_cli``): ``sys.argv`` picks ``run``,
        ``bench``, ``components``, ``params`` or ``plan``.  The parameters
        before ``device`` are the JAX package's, in its order;
        ``default_playback_speed``, ``optimize``, ``interactive``,
        ``start_timestamp`` and ``log_level`` are accepted and ignored, as
        there.  ``device`` is where ``run`` and ``bench`` step unless the
        command line names one (``--device``)."""
        from .cli import run_cli

        return run_cli(
            self,
            system,
            simulation_rate=simulation_rate,
            generate_real_time=generate_real_time,
            telemetry_rate=telemetry_rate,
            max_ticks=max_ticks,
            is_canceled=is_canceled,
            pre_step=pre_step,
            post_step=post_step,
            db_path=db_path,
            backend=backend,
            device=device,
        )

    def to_torch(
        self,
        system,
        simulation_rate: float = 120.0,
        default_playback_speed: float = 1.0,
        max_ticks: int | None = None,
        device: str | torch.device = "cuda",
    ) -> TorchSim:
        """A ``TorchSim`` of ``system`` over this world's columns on
        ``device``: the step as a function of a dict of columns.  The
        parameters before ``device`` are the JAX package's ``to_jax``, in
        its order; ``default_playback_speed`` and ``max_ticks`` are
        accepted and ignored, as there."""
        from .system import SystemBuilder as _SB
        from .system import as_system

        self.set_sim_time_step(1.0 / simulation_rate)
        meta, cols = self.snapshot()
        sys_obj = as_system(system)

        def step_fn(state: dict) -> dict:
            b = _SB(meta, dict(state))
            sys_obj.call(b)
            return b.cols

        entity_dict = {m.name: eid for eid, m in meta.entity_metadata.items()}
        component_entity_dict = {n: list(ids) for n, ids in meta.comp_entities.items()}
        return TorchSim(step_fn, interop.columns_from_numpy(cols, meta, device),
                        entity_dict, component_entity_dict)

    # the JAX package's name, so that sources written against it run as is
    to_jax = to_torch


from . import linalg as linalg  # noqa: E402,F401
from . import monte_carlo as monte_carlo  # noqa: E402,F401
from . import s10 as s10  # noqa: E402,F401
