"""Covariance ellipsoid comparison in torch (counterpart of
``examples/covariance-ellipsoids/main.py``): two entities publish the same
time-varying 3x3 covariance, one as a packed lower-triangular Cholesky
factor and one as the packed covariance itself, for the editor's
covariance-ellipsoid renderer to draw; they must overlay exactly.

Packing order for a symmetric/lower-triangular 3x3 is row-major lower:
[m00, m10, m11, m20, m21, m22].  (This module defines ``@el.system``
functions, so it must not use postponed annotations.)

    python -m elodin_tpu_torch.examples.covariance_ellipsoids.main bench --ticks 20 --device cpu
"""

import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

SIM_RATE = 60.0
SIM_TIME_STEP = 1.0 / SIM_RATE
CYCLE_SECONDS = 8.0

CholeskyFactor = ty.Annotated[
    torch.Tensor,
    el.Component("cholesky_factor", el.ComponentType(el.PrimitiveType.F64, (6,))),
]
ErrorCovariance = ty.Annotated[
    torch.Tensor,
    el.Component("error_covariance", el.ComponentType(el.PrimitiveType.F64, (6,))),
]


@el.dataclass
class CholeskyData(el.Archetype):
    cholesky_factor: CholeskyFactor = field(default_factory=lambda: np.zeros(6))


@el.dataclass
class CovarianceData(el.Archetype):
    error_covariance: ErrorCovariance = field(default_factory=lambda: np.zeros(6))


def cholesky_at(t):
    """Time-varying lower-triangular factor at time ``t`` (a 0-d tensor)."""
    phase = 2.0 * torch.pi * t / CYCLE_SECONDS
    zero = torch.zeros_like(phase)
    return torch.stack(
        [
            torch.stack([1.2 + 0.3 * torch.sin(phase), zero, zero]),
            torch.stack([0.4 * torch.sin(phase * 0.7), 0.8 + 0.2 * torch.cos(phase), zero]),
            torch.stack([
                -0.25 * torch.cos(phase * 0.8),
                0.3 * torch.sin(phase * 1.3),
                0.5 + 0.15 * torch.sin(phase + 0.5),
            ]),
        ]
    )


def pack_lower(m):
    return torch.stack([m[0, 0], m[1, 0], m[1, 1], m[2, 0], m[2, 1], m[2, 2]])


@el.system
def publish_cholesky(
    tick: el.Query[el.SimulationTick],
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[CholeskyFactor],
) -> el.Query[CholeskyFactor]:
    t = tick[0] * ts[0]
    return q.map(CholeskyFactor, lambda _c: pack_lower(cholesky_at(t)))


@el.system
def publish_covariance(
    tick: el.Query[el.SimulationTick],
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[ErrorCovariance],
) -> el.Query[ErrorCovariance]:
    t = tick[0] * ts[0]
    L = cholesky_at(t)
    return q.map(ErrorCovariance, lambda _c: pack_lower(L @ L.T))


def world() -> el.World:
    w = el.World()
    w.spawn(
        [
            el.Body(world_pos=el.SpatialTransform(linear=np.array([-2.0, 0.0, 0.0]))),
            CholeskyData(),
        ],
        name="cholesky",
    )
    w.spawn(
        [
            el.Body(world_pos=el.SpatialTransform(linear=np.array([2.0, 0.0, 0.0]))),
            CovarianceData(),
        ],
        name="covariance",
    )
    w.schematic(
        """
        viewport name=Viewport look_at="(0,0,0,0, 0,0,0)" show_grid=#true
        object_3d eql="cholesky.world_pos" {
            covariance_ellipsoid factor="cholesky.cholesky_factor" kind="cholesky"
        }
        object_3d eql="covariance.world_pos" {
            covariance_ellipsoid factor="covariance.error_covariance" kind="covariance"
        }
        """
    )
    return w


def system() -> el.System:
    return publish_cholesky | publish_covariance | el.six_dof(sys=())


if __name__ == "__main__":
    world().run(system(), simulation_rate=SIM_RATE)
