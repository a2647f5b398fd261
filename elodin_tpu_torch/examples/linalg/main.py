"""Linear-algebra op-coverage sim in torch (counterpart of
``examples/linalg/main.py``): Cholesky, QR, singular values, symmetric
eigenvalues and ``el.linalg.{inv,solve,det}`` of a slowly rotating 4 x 4
f64 SPD matrix, every tick.

``torch.linalg.cholesky_ex`` stands for ``la.cholesky``: it does not
check the factorization on the host, so a tick on the card does not wait
on it.  ``svdvals`` and ``eigvalsh`` have no such form.  QR is LAPACK's
Householder QR on the CPU; the card's signs are held to the CPU's by the
CSV gate and ``verify_trajectory``.  (This module defines ``@el.map``
functions, so it must not use postponed annotations.)
"""

import math
import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

from .._consts import const

SIM_TIME_STEP = 1.0 / 120.0

T = torch.Tensor


def _f64(shape=()):
    return el.ComponentType(el.PrimitiveType.F64, shape)


MatA = ty.Annotated[T, el.Component("mat_a", _f64((4, 4)))]
CholOut = ty.Annotated[T, el.Component("chol_out", _f64((4, 4)))]
QrQ = ty.Annotated[T, el.Component("qr_q", _f64((4, 4)))]
SvdS = ty.Annotated[T, el.Component("svd_s", _f64((4,)))]
InvOut = ty.Annotated[T, el.Component("inv_out", _f64((4, 4)))]
SolveOut = ty.Annotated[T, el.Component("solve_out", _f64((4,)))]
EigVals = ty.Annotated[T, el.Component("eig_vals", _f64((4,)))]
Det = ty.Annotated[T, el.Component("det", el.ComponentType.F64)]


def _spd_seed() -> np.ndarray:
    a = np.arange(16.0).reshape(4, 4) / 7.0 + np.eye(4) * 2.0
    return a @ a.T + np.eye(4)


def _rotation() -> np.ndarray:
    c, s = math.cos(0.01), math.sin(0.01)
    r = np.eye(4)
    r[0, 0], r[0, 1], r[1, 0], r[1, 1] = c, -s, s, c
    return r


_R = _rotation()
_R_T = np.ascontiguousarray(_R.T)
_B = np.arange(4.0) + 1.0


@el.dataclass
class Linalg(el.Archetype):
    mat_a: MatA = field(default_factory=_spd_seed)
    chol_out: CholOut = field(default_factory=lambda: np.zeros((4, 4)))
    qr_q: QrQ = field(default_factory=lambda: np.zeros((4, 4)))
    svd_s: SvdS = field(default_factory=lambda: np.zeros(4))
    inv_out: InvOut = field(default_factory=lambda: np.zeros((4, 4)))
    solve_out: SolveOut = field(default_factory=lambda: np.zeros(4))
    eig_vals: EigVals = field(default_factory=lambda: np.zeros(4))
    det: Det = field(default_factory=lambda: np.float64(0.0))


@el.map
def rotate_matrix(a: MatA) -> MatA:
    """Rotate the test matrix a little each tick: fresh values, still SPD."""
    return const(_R, a) @ a @ const(_R_T, a)


@el.map
def decompose(a: MatA) -> tuple[CholOut, QrQ, SvdS, InvOut, SolveOut, EigVals, Det]:
    chol = torch.linalg.cholesky_ex(a)[0]
    q, _r = torch.linalg.qr(a)
    s = torch.linalg.svdvals(a)
    inv = el.linalg.inv(a)
    x = el.linalg.solve(a, const(_B, a))
    w = torch.linalg.eigvalsh(a)
    d = el.linalg.det(a)
    return chol, q, s, inv, x, w, d


def build_world() -> el.World:
    w = el.World()
    w.spawn(Linalg(), name="linalg")
    return w


def build_system() -> el.System:
    return rotate_matrix | decompose


if __name__ == "__main__":
    w = build_world()
    w.run(build_system(), simulation_rate=1.0 / SIM_TIME_STEP, max_ticks=1200)
