"""General linear algebra: ``solve``, ``inv``, ``det`` and the unrolled LU
(counterpart of ``elodin_tpu/linalg.py``).

``solve``, ``inv`` and ``det`` are ``torch.linalg``'s, in the forms that do
not check the factorization on the host (``solve_ex``, ``inv_ex``), so a
tick on the card does not wait on them.  ``lu_factor`` / ``lu_solve`` /
``lu_det`` are the unrolled partial-pivot LU of ``ops.smallalg``.  The
JAX module's dispatch (``_needs_fallback``) exists only for the TPU
compiler, which rejects an f64 LU, and is not ported.  Leading batch axes
work throughout.
"""

from __future__ import annotations

import torch

from .ops.smallalg import lu_det, lu_factor, lu_solve

__all__ = ["solve", "inv", "det", "lu_factor", "lu_solve", "lu_det"]

Tensor = torch.Tensor


def solve(a: Tensor, b: Tensor) -> Tensor:
    """Solve ``a x = b`` for general square ``a`` (..., n, n); ``b`` is one
    vector (n,), or matrices (..., n, m), as with ``jnp.linalg.solve``."""
    if b.ndim == 1:
        return torch.linalg.solve_ex(a, b[..., None])[0][..., 0]
    return torch.linalg.solve_ex(a, b)[0]


def inv(a: Tensor) -> Tensor:
    """Inverse of a general square matrix (..., n, n)."""
    return torch.linalg.inv_ex(a)[0]


def det(a: Tensor) -> Tensor:
    """Determinant of a general square matrix (..., n, n)."""
    return torch.linalg.det(a)
