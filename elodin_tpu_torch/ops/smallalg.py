"""Small SPD solves in plain arithmetic ops (counterpart of
``elodin_tpu/ops/smallalg.py::psd_solve``).

The Cholesky factor and both triangular solves are unrolled over the
matrix's static size into elementwise ops on its entries, in the JAX
package's order, so a solve issues no library call that checks its
factorization on the host (``torch.linalg.cholesky`` would) and runs as
is under ``torch.func.vmap``.  A pivot below the dtype's smallest normal
number is floored there, as in the JAX package.  Leading batch axes work
throughout.  The rest of the JAX module (LU, determinants, ``inv_3x3``)
and the ``jitter`` option are not ported.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _cholesky_entries(a: Tensor) -> list[list[Tensor]]:
    """The lower Cholesky factor of SPD ``a`` (..., n, n) as rows of
    (...)-shaped entries (None above the diagonal)."""
    n = a.shape[-1]
    tiny = torch.finfo(a.dtype).tiny
    low = [[None] * n for _ in range(n)]
    for j in range(n):
        d = a[..., j, j]
        if j:
            d = d - _dot(low[j], low[j], j)
        d = torch.sqrt(torch.clamp(d, min=tiny))
        low[j][j] = d
        for i in range(j + 1, n):
            num = a[..., i, j]
            if j:
                num = num - _dot(low[i], low[j], j)
            low[i][j] = num / d
    return low


def _dot(x: list, y: list, k: int) -> Tensor:
    """sum_{m < k} x[m] y[m], left to right."""
    acc = x[0] * y[0]
    for m in range(1, k):
        acc = acc + x[m] * y[m]
    return acc


def psd_solve(a: Tensor, b: Tensor) -> Tensor:
    """Solve a x = b for SPD ``a`` (..., n, n) and ``b`` (..., n, m)."""
    low = _cholesky_entries(a)
    n = a.shape[-1]
    # forward: l y = b
    ys = []
    for i in range(n):
        acc = b[..., i, :]
        for j in range(i):
            acc = acc - low[i][j][..., None] * ys[j]
        ys.append(acc / low[i][i][..., None])
    # back: l^T x = y
    xs = [None] * n
    for i in reversed(range(n)):
        acc = ys[i]
        for j in range(i + 1, n):
            acc = acc - low[j][i][..., None] * xs[j]
        xs[i] = acc / low[i][i][..., None]
    return torch.stack(xs, dim=-2)
