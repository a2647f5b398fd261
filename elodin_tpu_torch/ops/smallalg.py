"""Small-matrix linear algebra in plain arithmetic ops (counterpart of
``elodin_tpu/ops/smallalg.py``: ``psd_solve`` and the partial-pivot LU,
``lu_factor`` / ``lu_solve`` / ``lu_det``).

The Cholesky factor, the LU and the triangular solves are unrolled over the
matrix's static size into elementwise ops, gathers and selects, in the JAX
package's order, so a solve issues no library call that checks its
factorization on the host (``torch.linalg.cholesky`` would) and runs as
is under ``torch.func.vmap``.  A Cholesky pivot below the dtype's smallest
normal number is floored there, as in the JAX package.  Leading batch axes
work throughout.  ``inv_3x3``, ``psd_inv``, the upper Cholesky factor and
the ``jitter`` option are not ported.
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


def solve_tri_lower(low: Tensor, b: Tensor) -> Tensor:
    """Solve low x = b with lower-triangular ``low``; b is (..., n, m)."""
    n = low.shape[-1]
    rows = []
    for i in range(n):
        acc = b[..., i, :]
        for j in range(i):
            acc = acc - low[..., i, j, None] * rows[j]
        rows.append(acc / low[..., i, i, None])
    return torch.stack(rows, dim=-2)


def solve_tri_upper(up: Tensor, b: Tensor) -> Tensor:
    """Solve up x = b with upper-triangular ``up``; b is (..., n, m)."""
    n = up.shape[-1]
    rows = [None] * n
    for i in reversed(range(n)):
        acc = b[..., i, :]
        for j in range(i + 1, n):
            acc = acc - up[..., i, j, None] * rows[j]
        rows[i] = acc / up[..., i, i, None]
    return torch.stack(rows, dim=-2)


def lu_factor(a: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Partial-pivot LU of a general (..., n, n) matrix.  Returns ``(lu,
    perm, sign)``: ``lu`` packs unit-lower L below the diagonal and U on
    and above it (LAPACK's convention), ``perm`` the row permutation
    applied to the input (``a[perm] = L @ U``, (..., n), int64) and
    ``sign`` its parity (+1 or -1 in a's dtype).  The pivot is the first
    largest |entry| of the column; a zero pivot leaves its column of L
    finite, so a singular matrix has a determinant of 0."""
    n = a.shape[-1]
    batch = a.shape[:-2]
    rows = torch.arange(n, device=a.device)
    sign = torch.ones(batch, dtype=a.dtype, device=a.device)
    perm = rows.expand(batch + (n,))
    for k in range(n):
        p = torch.argmax(a[..., k:, k].abs(), dim=-1) + k
        row_k = a[..., k, :]
        row_p = torch.take_along_dim(a, p[..., None, None].expand(batch + (1, n)), dim=-2)[..., 0, :]
        # swap rows k and p: the old row k goes to p first, so p == k is a
        # no-op
        is_p = rows == p[..., None]
        is_k = rows == k
        a = torch.where(is_p[..., None], row_k[..., None, :], a)
        a = torch.where(is_k[:, None], row_p[..., None, :], a)
        perm_k = perm[..., k]
        perm_p = torch.take_along_dim(perm, p[..., None], dim=-1)[..., 0]
        perm = torch.where(is_p, perm_k[..., None], perm)
        perm = torch.where(is_k, perm_p[..., None], perm)
        sign = sign * torch.where(p == k, 1.0, -1.0).to(a.dtype)
        if k + 1 < n:
            pivot = a[..., k, k, None]
            safe = torch.where(pivot == 0, torch.ones_like(pivot), pivot)
            factors = a[..., k + 1:, k] / safe
            below = a[..., k + 1:, :]
            trailing = below[..., k + 1:] + (-factors[..., None] * a[..., k, None, k + 1:])
            below = torch.cat([below[..., :k], factors[..., None], trailing], dim=-1)
            a = torch.cat([a[..., :k + 1, :], below], dim=-2)
    return a, perm, sign


def lu_solve(lu: Tensor, perm: Tensor, b: Tensor) -> Tensor:
    """Solve ``a x = b`` from ``lu_factor(a)``; b is (..., n, m)."""
    n = lu.shape[-1]
    bp = torch.take_along_dim(b, perm[..., None].expand(b.shape[:-2] + (n, b.shape[-1])),
                              dim=-2)
    eye = torch.eye(n, dtype=lu.dtype, device=lu.device)
    return solve_tri_upper(torch.triu(lu), solve_tri_lower(torch.tril(lu, -1) + eye, bp))


def lu_det(lu: Tensor, sign: Tensor) -> Tensor:
    """The determinant from ``lu_factor``'s output."""
    return sign * torch.prod(torch.diagonal(lu, dim1=-2, dim2=-1), dim=-1)
