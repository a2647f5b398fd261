"""Small-matrix linear algebra in plain arithmetic ops (counterpart of
``elodin_tpu/ops/smallalg.py``): the Cholesky factors
(``cholesky_lower`` / ``cholesky_upper``), ``psd_solve`` and ``psd_inv``
with the JAX package's ``jitter`` (added to the diagonal when nonzero),
the partial-pivot LU (``lu_factor`` / ``lu_solve`` / ``lu_det``) and the
closed-form ``inv_3x3``.

The Cholesky factor, the LU and the triangular solves are unrolled over the
matrix's static size into elementwise ops, gathers and selects, in the JAX
package's order, so a solve issues no library call that checks its
factorization on the host (``torch.linalg.cholesky`` would) and runs as
is under ``torch.func.vmap``.  A Cholesky pivot below the dtype's smallest
normal number is floored there, as in the JAX package.  Leading batch axes
work throughout.
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


def _jittered(a: Tensor, jitter: float) -> Tensor:
    """``a`` plus ``jitter`` on its diagonal; ``a`` itself at 0."""
    if not jitter:
        return a
    return a + jitter * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)


def cholesky_lower(a: Tensor, jitter: float = 0.0) -> Tensor:
    """Lower-triangular Cholesky factor of SPD ``a`` (..., n, n)."""
    low = _cholesky_entries(_jittered(a, jitter))
    zero = torch.zeros_like(a[..., 0, 0])
    return torch.stack([torch.stack([x if x is not None else zero for x in row], dim=-1)
                        for row in low], dim=-2)


def cholesky_upper(a: Tensor, jitter: float = 0.0) -> Tensor:
    """Upper factor U with a = U^T U (the Merwe sigma-point convention)."""
    return cholesky_lower(a, jitter).transpose(-1, -2)


def psd_solve(a: Tensor, b: Tensor, jitter: float = 0.0) -> Tensor:
    """Solve a x = b for SPD ``a`` (..., n, n) and ``b`` (..., n, m)."""
    low = _cholesky_entries(_jittered(a, jitter))
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


def psd_inv(a: Tensor, jitter: float = 0.0) -> Tensor:
    """Inverse of SPD ``a`` (..., n, n) by the unrolled Cholesky solve."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return psd_solve(a, eye.expand(a.shape), jitter)


def solve_tri_lower(l: Tensor, b: Tensor) -> Tensor:  # noqa: E741 (the JAX package's name)
    """Solve l x = b with lower-triangular ``l``; b is (..., n, m)."""
    n = l.shape[-1]
    rows = []
    for i in range(n):
        acc = b[..., i, :]
        for j in range(i):
            acc = acc - l[..., i, j, None] * rows[j]
        rows.append(acc / l[..., i, i, None])
    return torch.stack(rows, dim=-2)


def solve_tri_upper(u: Tensor, b: Tensor) -> Tensor:
    """Solve u x = b with upper-triangular ``u``; b is (..., n, m)."""
    n = u.shape[-1]
    rows = [None] * n
    for i in reversed(range(n)):
        acc = b[..., i, :]
        for j in range(i + 1, n):
            acc = acc - u[..., i, j, None] * rows[j]
        rows[i] = acc / u[..., i, i, None]
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


def inv_3x3(a: Tensor) -> Tensor:
    """Closed-form adjugate inverse of general (..., 3, 3) matrices."""
    m = [[a[..., i, j] for j in range(3)] for i in range(3)]
    c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1]
    c01 = m[1][2] * m[2][0] - m[1][0] * m[2][2]
    c02 = m[1][0] * m[2][1] - m[1][1] * m[2][0]
    det = m[0][0] * c00 + m[0][1] * c01 + m[0][2] * c02
    adj = [
        [c00, m[0][2] * m[2][1] - m[0][1] * m[2][2], m[0][1] * m[1][2] - m[0][2] * m[1][1]],
        [c01, m[0][0] * m[2][2] - m[0][2] * m[2][0], m[0][2] * m[1][0] - m[0][0] * m[1][2]],
        [c02, m[0][1] * m[2][0] - m[0][0] * m[2][1], m[0][0] * m[1][1] - m[0][1] * m[1][0]],
    ]
    return torch.stack([torch.stack(row, dim=-1) for row in adj], dim=-2) / det[..., None, None]
