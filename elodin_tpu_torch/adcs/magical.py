"""MAG.I.CAL magnetometer calibration (counterpart of
``elodin_tpu/adcs/magical.py``; doi:10.1109/JSEN.2019.2919179).

Iterative least-squares estimate of the soft-iron matrix T and hard-iron
offset h from raw readings.  The JAX package runs a fixed-length
``lax.scan`` with a done latch; here it is a Python loop of the same
length whose latch is a tensor and whose freezes are ``torch.where``
selects, so no iteration reads a value back to the host."""

from __future__ import annotations

import torch

from ..ops.smallalg import inv_3x3, psd_inv
from ..spatial import _as_f


def _calibration_step(y, m):
    """One least-squares refinement; y, m: (3, N) raw readings and the
    current unit-field estimates."""
    n = y.shape[1]
    ones = torch.ones((1, n), dtype=y.dtype, device=y.device)
    g = torch.cat([m, ones], dim=0)  # (4, N)
    ggt_inv = psd_inv(g @ g.T)
    l = (y @ g.T) @ ggt_inv  # (3, 4)
    return l[:, :3], l[:, 3]


def magical_calibrate(y, iterations: int = 32, tol: float = 1e-5):
    """Calibrate from N raw 3-vector readings (N, 3).

    Returns (m, t, h, converged): unit field directions (N, 3), soft-iron T
    (3, 3), hard-iron offset h (3,) and the convergence flag (a bool
    tensor).  ``tol`` bounds the absolute residual sum over all N readings,
    as in the JAX package (whose docstring says how to scale it to
    noise)."""
    y = _as_f(y)
    y_mat = y.T  # (3, N)
    m = (y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)).T
    best_t = torch.eye(3, dtype=y.dtype, device=y.device)
    best_h = torch.zeros(3, dtype=y.dtype, device=y.device)
    done = torch.zeros((), dtype=torch.bool, device=y.device)
    for _ in range(iterations):
        t, h = _calibration_step(y_mat, m)
        t_inv = inv_3x3(t)
        m_tilde = (t_inv @ (y_mat - h[:, None])).T  # (N, 3)
        j = torch.sum((torch.sum(m_tilde * m_tilde, dim=-1) - 1.0) ** 2)
        m_new = (m_tilde / torch.linalg.vector_norm(m_tilde, dim=-1, keepdim=True)).T
        # keep refining until the done latch sets, then freeze everything
        best_t = torch.where(~done, t, best_t)
        best_h = torch.where(~done, h, best_h)
        m = torch.where(done, m, m_new)
        done = done | (j < tol)
    return m.T, best_t, best_h, done
