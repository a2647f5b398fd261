"""UKF-based attitude-independent magnetometer calibration (counterpart of
``elodin_tpu/adcs/magkal.py``; Crassidis, Lai and Harman, "Real-Time
Attitude-Independent Three-Axis Magnetometer Calibration").

State (9): hard-iron bias b (3) and the symmetric scale and
non-orthogonality D (6)."""

from __future__ import annotations

import torch

from ..spatial import _as_f
from .ukf import MerweConfig, UkfState


def _d_matrix(d6):
    d0, d1, d2, d3, d4, d5 = (d6[..., i] for i in range(6))
    return torch.stack(
        [
            torch.stack([d0, d1, d2], dim=-1),
            torch.stack([d1, d3, d4], dim=-1),
            torch.stack([d2, d4, d5], dim=-1),
        ],
        dim=-2,
    )


def measure(state, z):
    """The scalar measurement model."""
    b = state[..., :3]
    d = _d_matrix(state[..., 3:])
    d_eye = torch.eye(3, dtype=state.dtype, device=state.device) + d
    c = (d_eye @ b[..., None])[..., 0]
    e = 2.0 * d + d @ d
    zt_e_z = torch.einsum("...i,...ij,...j->...", z, e, z)
    return (-zt_e_z + 2.0 * torch.sum(z * c, dim=-1)
            - torch.sum(b * b, dim=-1))[..., None]


class MagKal:
    """Streaming calibration estimator, its state on ``device``."""

    def __init__(self, device="cuda"):
        q = torch.diag(_as_f([50.0, 50.0, 50.0, 0.001, 0.001, 0.001, 0.001, 0.001, 0.001],
                             device))
        self.state = UkfState(
            x_hat=torch.zeros(9, dtype=q.dtype, device=q.device),
            covar=q,
            prop_covar=torch.zeros((9, 9), dtype=q.dtype, device=q.device),
            noise_covar=_as_f([[1.0e-3]], device),
            config=MerweConfig(9, 0.1, 2.0, -3.0),
        )

    def update(self, z, b_ref):
        """z: raw reading; b_ref: the reference field at the vehicle."""
        device = self.state.x_hat.device
        z, b_ref = _as_f(z, device), _as_f(b_ref, device)
        meas = (torch.sum(z * z, dim=-1) - torch.sum(b_ref * b_ref, dim=-1))[..., None]
        self.state = self.state.update(meas, lambda x: x, lambda x, _z: measure(x, z))
        return self

    @property
    def h_hat(self):
        return self.state.x_hat[..., :3]

    @property
    def d_hat(self):
        return _d_matrix(self.state.x_hat[..., 3:])
