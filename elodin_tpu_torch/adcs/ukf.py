"""Unscented Kalman filter with Merwe scaled sigma points (counterpart of
``elodin_tpu/adcs/ukf.py``).

The sigma set is one stacked matrix, the propagate and measure functions
run over it under ``torch.func.vmap`` (the JAX package's ``jax.vmap``),
and the gain is a solve by the unrolled Cholesky
(``ops.smallalg.psd_solve``), which never syncs the host.  The weights
are made on the state's device.  ``UkfState`` is registered with
``torch.utils._pytree`` (its tensors are the leaves, the config the
context), as the JAX class is a pytree.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from .. import _config
from ..ops.smallalg import cholesky_upper, psd_solve
from ..spatial import _as_f


def unscented_transform(points, mean_weights, covar_weights):
    """Weighted mean and weighted outer-product covariance of the points
    (..., s, n)."""
    x_hat = torch.einsum("...sn,...s->...n", points, mean_weights)
    y = points - x_hat[..., None, :]
    covar = torch.einsum("...sn,...s,...sm->...nm", y, covar_weights, y)
    return x_hat, covar


def cross_covar(x_hat, z_hat, points_x, points_z, covar_weights):
    dx = points_x - x_hat[..., None, :]
    dz = points_z - z_hat[..., None, :]
    return torch.einsum("...sn,...s,...sz->...nz", dx, covar_weights, dz)


def predict(sigma_points, prop_fn, mean_weights, covar_weights, prop_covar):
    points = vmap(prop_fn)(sigma_points)
    x_hat, covar = unscented_transform(points, mean_weights, covar_weights)
    return points, x_hat, covar + prop_covar


def innovate(x_points, z, measure_fn, mean_weights, covar_weights, noise_covar):
    points = vmap(lambda p: measure_fn(p, z))(x_points)
    z_hat, covar = unscented_transform(points, mean_weights, covar_weights)
    return points, z_hat, covar + noise_covar


class MerweConfig:
    """Merwe scaled sigma-point config; value-equal and hashable (it is the
    pytree context of ``UkfState``)."""

    def __init__(self, n: int, alpha: float, beta: float, kappa: float):
        self.n = n
        self.alpha = alpha
        self.beta = beta
        self.kappa = kappa
        self.lambda_ = alpha**2 * (n + kappa) - n

    def _key(self):
        return (self.n, self.alpha, self.beta, self.kappa)

    def __eq__(self, other) -> bool:
        return isinstance(other, MerweConfig) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def sigma_points(self, x, sigma):
        """2n+1 points: x, x + rows(U), x - rows(U) where
        U = chol((n+lambda) Sigma)^T."""
        x, sigma = _as_f(x), _as_f(sigma)
        n, lam = self.n, self.lambda_
        u = cholesky_upper((n + lam) * sigma)
        plus = x[..., None, :] + u
        minus = x[..., None, :] - u
        return torch.cat([x[..., None, :], plus, minus], dim=-2)

    def _weights(self, first: float, device) -> torch.Tensor:
        n, lam = self.n, self.lambda_
        w_i = 1.0 / (2.0 * (n + lam))
        return torch.tensor([first] + [w_i] * (2 * n), dtype=_config.default_float(),
                            device=device)

    def mean_weights(self, device=None):
        n, lam = self.n, self.lambda_
        return self._weights(lam / (n + lam), device)

    def covariance_weights(self, device=None):
        n, lam = self.n, self.lambda_
        return self._weights(lam / (n + lam) + (1.0 - self.alpha**2 + self.beta), device)


@dataclass
class UkfState:
    """UKF state; ``update`` is one predict and innovate."""

    x_hat: torch.Tensor
    covar: torch.Tensor
    prop_covar: torch.Tensor
    noise_covar: torch.Tensor
    config: MerweConfig

    def update(self, z, prop_fn, measure_fn) -> "UkfState":
        cfg = self.config
        device = self.x_hat.device
        z = _as_f(z, device)
        sigma = cfg.sigma_points(self.x_hat, self.covar)
        mw = cfg.mean_weights(device)
        cw = cfg.covariance_weights(device)
        points_x, x_hat, covar = predict(sigma, prop_fn, mw, cw, self.prop_covar)
        points_z, z_hat, z_covar = innovate(points_x, z, measure_fn, mw, cw, self.noise_covar)
        pxz = cross_covar(x_hat, z_hat, points_x, points_z, cw)
        # a solve, not an explicit inverse (conditioning and cost)
        k = psd_solve(z_covar, pxz.transpose(-1, -2)).transpose(-1, -2)
        y = z - z_hat
        x_new = x_hat + (k @ y[..., None])[..., 0]
        covar_new = covar - k @ z_covar @ k.transpose(-1, -2)
        return UkfState(x_new, covar_new, self.prop_covar, self.noise_covar, cfg)


pytree.register_pytree_node(
    UkfState,
    lambda s: ([s.x_hat, s.covar, s.prop_covar, s.noise_covar], s.config),
    lambda children, config: UkfState(*children, config=config),
    serialized_type_name="elodin_tpu_torch.adcs.ukf.UkfState",
)
