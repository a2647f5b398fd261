"""Sensor models and IMU pre-integration in torch (counterpart of
``elodin_tpu/sensors.py``).

* ``coning_sculling_window``: the two-sample Bortz coning and sculling
  correction of one window of raw IMU samples.  The JAX package's
  ``lax.scan`` is a Python loop over the window's samples (the window
  length is static), in the scan's order of operations;
  ``ConingScullingIntegrator`` wraps it with the firmware's push/emit API.
* ``imu_measure``, ``magnetometer_measure``, ``gps_measure`` and
  ``barometer_measure``: noisy sensors drawing from JAX's threefry
  (``ops.threefry``), so a key gives the JAX package's draws.  A key is an
  int64 tensor ``(2,)`` of uint32 words (``threefry.key``).

Everything is tensor code on its inputs' device, with no host sync, and
runs under ``torch.func.vmap``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .ops import threefry

Tensor = torch.Tensor


# -- coning / sculling -------------------------------------------------------


def coning_sculling_window(gyro, accel, dt) -> tuple[Tensor, Tensor]:
    """Integrate one window of raw IMU samples into corrected averages.

    gyro, accel: (n, 3) raw samples; dt: a scalar or (n,) sample
    intervals.  Returns (gyro_avg, accel_avg), corrected for coning
    (two-sample Bortz) and sculling (rotation-acceleration coupling)."""
    gyro = torch.as_tensor(gyro)
    accel = torch.as_tensor(accel, device=gyro.device)
    n = gyro.shape[0]
    if isinstance(dt, (int, float)):
        # JAX's weak type: the samples keep their dtype, the window's
        # total time is summed in f64
        dt_arr = torch.full((n,), float(dt), dtype=torch.float64, device=gyro.device)
        dt_mul = dt_arr.to(gyro.dtype)
    else:
        dt_arr = dt_mul = torch.as_tensor(dt, device=gyro.device).expand(n)
    d_angle = gyro * dt_mul[:, None]
    d_vel = accel * dt_mul[:, None]

    zero = torch.zeros(3, dtype=d_angle.dtype, device=gyro.device)
    accum_angle, accum_vel, prev_angle, coning = zero, zero, zero, zero
    for i in range(n):
        da, dv = d_angle[i], d_vel[i]
        term = zero if i == 0 else (2.0 / 3.0) * torch.linalg.cross(prev_angle, da)
        coning = coning + term
        sculling = 0.5 * torch.linalg.cross(accum_angle, dv)
        accum_vel = accum_vel + dv + sculling
        accum_angle = accum_angle + da
        prev_angle = da
    total_dt = torch.sum(dt_arr)
    # an f32 window over an f64 total promotes, as in JAX
    dtype = torch.promote_types(accum_angle.dtype, total_dt.dtype)
    return (accum_angle + coning).to(dtype) / total_dt, accum_vel.to(dtype) / total_dt


class ConingScullingIntegrator:
    """Streaming wrapper with the firmware's push/emit API: ``push``
    returns the corrected averages every ``decimation`` accepted samples,
    else None; a sample with dt outside (0, 0.1] is dropped."""

    def __init__(self, decimation: int):
        self.decimation = int(decimation)
        self._gyro: list = []
        self._accel: list = []
        self._dt: list = []

    def push(self, gyro, accel, dt: float):
        if dt <= 0.0 or dt > 0.1:
            return None
        self._gyro.append(torch.as_tensor(gyro))
        self._accel.append(torch.as_tensor(accel))
        self._dt.append(dt)
        if len(self._gyro) >= self.decimation:
            gyro = torch.stack(self._gyro)
            out = coning_sculling_window(
                gyro, torch.stack(self._accel),
                torch.as_tensor(self._dt, dtype=torch.float64, device=gyro.device))
            self._gyro.clear()
            self._accel.clear()
            self._dt.clear()
            return out
        return None


# -- noisy sensor models -----------------------------------------------------


@dataclass(frozen=True)
class ImuSpec:
    gyro_noise: float = 1e-3  # rad/s/sqrt(Hz) white
    gyro_bias_walk: float = 1e-5  # rad/s^2/sqrt(Hz)
    accel_noise: float = 5e-3
    accel_bias_walk: float = 1e-4


def _sqrt(x):
    return math.sqrt(x) if isinstance(x, (int, float)) else torch.sqrt(x)


def _normal(key: Tensor, like: Tensor) -> Tensor:
    return threefry.normal(key, tuple(like.shape), torch.float64)


def imu_measure(key: Tensor, spec: ImuSpec, omega_body, accel_body, gyro_bias,
                accel_bias, dt):
    """One IMU sample: the true body rates and specific force to a noisy
    measurement, and the biases one random-walk step on.  Returns
    (gyro_meas, accel_meas, gyro_bias', accel_bias')."""
    k1, k2, k3, k4 = threefry.split(key, 4).unbind(-2)
    sq = _sqrt(1.0 / dt)
    gyro = omega_body + gyro_bias + spec.gyro_noise * sq * _normal(k1, omega_body)
    accel = accel_body + accel_bias + spec.accel_noise * sq * _normal(k2, accel_body)
    gyro_bias = gyro_bias + spec.gyro_bias_walk * _sqrt(dt) * _normal(k3, gyro_bias)
    accel_bias = accel_bias + spec.accel_bias_walk * _sqrt(dt) * _normal(k4, accel_bias)
    return gyro, accel, gyro_bias, accel_bias


def magnetometer_measure(key: Tensor, field_body, noise_nt: float = 100.0,
                         hard_iron=None, soft_iron=None) -> Tensor:
    """Noisy magnetometer with optional hard- and soft-iron distortion."""
    out = field_body
    if soft_iron is not None:
        out = (torch.as_tensor(soft_iron, device=out.device) @ out[..., None])[..., 0]
    if hard_iron is not None:
        out = out + torch.as_tensor(hard_iron, device=out.device)
    return out + noise_nt * _normal(key, out)


def gps_measure(key: Tensor, pos_ecef, vel_ecef, pos_sigma: float = 1.5,
                vel_sigma: float = 0.05) -> tuple[Tensor, Tensor]:
    k1, k2 = threefry.split(key, 2).unbind(-2)
    return (pos_ecef + pos_sigma * _normal(k1, pos_ecef),
            vel_ecef + vel_sigma * _normal(k2, vel_ecef))


def barometer_measure(key: Tensor, alt_m, sigma_m: float = 0.5, bias_m: float = 0.0):
    alt = torch.as_tensor(alt_m, dtype=torch.float64, device=key.device)
    return alt_m + bias_m + sigma_m * _normal(key, alt)
