"""The drone's IMU suite: gyro (drifting bias), accelerometer and
magnetometer (counterpart of ``examples/drone/sensors.py``).

Gyro and accel sample at the 900 Hz fast-loop rate through a biquad
anti-alias LPF; the magnetometer holds at 100 Hz; accel health folds the
specific force's deviation and the rotation rate into a [0, 1] trust
score the MEKF uses.  The noise is one ``fastrand.normal(t, 450, (4, 3))``
draw a sample, keyed on the sensor tick, bit for bit the JAX package's.

This module defines ``@el.map`` systems, so it must not use postponed
annotations.
"""

import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el

from ...ops import fastrand
from .._consts import const

FAST_DT = 1.0 / 900.0
GYRO_LPF_HZ = 40.0
ACCEL_LPF_HZ = 20.0
MAG_RATE_HZ = 100.0

GYRO_NOISE_COV = 0.001
GYRO_BIAS_DRIFT_COV = 0.001
ACCEL_NOISE_COV = 0.001
MAG_NOISE_COV = 0.0001
INIT_GYRO_BIAS = (0.0025, 0.0001, 0.0005)
MAG_REF_WORLD = (0.0, 1.0, 0.0)  # unit field, points north-ish

_F3 = el.ComponentType(el.PrimitiveType.F64, (3,))
_D43 = el.ComponentType(el.PrimitiveType.F64, (4, 3))
T = torch.Tensor

SensorTick = ty.Annotated[T, el.Component("sensor_tick", el.ComponentType.F64)]
Gyro = ty.Annotated[T, el.Component("gyro", _F3, metadata={"element_names": "x,y,z"})]
GyroBias = ty.Annotated[T, el.Component("gyro_bias", _F3)]
GyroDelay = ty.Annotated[T, el.Component("gyro_lpf_delay", _D43)]
Accel = ty.Annotated[T, el.Component("accel", _F3, metadata={"element_names": "x,y,z"})]
AccelBias = ty.Annotated[T, el.Component("accel_bias", _F3)]
AccelDelay = ty.Annotated[T, el.Component("accel_lpf_delay", _D43)]
AccelHealth = ty.Annotated[T, el.Component("accel_health", el.ComponentType.F64)]
Magnetometer = ty.Annotated[
    T, el.Component("magnetometer", _F3, metadata={"element_names": "x,y,z"})]
MagBias = ty.Annotated[T, el.Component("magnetometer_bias", _F3)]

_MAG_REF = np.array(MAG_REF_WORLD)
_UP = np.array([0.0, 0.0, 1.0])


@el.dataclass
class IMU(el.Archetype):
    sensor_tick: SensorTick = field(default_factory=lambda: np.float64(0.0))
    gyro: Gyro = field(default_factory=lambda: np.zeros(3))
    gyro_bias: GyroBias = field(default_factory=lambda: np.asarray(INIT_GYRO_BIAS))
    gyro_lpf_delay: GyroDelay = field(default_factory=lambda: np.zeros((4, 3)))
    accel: Accel = field(default_factory=lambda: np.zeros(3))
    accel_bias: AccelBias = field(default_factory=lambda: np.zeros(3))
    accel_lpf_delay: AccelDelay = field(default_factory=lambda: np.zeros((4, 3)))
    accel_health: AccelHealth = field(default_factory=lambda: np.float64(1.0))
    magnetometer: Magnetometer = field(default_factory=lambda: np.asarray(MAG_REF_WORLD))
    magnetometer_bias: MagBias = field(default_factory=lambda: np.zeros(3))


def make_systems(filter_mod, noise: bool = True):
    """The sensor pipeline (runs at the 900 Hz fast-loop rate): the whole
    IMU suite in one map with one noise draw, whose rows feed the bias
    walk, the gyro, the accel and the magnetometer."""
    gyro_lpf = filter_mod.BiquadLPF(GYRO_LPF_HZ, 1.0 / FAST_DT)
    accel_lpf = filter_mod.BiquadLPF(ACCEL_LPF_HZ, 1.0 / FAST_DT)
    mag_hold = round((1.0 / MAG_RATE_HZ) / FAST_DT)
    # per-row noise scale: [gyro bias drift*dt, gyro, accel, mag]
    scale = np.sqrt(
        np.array([GYRO_BIAS_DRIFT_COV, GYRO_NOISE_COV, ACCEL_NOISE_COV, MAG_NOISE_COV])
    )[:, None] * np.array([FAST_DT, 1.0, 1.0, 1.0])[:, None]

    @el.map
    def imu_sample(
        t: SensorTick,
        p: el.WorldPos,
        v: el.WorldVel,
        a: el.WorldAccel,
        gbias: GyroBias,
        gdelay: GyroDelay,
        abias: AccelBias,
        adelay: AccelDelay,
        mbias: MagBias,
        mprev: Magnetometer,
    ) -> tuple[
        SensorTick, GyroBias, GyroDelay, Gyro, AccelDelay, Accel, Magnetometer, AccelHealth
    ]:
        t = t + 1.0
        if noise:
            z = const(scale, t) * fastrand.normal(t, 450, (4, 3), dtype=t.dtype)
            gbias = gbias + z[0]
        rot_inv = p.angular().inverse()

        w_body = rot_inv @ v.angular()
        if noise:
            w_body = w_body + gbias + z[1]
        gdelay = gyro_lpf.apply(gdelay, w_body)
        gyro = gdelay[2]

        # specific force in g units: proper acceleration minus gravity
        f_body = rot_inv @ (a.linear() / 9.81 + const(_UP, t))
        if noise:
            f_body = f_body + abias + z[2]
        adelay = accel_lpf.apply(adelay, f_body)
        accel = adelay[2]

        m_body = rot_inv @ const(_MAG_REF, t)
        if noise:
            m_body = m_body + mbias + z[3]
        mag = torch.where(torch.remainder(t, mag_hold) < 0.5, m_body, mprev)

        h = 1.0 - torch.clamp(torch.abs(torch.linalg.norm(accel) - 1.0) / 0.5, 0.0, 1.0)
        health = h * (1.0 - torch.clamp(torch.linalg.norm(gyro) / 0.5, 0.0, 1.0))
        return t, gbias, gdelay, gyro, adelay, accel, mag, health

    return imu_sample
