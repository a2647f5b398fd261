"""Falcon 9 sensor suite in torch (counterpart of
``examples/falcon9/sensors.py``): IMU, GPS with a retropropulsion
blackout, radar altimeter, tank and inlet pressure transducers, and the
webcast display model.

The IMU runs at the physics rate; the slower sensors run on a timer
accumulator with hold and a sample counter.  Noise is JAX's:
``fold_in(fold_in(key(20170814), salt), count)`` then an f64 normal, on
``ops.threefry``, so a (salt, count) pair draws the JAX package's value.
``noise`` is one such draw.  ``noise_streams`` draws several (count,
salt) streams at once and gives the same words: the keys
``fold_in(key(20170814), salt)`` are made once, at import, and every
stream's ``fold_in`` and ``normal`` run as one threefry each over the
streams' lanes, in place of three threefry calls a stream.

(This module defines no system, but ``sim.sensor_suite`` reads its
component annotations as objects, so it must not use postponed
annotations.)
"""

import math
import typing as ty
from dataclasses import field as _dc_field

import numpy as np
import torch

import elodin_tpu_torch as el

from ...ops import threefry
from .._consts import const


def _field(factory):
    return _dc_field(default_factory=factory)


GPS_RATE_HZ = 25.0
RADAR_RATE_HZ = 40.0

IMU_ACCEL_SIGMA = 0.02  # m/s^2
IMU_GYRO_SIGMA = 1.0e-3  # rad/s
GPS_POS_SIGMA = 1.5  # m
GPS_VEL_SIGMA = 0.05  # m/s
PRESSURE_SIGMA_PA = 1.0e3
RADAR_MAX_RANGE_M = 500.0
RADAR_FOV_COS = math.cos(math.radians(35.0))
RADAR_SIGMA_M = 0.15
# GPS drops out in the retropropulsion plasma sheath.
BLACKOUT_MACH_MIN = 2.5
BLACKOUT_THRUST_MIN_N = 1.0e5

DISPLAY_SPEED_STEP = 1000.0 / 3600.0  # 1 km/h
DISPLAY_ALT_STEP = 100.0  # 0.1 km

_KEY = threefry.key(20170814)
# row s is fold_in(_KEY, s), for the suite's stream salts 1-6
_SALT_KEYS = threefry.fold_in(_KEY.expand(7, 2), torch.arange(7)).numpy()

_F3 = el.ComponentType(el.PrimitiveType.F64, (3,))
_F = el.ComponentType.F64
T = torch.Tensor
ImuAccel = ty.Annotated[T, el.Component("imu_accel", _F3)]
ImuGyro = ty.Annotated[T, el.Component("imu_gyro", _F3)]
GpsTimer = ty.Annotated[T, el.Component("gps_timer", _F)]
GpsPos = ty.Annotated[T, el.Component("gps_pos", _F3)]
GpsVel = ty.Annotated[T, el.Component("gps_vel", _F3)]
GpsCount = ty.Annotated[T, el.Component("gps_count", _F)]
RadarTimer = ty.Annotated[T, el.Component("radar_timer", _F)]
RadarRange = ty.Annotated[T, el.Component("radar_range", _F)]
RadarCount = ty.Annotated[T, el.Component("radar_count", _F)]
PressureMeas = ty.Annotated[
    T, el.Component("pressure_meas", el.ComponentType(el.PrimitiveType.F64, (4,)))
]
DisplaySpeed = ty.Annotated[T, el.Component("display_speed", _F)]
DisplayAlt = ty.Annotated[T, el.Component("display_alt", _F)]


def _count_words(count: T) -> T:
    """``count.astype(int32)`` as the uint32 word ``fold_in`` hashes."""
    return count.to(torch.int32).to(torch.int64) & threefry.MASK


def noise(count: T, salt: int, shape, sigma: float) -> T:
    """Deterministic N(0, sigma) draw keyed by (stream salt, sample
    count)."""
    key = threefry.fold_in(threefry.fold_in(_KEY.to(count.device), salt),
                           _count_words(count))
    return sigma * threefry.normal(key, shape, torch.float64)


_LANES: dict = {}


def _lanes(salts: tuple, shapes: tuple, sigmas: tuple) -> tuple:
    """Host constants of a set of streams, cached per layout: the streams'
    salt keys, each lane's stream, its counter within the stream and its
    sigma, and each stream's size."""
    hit = _LANES.get((salts, shapes, sigmas))
    if hit is None:
        sizes = [math.prod(s) for s in shapes]
        hit = _LANES[(salts, shapes, sigmas)] = (
            _SALT_KEYS[list(salts)],
            np.repeat(np.arange(len(sizes)), sizes),
            np.concatenate([np.arange(n) for n in sizes]),
            np.repeat(np.asarray(sigmas, dtype=np.float64), sizes),
            sizes)
    return hit


def noise_streams(draws) -> list[T]:
    """``[noise(count, salt, shape, sigma) for (count, salt, shape, sigma)
    in draws]``, bit for bit, as one ``fold_in`` and one ``normal`` over
    every lane of every stream."""
    counts, salts, shapes, sigmas = zip(*draws)
    shapes = tuple(tuple(s) for s in shapes)
    salt_keys, stream, index, sigma, sizes = _lanes(tuple(salts), shapes, tuple(sigmas))
    words = torch.stack([_count_words(c) for c in counts])
    keys = const(salt_keys, words)
    k1, k2 = threefry.threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(words), words)
    lane = const(stream, k1)
    y1, y2 = threefry.threefry2x32(k1[..., lane], k2[..., lane], 0, const(index, k1))
    z = threefry.normal_from_words(y1, y2, torch.float64)
    out = const(sigma, z) * z
    return [part.reshape(part.shape[:-1] + shape)
            for part, shape in zip(out.split(sizes, dim=-1), shapes)]


@el.dataclass
class SensorSuite(el.Archetype):
    imu_accel: ImuAccel = _field(lambda: np.zeros(3))
    imu_gyro: ImuGyro = _field(lambda: np.zeros(3))
    gps_timer: GpsTimer = _field(lambda: np.float64(0.0))
    gps_pos: GpsPos = _field(lambda: np.zeros(3))
    gps_vel: GpsVel = _field(lambda: np.zeros(3))
    gps_count: GpsCount = _field(lambda: np.float64(0.0))
    radar_timer: RadarTimer = _field(lambda: np.float64(0.0))
    radar_range: RadarRange = _field(lambda: np.float64(-1.0))
    radar_count: RadarCount = _field(lambda: np.float64(0.0))
    pressure_meas: PressureMeas = _field(lambda: np.zeros(4))
    display_speed: DisplaySpeed = _field(lambda: np.float64(0.0))
    display_alt: DisplayAlt = _field(lambda: np.float64(0.0))
