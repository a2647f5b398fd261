"""Discrete-time filters of the drone's sensor and control paths
(counterpart of ``examples/drone/filter.py``): a first-order LPF and a
biquad section, each a pure function of (state, x) -> state."""

from __future__ import annotations

import math

import numpy as np
import torch

from .._consts import const


class LPF:
    """First-order low-pass: y' = y + alpha (x - y); cutoff 0 disables.
    ``alpha`` is a numpy constant (one per axis for a vector cutoff)."""

    def __init__(self, cutoff_hz, sample_hz: float):
        dt = 1.0 / sample_hz
        with np.errstate(divide="ignore"):
            rc = 1.0 / (2.0 * math.pi * np.asarray(cutoff_hz, dtype=np.float64))
        rc = np.nan_to_num(rc, posinf=0.0)
        self.alpha = np.asarray(dt / (rc + dt))

    def apply(self, y_prev: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y_prev + const(self.alpha, y_prev) * (x - y_prev)


class BiquadLPF:
    """Second-order low-pass biquad (Q = 1/sqrt(2), direct form I).

    The delay state is a (4, *shape) stack [x1, x2, y1, y2]; ``apply``
    returns the new delay, whose row 2 is the output sample."""

    def __init__(self, cutoff_hz: float, sample_hz: float):
        if cutoff_hz <= 0 or sample_hz <= 0:
            raise ValueError("cutoff and sample rates must be positive")
        w = 2.0 * math.pi * cutoff_hz / sample_hz
        alpha = math.sin(w) / math.sqrt(2.0)
        a0 = 1.0 + alpha
        b1 = (1.0 - math.cos(w)) / a0
        b0 = b2 = b1 / 2.0
        self.b = (b0, b1, b2)
        self.a = ((-2.0 * math.cos(w)) / a0, (1.0 - alpha) / a0)

    def apply(self, delay: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        x1, x2, y1, y2 = delay.unbind(0)
        b0, b1, b2 = self.b
        a1, a2 = self.a
        y = b0 * x + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        return torch.stack([x, x1, y, y1])
