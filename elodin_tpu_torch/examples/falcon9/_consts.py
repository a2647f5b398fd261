"""Module constants (numpy arrays) as tensors on the device and dtype of a
value, made once per device and dtype: a tick would otherwise copy each
table from the host on every use."""

from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}


def const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` on ``like``'s device at ``like``'s dtype.  The cache keeps
    ``arr`` alive, so its ``id`` cannot be reused for another array."""
    key = (id(arr), like.device, like.dtype)
    hit = _CACHE.get(key)
    if hit is None:
        hit = _CACHE[key] = (arr, torch.as_tensor(arr, dtype=like.dtype, device=like.device))
    return hit[1]


def f64(x) -> torch.Tensor:
    """A number or array as an f64 tensor; a tensor passes through."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float64)
