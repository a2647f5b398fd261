"""Counter-based noise (counterpart of ``elodin_tpu/ops/fastrand.py``).

``normal(tick, salt, shape)`` is a stateless hash: a murmur3 finalizer
over (tick, salt, lane) counters feeding a Box-Muller transform, so the
same (tick, salt) always gives the same draw.  It is bit-exact with the
JAX package's: torch has no uint32 multiply, so the uint32 arithmetic
runs in int64 and every product and sum is masked back to 32 bits (an
int64 product may wrap, which keeps its low 32 bits).  The tick is
converted as there: float -> int32 -> uint32.

Quirk kept from the reference: u2 of ``normal`` takes the salt
``salt + 0x5851``, so salts 0x5851 apart share words.
"""

from __future__ import annotations

import math

import torch

_C1 = 0x85EB_CA6B
_C2 = 0xC2B2_AE35
_GOLD = 0x9E37_79B9
_MASK = 0xFFFF_FFFF


def _mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on uint32 words held in int64."""
    h = h ^ (h >> 16)
    h = (h * _C1) & _MASK
    h = h ^ (h >> 13)
    h = (h * _C2) & _MASK
    h = h ^ (h >> 16)
    return h


def hash_u32(tick, salt: int, n: int) -> torch.Tensor:
    """n avalanche-mixed uint32 words (as int64 in [0, 2^32)) for counter
    (tick, salt); a float tick is truncated to int32 first."""
    t = tick if isinstance(tick, torch.Tensor) else torch.as_tensor(tick)
    t = t.to(torch.int32).to(torch.int64) & _MASK
    lanes = torch.arange(n, dtype=torch.int64, device=t.device)
    h = _mix((t * _GOLD + salt) & _MASK)
    # the lane index folds in after the tick's avalanche
    return _mix((h + lanes * _C2 + 0x27D4_EB2F) & _MASK)


def uniform(tick, salt: int, shape, dtype=torch.float64) -> torch.Tensor:
    """U(0, 1) with the counter scheme; open at 0 (safe for log())."""
    n = int(math.prod(shape)) if shape else 1
    bits = hash_u32(tick, salt, n)
    u = (bits.to(dtype) + 1.0) * (1.0 / 4294967296.0)
    return u.reshape(shape)


def normal(tick, salt: int, shape, dtype=torch.float64) -> torch.Tensor:
    """N(0, 1) draw keyed on (tick, salt): Box-Muller over counter hashes."""
    n = int(math.prod(shape)) if shape else 1
    half = (n + 1) // 2
    u1 = uniform(tick, salt, (half,), dtype)
    u2 = uniform(tick, salt + 0x5851, (half,), dtype)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u2
    z = torch.cat([r * torch.cos(theta), r * torch.sin(theta)])[:n]
    return z.reshape(shape)
