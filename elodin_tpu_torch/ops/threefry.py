"""JAX's default counter-based PRNG, threefry2x32, in torch (counterpart of
the ``jax.random`` calls the JAX package makes: ``key``, ``fold_in``,
``split``, ``bits``, ``uniform`` and ``normal``).

The layout is JAX's partitionable mode (``jax_threefry_partitionable``,
the default): ``split`` and ``bits`` hash the 64-bit flat index of each
output element as the counter pair (hi, lo) under the key, and ``bits``
returns ``y1 ^ y2`` (32-bit) or ``y1 << 32 | y2`` (64-bit, held as the
two words).  ``fold_in`` hashes the pair (0, data).

A key is an int64 tensor ``(..., 2)`` holding two uint32 words.  torch has
no usable uint32 arithmetic, so every word is held in int64 in
``[0, 2**32)`` and masked after each add and shift; a rotation is
``((x << r) | (x >> (32 - r))) & MASK``.  Everything is tensor code on the
key's device, with no host sync, so it runs under ``torch.func.vmap``.

The words and the uniforms are bit for bit JAX's.  ``normal`` is
``sqrt(2) * erfinv(u)`` as in JAX, on ``torch.special.erfinv``, which is
within 3 ulps of a correctly rounded erfinv.  JAX's CPU ``erf_inv`` is
not: its ``log1p`` is off by up to ~130 ulps and its f64 polynomial
forms ``1 - x*x`` with cancellation near |x| = 1, so JAX's normals sit up
to ~30 ulps from the port's in the body and up to ~1.5e-12 relative at
5 sigma.  The port keeps the accurate value; where the two differ by more
than 4 ulps, the difference is JAX's own ``erf_inv`` error.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

MASK = 0xFFFF_FFFF
_PARITY = 0x1BD1_1BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2) -> tuple[Tensor, Tensor]:
    """The 20-round Threefry-2x32 hash of the counter pair (x1, x2) under
    the key words (k1, k2), elementwise with broadcasting; every argument
    a uint32 word held in int64."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    y1 = (x1 + ks[0]) & MASK
    y2 = (x2 + ks[1]) & MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            y1 = (y1 + y2) & MASK
            y2 = y1 ^ _rotl(y2, r)
        y1 = (y1 + ks[(block + 1) % 3]) & MASK
        y2 = (y2 + ks[(block + 2) % 3] + (block + 1)) & MASK
    return y1, y2


def key(seed) -> Tensor:
    """``jax.random.key_data(jax.random.key(seed))``: a 64-bit seed split
    into its high and low words (a 32-bit seed has a high word of 0).  A
    Python int is taken as int64, as JAX takes it with x64 on."""
    if not isinstance(seed, Tensor):
        s = int(seed)
        if not -(1 << 63) <= s < (1 << 64):
            raise OverflowError(f"seed {seed} does not fit 64 bits")
        return torch.tensor([(s >> 32) & MASK, s & MASK], dtype=torch.int64)
    if seed.dtype.is_floating_point or seed.dtype == torch.bool:
        raise TypeError(f"PRNG key seed must be an integer; got {seed.dtype}")
    s = seed.to(torch.int64)
    if seed.dtype.itemsize < 8:
        # a 32-bit seed's logical shift by 32 is 0 in JAX
        hi = torch.zeros_like(s)
    else:
        hi = (s >> 32) & MASK
    return torch.stack([hi, s & MASK], dim=-1)


def _words(data) -> Tensor:
    """``jnp.asarray(data, dtype='uint32')`` of an integer: its low 32 bits."""
    if not isinstance(data, Tensor):
        return torch.tensor(int(data) & MASK, dtype=torch.int64)
    return data.to(torch.int64) & MASK


def fold_in(key: Tensor, data) -> Tensor:
    """``jax.random.fold_in``: the key hashed with the counter (0, data);
    ``data`` is taken modulo 2**32 (a negative int32 wraps)."""
    d = _words(data).to(key.device)
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def _counters(shape, device) -> tuple[Tensor, Tensor]:
    """The (hi, lo) words of the row-major flat index of every element of
    ``shape``, as JAX's ``iota_2x32_shape`` forms them."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK


def _hash_shape(key: Tensor, shape) -> tuple[Tensor, Tensor]:
    """Both hash words for every element of ``shape`` under ``key``
    (``(..., 2)``): tensors of shape ``(..., *shape)``."""
    shape = tuple(int(d) for d in shape)
    hi, lo = _counters(shape, key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k1, k2, hi, lo)


def split(key: Tensor, num: int = 2) -> Tensor:
    """``jax.random.split``: ``num`` new keys, ``(..., num, 2)``."""
    y1, y2 = _hash_shape(key, (num,))
    return torch.stack([y1, y2], dim=-1)


def bits(key: Tensor, shape=(), width: int = 32):
    """``jax.random.bits``.  32-bit words are ``y1 ^ y2`` (an int64 tensor
    in ``[0, 2**32)``); a 64-bit word ``y1 << 32 | y2`` is returned as its
    pair of words ``(hi, lo)``, since int64 cannot hold it."""
    y1, y2 = _hash_shape(key, shape)
    if width == 32:
        return y1 ^ y2
    if width == 64:
        return y1, y2
    raise ValueError(f"bits: width must be 32 or 64, got {width}")


def unit_from_words(y1: Tensor, y2: Tensor, dtype) -> Tensor:
    """JAX's uniform on [0, 1) from the hash words of its counters: the
    top mantissa bits of the 32-bit (f32) or 64-bit (f64) word over 1.0,
    less 1.0.  Exact."""
    if dtype == torch.float32:
        m = (y1 ^ y2) >> 9
        return m.to(torch.float32) * 2.0 ** -23
    if dtype == torch.float64:
        # the 52 high bits of hi << 32 | lo, with no shift past bit 63
        m = (y1 << 20) | (y2 >> 12)
        return m.to(torch.float64) * 2.0 ** -52
    raise TypeError(f"uniform: dtype must be float32 or float64, got {dtype}")


def _scale(u: Tensor, minval: float, maxval: float, dtype) -> Tensor:
    """``max(minval, u * (maxval - minval) + minval)`` in ``dtype``, as
    JAX's ``_uniform`` rounds it."""
    lo = torch.tensor(minval, dtype=dtype, device=u.device)
    hi = torch.tensor(maxval, dtype=dtype, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def uniform(key: Tensor, shape=(), dtype=torch.float64, minval=0.0,
            maxval=1.0) -> Tensor:
    """``jax.random.uniform`` on [minval, maxval)."""
    y1, y2 = _hash_shape(key, shape)
    return _scale(unit_from_words(y1, y2, dtype), minval, maxval, dtype)


def _lowest(dtype) -> float:
    """``nextafter(-1, 0)`` in ``dtype``: the lower end of ``normal``'s
    uniform."""
    return -1.0 + torch.finfo(dtype).eps / 2


def normal_from_words(y1: Tensor, y2: Tensor, dtype) -> Tensor:
    """JAX's ``_normal_real`` from the hash words of its counters:
    ``sqrt(2) * erfinv(u)``, u uniform on [nextafter(-1, 0), 1)."""
    u = _scale(unit_from_words(y1, y2, dtype), _lowest(dtype), 1.0, dtype)
    return math.sqrt(2.0) * torch.special.erfinv(u)


def normal(key: Tensor, shape=(), dtype=torch.float64) -> Tensor:
    """``jax.random.normal``: standard normal draws of ``shape``."""
    y1, y2 = _hash_shape(key, shape)
    return normal_from_words(y1, y2, dtype)
