"""The port's threefry (``elodin_tpu_torch.ops.threefry``) against
``jax.random`` on the CPU (x64 on, partitionable threefry2x32, JAX's
defaults).

Stated tolerances:

* key, fold_in, split and bits (32- and 64-bit) words: bit for bit, over
  int64 seeds of 2**32 and above, negative seeds, int32 seeds, negative
  int32 fold_in data, counts cast to int32 from f64, and shapes (), (3,),
  (4,), (2, 3) and (1000,).
* uniform, f32 and f64: bit for bit (at most the 1 ulp allowed).
* normal: within 4 ulps of sqrt(2) * a correctly rounded erfinv of the same
  uniform (scipy's), and within 4 ulps of JAX's normal plus JAX's own
  erf_inv error against that reference, element by element.  JAX's CPU
  erf_inv is off by up to ~70 ulps in the body (its log1p) and more in
  the tails; where the two packages differ by more than 4 ulps, all of the
  difference is JAX's.  The draws the examples make (the ball's wind of
  seed 0, the falcon9 suite's first counts) are within 4 ulps of JAX's.
* vmap over a batch of counts equals a Python loop bit for bit.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import scipy.special
import torch

from elodin_tpu_torch.ops import threefry as tf

jax.config.update("jax_enable_x64", True)

SEEDS = [0, 1, 42, 2**32, 2**32 + 5, 2**40 + 123, 2**63 - 1, -1, -7, -(2**40), 20170814]
SHAPES = [(), (3,), (4,), (2, 3), (1000,)]


def _words(key) -> np.ndarray:
    return np.asarray(jr.key_data(key)).astype(np.int64)


def _ulps(ours, ref) -> np.ndarray:
    ref = np.asarray(ref)
    return np.abs(np.asarray(ours, dtype=np.float64) - ref) / np.spacing(np.abs(ref))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_words(seed):
    ref = _words(jr.key(seed))
    np.testing.assert_array_equal(tf.key(seed).numpy(), ref)
    np.testing.assert_array_equal(tf.key(torch.tensor(seed)).numpy(), ref)


def test_key_of_int32_and_uint64_seeds():
    for s in (-1, 5, 2**31 - 1):
        np.testing.assert_array_equal(tf.key(torch.tensor(s, dtype=torch.int32)).numpy(),
                                      _words(jr.key(jnp.int32(s))))
    # a u64 seed past 2**63 is held as its int64 bit pattern on the device
    big = np.uint64(2**63 + 5)
    np.testing.assert_array_equal(tf.key(torch.tensor(big.astype(np.int64))).numpy(),
                                  _words(jr.key(jnp.uint64(big))))
    with pytest.raises(OverflowError):
        tf.key(2**64)
    with pytest.raises(TypeError):
        tf.key(torch.tensor(1.0))


@pytest.mark.parametrize("seed", [0, 2**32 + 5, -7, 20170814])
def test_fold_in_words(seed):
    key, ref_key = tf.key(seed), jr.key(seed)
    data = [0, 1, 6, -1, -5, 2**31 - 1, -(2**31), 1234567]
    for d in data:
        np.testing.assert_array_equal(
            tf.fold_in(key, torch.tensor(d, dtype=torch.int32)).numpy(),
            _words(jr.fold_in(ref_key, jnp.int32(d))))
    np.testing.assert_array_equal(tf.fold_in(key, 6).numpy(), _words(jr.fold_in(ref_key, 6)))
    # batched data folds every value under the one key
    batched = tf.fold_in(key, torch.tensor(data, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(
        batched, np.stack([_words(jr.fold_in(ref_key, jnp.int32(d))) for d in data]))


def test_fold_in_of_a_count_cast_from_f64():
    """The falcon9 suite folds ``count.astype(int32)`` of an f64 count."""
    key, ref_key = tf.key(20170814), jr.key(20170814)
    for c in (0.0, 1.0, 7.9, 300.0, 12345.0, -3.5):
        ours = tf.fold_in(key, torch.tensor(c, dtype=torch.float64).to(torch.int32))
        ref = jr.fold_in(ref_key, jnp.float64(c).astype(jnp.int32))
        np.testing.assert_array_equal(ours.numpy(), _words(ref))


@pytest.mark.parametrize("num", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 2**32 + 5, -7])
def test_split_words(seed, num):
    np.testing.assert_array_equal(tf.split(tf.key(seed), num).numpy(),
                                  _words(jr.split(jr.key(seed), num)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 2**40 + 123, -1])
def test_bits_words(seed, shape):
    key, ref_key = tf.key(seed), jr.key(seed)
    np.testing.assert_array_equal(tf.bits(key, shape).numpy(),
                                  np.asarray(jr.bits(ref_key, shape, jnp.uint32)))
    hi, lo = tf.bits(key, shape, 64)
    ours = (hi.numpy().astype(np.uint64) << np.uint64(32)) | lo.numpy().astype(np.uint64)
    np.testing.assert_array_equal(ours, np.asarray(jr.bits(ref_key, shape, jnp.uint64)))
    with pytest.raises(ValueError):
        tf.bits(key, shape, 16)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_bit_for_bit(shape, dtype):
    key, ref_key = tf.key(3), jr.key(3)
    tdtype = getattr(torch, dtype)
    for lo, hi in ((0.0, 1.0), (-3.0, 5.0)):
        ours = tf.uniform(key, shape, tdtype, lo, hi).numpy()
        ref = np.asarray(jr.uniform(ref_key, shape, getattr(jnp, dtype), lo, hi))
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_normal_within_ulps(dtype):
    n = 200_000
    tdtype, jdtype = getattr(torch, dtype), getattr(jnp, dtype)
    key, ref_key = tf.key(7), jr.key(7)
    ours = tf.normal(key, (n,), tdtype).numpy()
    u = tf.uniform(key, (n,), tdtype, tf._lowest(tdtype), 1.0).numpy()
    exact = (np.sqrt(2.0) * scipy.special.erfinv(u.astype(np.float64))).astype(ours.dtype)
    assert _ulps(ours, exact).max() <= 4
    ref = np.asarray(jr.normal(ref_key, (n,), jdtype))
    jax_err = np.abs(ref.astype(np.float64) - exact)
    allowed = 4 * np.spacing(np.abs(ref)) + jax_err
    assert (np.abs(ours.astype(np.float64) - ref) <= allowed).all()
    assert np.median(_ulps(ours, ref)) <= 1


@pytest.mark.parametrize("shape", [(), (3,), (4,)])
def test_example_draws_within_4_ulps_of_jax(shape):
    for seed in (0, 1, 2, 20170814):
        ours = tf.normal(tf.key(seed), shape, torch.float64).numpy()
        ref = np.asarray(jr.normal(jr.key(seed), shape))
        assert _ulps(ours, ref).max() <= 4


def test_ball_wind_row_reproduced():
    """Row 2 of the stored ball baseline is jr.normal(jr.key(0), (3,))."""
    import csv
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "baseline", "ball", "ball.wind.csv")
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    stored = np.asarray(json.loads(rows[2][1]))
    ours = tf.normal(tf.key(0), (3,), torch.float64).numpy()
    assert _ulps(ours, stored).max() <= 4


def test_vmap_over_counts_equals_a_loop():
    key = tf.key(20170814)
    counts = torch.arange(-4, 60, dtype=torch.float64)

    def draw(c):
        return tf.normal(tf.fold_in(key, c.to(torch.int32)), (3,), torch.float64)

    batched = torch.func.vmap(draw)(counts)
    looped = torch.stack([draw(c) for c in counts])
    assert torch.equal(batched, looped)
    batched_keys = torch.func.vmap(lambda k: tf.split(k, 4))(tf.split(key, 8))
    assert torch.equal(batched_keys, torch.stack([tf.split(k, 4) for k in tf.split(key, 8)]))
