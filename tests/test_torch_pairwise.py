"""The port's all-pairs gravity (``ops/pairwise.py``) against the JAX
package's, on the CPU.

Stated tolerances, max |Δ| / max |ref| over the (N, 3) accelerations:

* the plain version against JAX ``pairwise_gravity_reference`` in f64:
  ≤ 1e-12 (the same algebra in IEEE f64, sums in another order);
* the plain version in f32 against the Pallas kernel in interpret mode,
  built as ``tests/test_core.py`` builds it: ≤ 1e-4 (f32 rounding over 300
  terms, rsqrt against pow);
* the chunked and unchunked plain versions: max |Δ| ≤ 4 ulp of max |ref|
  (each row sums over all j either way; torch's reduction may group the
  sum differently for another number of rows).

The CUDA kernel itself runs only on the card (``tests/test_torch_gpu.py``);
here its wrapper's dispatch and argument checks are held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elodin_tpu.ops import pairwise as jpw
from elodin_tpu_torch.ops import _build
from elodin_tpu_torch.ops import pairwise as pw
from torch_port_util import rel_err

N = 300


def _cloud(n=N, seed=0):
    """A unit cloud (scale 10) with two coincident bodies and a zero mass."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 10
    pos[7] = pos[3]
    mass = rng.uniform(1, 5, n)
    mass[11] = 0.0
    return pos, mass


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_plain_version_matches_jax_f64(eps):
    pos, mass = _cloud()
    ref = np.asarray(jpw.pairwise_gravity_reference(
        jnp.asarray(pos), jnp.asarray(mass), 1.0, eps))
    ours = pw.pairwise_gravity_reference(torch.as_tensor(pos),
                                         torch.as_tensor(mass), 1.0, eps)
    assert ours.dtype == torch.float64 and np.isfinite(ref).all()
    assert torch.isfinite(ours).all()
    assert rel_err(ours, ref) <= 1e-12


def test_plain_version_matches_pallas_kernel_f32():
    """The JAX kernel body in interpret mode, exactly as
    ``tests/test_core.py::test_pairwise_gravity_kernel_interpret`` builds
    the call."""
    import jax.experimental.pallas as pl

    rng = np.random.default_rng(0)
    pos = (rng.normal(size=(N, 3)) * 10).astype(np.float32)
    mass = rng.uniform(1, 5, N).astype(np.float32)
    pad = (-N) % jpw.TILE_I
    pos_p = np.pad(pos, ((0, pad), (0, 0)))
    kernel, n_i, n_j = jpw._pallas_kernel(N, 1.0, 0.1)
    ref = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(pos_p.shape, np.float32),
        grid=(n_i, n_j),
        in_specs=[
            pl.BlockSpec((jpw.TILE_I, 3), lambda i, j: (i, 0)),
            pl.BlockSpec((3, jpw.TILE_J), lambda i, j: (0, j)),
            pl.BlockSpec((1, jpw.TILE_J), lambda i, j: (0, j)),
        ],
        out_specs=pl.BlockSpec((jpw.TILE_I, 3), lambda i, j: (i, 0)),
        interpret=True,
    )(pos_p, pos_p.T, np.pad(mass, (0, pad))[None, :])[:N]
    ours = pw.pairwise_gravity_reference(torch.as_tensor(pos),
                                         torch.as_tensor(mass), 1.0, 0.1)
    assert ours.dtype == torch.float32
    assert rel_err(ours, np.asarray(ref)) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chunked_equals_unchunked(dtype, monkeypatch):
    pos, mass = _cloud(n=700, seed=1)
    pos, mass = torch.as_tensor(pos, dtype=dtype), torch.as_tensor(mass, dtype=dtype)
    monkeypatch.setattr(pw, "REFERENCE_CHUNK", len(pos))
    whole = pw.pairwise_gravity_reference(pos, mass, 1.0, 0.0)
    ulp = torch.finfo(dtype).eps * whole.abs().max()
    for chunk in (1, 2, 128, 333, 699):
        monkeypatch.setattr(pw, "REFERENCE_CHUNK", chunk)
        parts = pw.pairwise_gravity_reference(pos, mass, 1.0, 0.0)
        assert (parts - whole).abs().max() <= 4 * ulp, chunk


def test_cpu_tensors_take_the_plain_version():
    pos, mass = (torch.as_tensor(x) for x in _cloud())
    before = pw.LAUNCHES
    out = pw.pairwise_gravity(pos, mass, g=2.0, eps=0.1)
    assert torch.equal(out, pw.pairwise_gravity_reference(pos, mass, 2.0, 0.1))
    assert torch.equal(pw.pairwise_gravity(pos, mass, 2.0, 0.1, use_kernel=False), out)
    empty = pw.pairwise_gravity(pos[:0], mass[:0])
    assert empty.shape == (0, 3)
    assert pw.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        pw.pairwise_gravity(pos, mass, use_kernel=True)
    assert pw.LAUNCHES == before


def test_kernel_wrapper_checks_before_loading(monkeypatch):
    """Shapes, dtypes and the device are checked before the library is
    built or loaded."""
    def no_load(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(_build, "load", no_load)
    pw._library.cache_clear()
    pos = torch.zeros(8, 3)
    mass = torch.ones(8)
    cases = [
        ((pos, mass), ValueError, "CUDA"),  # CPU tensors
        ((pos, mass.double()), TypeError, "one dtype"),
        ((pos.half(), mass.half()), TypeError, "float32 or float64"),
        ((pos[:, :2], mass), ValueError, r"\(N, 3\)"),
        ((pos, mass[:5]), ValueError, r"\(N,\)"),
        ((pos.reshape(24), mass), ValueError, r"\(N, 3\)"),
    ]
    for args, exc, match in cases:
        with pytest.raises(exc, match=match):
            pw._pairwise_gravity_cuda(*args, 1.0, 0.0)
    assert pw._library.cache_info().currsize == 0
