"""All-pairs softened gravity (counterpart of ``elodin_tpu/ops/pairwise.py``).

    a_i = G sum_j m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^{3/2}

``pairwise_gravity`` launches the hand-written CUDA kernel
``csrc/pairwise_gravity.cu`` on a CUDA tensor (or raises) and runs
``pairwise_gravity_reference``, the plain PyTorch version, on a CPU tensor.
Self-pairs vanish through the exact ``d2 == 0 -> 1`` remap and a zero
displacement, as in the JAX package; the comparison is ``== 0``, never a
threshold.  Not ported: the Gram-matrix variant (rejected in the JAX
package for its cancellation at orbital scale) and the sharded form
(multi-GPU slice).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

# rows of the (rows, N, 3) displacement tensor per step of the plain version
REFERENCE_CHUNK = 1024

_LAUNCHERS = {torch.float32: "pairwise_gravity_f32",
              torch.float64: "pairwise_gravity_f64"}


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def pairwise_gravity_reference(pos, mass, g: float = 6.6743e-11,
                               eps: float = 0.0):
    """Dense broadcast O(N^2) accelerations (N, 3), any dtype and device.

    Rows i are taken ``REFERENCE_CHUNK`` (1024) at a time, so the
    (chunk, N, 3) displacement intermediate stays bounded: at 16384 bodies
    in f64 it is 400 MB where the unchunked (N, N, 3) tensor is 6.4 GB.
    Each row sums over all j whatever the chunk; only the grouping of
    torch's reduction may change with it, by a few ulp."""
    n = pos.shape[0]
    j = torch.arange(n, device=pos.device)
    out = []
    for start in range(0, n, REFERENCE_CHUNK):
        rows = slice(start, min(start + REFERENCE_CHUNK, n))
        r = pos[None, :, :] - pos[rows, None, :]  # (i, j, 3): vector i -> j
        d2 = torch.sum(r * r, dim=-1) + eps * eps
        d2 = torch.where(d2 == 0.0, 1.0, d2)  # self-interaction guard
        inv_d3 = d2 ** (-1.5)
        eye = j[rows, None] == j[None, :]
        inv_d3 = torch.where(eye, 0.0, inv_d3)
        out.append(g * torch.sum((inv_d3 * mass)[..., None] * r, dim=1))
    if not out:
        return pos.new_empty((0, 3))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("pairwise_gravity")
    for name in _LAUNCHERS.values():
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pos mass out
            ctypes.c_int,  # n
            ctypes.c_double, ctypes.c_double,  # g eps2
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build (or load) the kernel's library now rather than at first use."""
    _library()


def _check(pos, mass) -> int:
    """The kernel's input contract; returns N.  Raises before any library
    is loaded."""
    n = pos.shape[0] if pos.dim() == 2 else -1
    if pos.shape != (n, 3) or mass.shape != (n,):
        raise ValueError(f"expected (N, 3) positions and (N,) masses, got "
                         f"{tuple(pos.shape)} and {tuple(mass.shape)}")
    if pos.dtype not in _LAUNCHERS or mass.dtype != pos.dtype:
        raise TypeError(f"kernel takes float32 or float64 of one dtype, got "
                        f"{pos.dtype} and {mass.dtype}")
    if pos.device.type != "cuda" or mass.device != pos.device:
        raise ValueError(f"kernel needs CUDA tensors on one device, got "
                         f"{pos.device} and {mass.device}")
    if not (pos.is_contiguous() and mass.is_contiguous()):
        raise ValueError("kernel needs contiguous tensors")
    if n >= 2**31:
        raise ValueError(f"{n} bodies out of int32 range")
    return n


def _pairwise_gravity_cuda(pos, mass, g: float, eps: float):
    """Launch csrc/pairwise_gravity.cu on ``pos``'s device and current
    stream."""
    global LAUNCHES
    n = _check(pos, mass)
    out = torch.empty_like(pos)
    if n == 0:
        return out
    launcher = getattr(_library(), _LAUNCHERS[pos.dtype])
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        # eps^2 formed in double, as the JAX kernel's Python float is
        err = launcher(pos.data_ptr(), mass.data_ptr(), out.data_ptr(), n,
                       float(g), float(eps) * float(eps), stream)
    if err != 0:
        raise RuntimeError(f"pairwise_gravity launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def pairwise_gravity(pos, mass, g: float = 6.6743e-11, eps: float = 0.0,
                     use_kernel: bool | None = None):
    """All-pairs gravitational acceleration (N, 3) of bodies at ``pos``
    (N, 3) with masses ``mass`` (N,).

    ``use_kernel=None`` launches the CUDA kernel on a CUDA tensor and runs
    the plain version on a CPU tensor; ``False`` runs the plain version on
    any device; ``True`` launches the kernel and raises on a CPU tensor."""
    if use_kernel is None:
        use_kernel = pos.device.type != "cpu"
    if not use_kernel:
        return pairwise_gravity_reference(pos, mass, g, eps)
    return _pairwise_gravity_cuda(pos.contiguous(), mass.contiguous(), g, eps)
