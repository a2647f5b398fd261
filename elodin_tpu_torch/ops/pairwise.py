"""All-pairs softened gravity (counterpart of ``elodin_tpu/ops/pairwise.py``).

    a_i = G sum_j m_j (x_j - x_i) / (|x_j - x_i|^2 + eps^2)^{3/2}

``pairwise_gravity`` launches the hand-written CUDA kernel
``csrc/pairwise_gravity.cu`` on a CUDA tensor (or raises) and runs
``pairwise_gravity_reference``, the plain PyTorch version, on a CPU tensor.
The kernel's launch plan (threads per CTA, bodies i per thread, CTAs per
cluster splitting j, and the j-slice) comes from ``_launch_plan``.
Self-pairs vanish through the exact ``d2 == 0 -> 1`` remap and a zero
displacement, as in the JAX package; the comparison is ``== 0``, never a
threshold.  Each form computes a block of rows ``[row0, row0 + rows)``
against all N bodies (the whole set by default), and
``pairwise_gravity_sharded`` cuts the rows over the devices of a mesh, each
device all-gathering the positions and masses.  Not ported: the
Gram-matrix variant (rejected in the JAX package for its cancellation at
orbital scale).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

# rows of the (rows, N, 3) displacement tensor per step of the plain version
REFERENCE_CHUNK = 1024

_LAUNCHERS = {torch.float32: "pairwise_gravity_f32",
              torch.float64: "pairwise_gravity_f64"}

# the kernel's j-tile (bodies a warp stages at a time); j-slices are
# multiples of it
TILE = 64
# CTAs per cluster (the portable limit) and warps per CTA
MAX_CLUSTER = 8
MAX_WARPS = 16
# warps a SM the plan fills at most, in one wave
WARPS_PER_SM = 32


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def pairwise_gravity_reference(pos, mass, g: float = 6.6743e-11,
                               eps: float = 0.0, *, row0: int = 0,
                               rows: int | None = None):
    """Dense broadcast O(N^2) accelerations (rows, 3) of bodies ``[row0,
    row0 + rows)`` (all N by default) from all N bodies, any dtype and
    device.

    Rows i are taken ``REFERENCE_CHUNK`` (1024) at a time, so the
    (chunk, N, 3) displacement intermediate stays bounded: at 16384 bodies
    in f64 it is 400 MB where the unchunked (N, N, 3) tensor is 6.4 GB.
    Each row sums over all j whatever the chunk; only the grouping of
    torch's reduction may change with it, by a few ulp."""
    n = pos.shape[0]
    stop = _row_range(n, row0, rows)
    j = torch.arange(n, device=pos.device)
    out = []
    for start in range(row0, stop, REFERENCE_CHUNK):
        block = slice(start, min(start + REFERENCE_CHUNK, stop))
        r = pos[None, :, :] - pos[block, None, :]  # (i, j, 3): vector i -> j
        d2 = torch.sum(r * r, dim=-1) + eps * eps
        d2 = torch.where(d2 == 0.0, 1.0, d2)  # self-interaction guard
        inv_d3 = d2 ** (-1.5)
        eye = j[block, None] == j[None, :]
        inv_d3 = torch.where(eye, 0.0, inv_d3)
        out.append(g * torch.sum((inv_d3 * mass)[..., None] * r, dim=1))
    if not out:
        return pos.new_empty((0, 3))
    return torch.cat(out)


def _row_range(n: int, row0: int, rows: int | None) -> int:
    """The end of the row block ``[row0, row0 + rows)`` of ``n`` bodies
    (``rows`` None: to the last); raises unless it lies inside them."""
    stop = n if rows is None else row0 + rows
    if not 0 <= row0 <= stop <= n:
        raise ValueError(f"row block [{row0}, {stop}) outside the {n} bodies")
    return stop


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


class Plan(NamedTuple):
    """One launch of the kernel.  A cluster of ``s`` CTAs holds ``32 * r``
    rows i (``r`` a thread); each CTA has ``threads`` threads, ``threads /
    32`` warps, and warp w of CTA rank k sweeps j in ``[(k * threads / 32 +
    w) * slice, + slice)``."""
    threads: int
    r: int
    s: int
    slice: int

    @property
    def splits(self) -> int:
        """j-slices a row is cut into (warps of a cluster)."""
        return self.s * self.threads // 32

    def grid(self, rows: int) -> int:
        """CTAs launched for a block of ``rows`` rows."""
        return _cdiv(rows, 32 * self.r) * self.s


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(n: int, threads: int, r: int, s: int) -> Plan:
    """``r`` rows a thread, j cut into ``s * threads / 32`` tile-aligned
    slices, then the CTAs and warps cut to the slices that hold bodies."""
    slice_ = _cdiv(_cdiv(n, s * threads // 32), TILE) * TILE
    slices = _cdiv(n, slice_)
    s = min(s, slices)
    return Plan(32 * _cdiv(slices, s), r, s, slice_)


@functools.cache
def _launch_plan(n: int, sm_count: int, rows: int | None = None) -> Plan:
    """The kernel's plan for a block of ``rows >= 1`` rows (all ``n``
    bodies by default) against ``n`` bodies on a card of ``sm_count`` SMs,
    measured by ``scripts/pairwise_plan_sweep.py`` for whole calls (the same
    plan is the fastest or near it in f32 and f64).  Cached: a simulation
    asks for the same N every tick.

    Two rows a thread where that still gives every SM a row block, else
    one; a cluster of two CTAs a row block where the row blocks alone would
    leave SMs idle; then j is cut into as many slices (warps a cluster) as
    fill the card with up to ``WARPS_PER_SM`` warps a SM in one wave.  A
    block of fewer rows thus cuts j finer."""
    rows = n if rows is None else rows
    r = 2 if _cdiv(rows, 64) >= sm_count else 1
    i_blocks = _cdiv(rows, 32 * r)
    s = 1 if i_blocks >= sm_count else 2
    splits = max(1, min(_cdiv(n, TILE), MAX_WARPS * s, WARPS_PER_SM * sm_count // i_blocks))
    return _plan(n, 32 * _cdiv(splits, s), r, s)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("pairwise_gravity")
    if lib.pairwise_gravity_tile() != TILE:
        raise RuntimeError(f"pairwise_gravity.cu tiles j by {lib.pairwise_gravity_tile()} "
                           f"bodies, ops/pairwise.py plans for {TILE}")
    for name in _LAUNCHERS.values():
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pos mass out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n row0 rows
            ctypes.c_double, ctypes.c_double,  # g eps2
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # the plan
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build (or load) the kernel's library now rather than at first use."""
    _library()


def _check(pos, mass) -> int:
    """The kernel's input contract; returns N.  Raises before any library
    is loaded.  The kernel has no backward pass (nor has the JAX
    package's), so an input that requires grad is refused while autograd
    records: the result would carry no gradient."""
    if torch.is_grad_enabled() and (pos.requires_grad or mass.requires_grad):
        raise RuntimeError(
            "pairwise_gravity: the CUDA kernel has no backward pass and an input "
            "requires grad; pass use_kernel=False (the differentiable plain "
            "version) or detach the inputs")
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
    if pos.data_ptr() % 16 or mass.data_ptr() % 16:
        raise ValueError("kernel needs 16-byte aligned tensors (its cp.async "
                         "copies are 16 bytes)")
    if n >= 2**31:
        raise ValueError(f"{n} bodies out of int32 range")
    return n


def _pairwise_gravity_cuda(pos, mass, g: float, eps: float, plan: Plan | None = None,
                           row0: int = 0, rows: int | None = None):
    """Launch csrc/pairwise_gravity.cu on ``pos``'s device and current
    stream for rows ``[row0, row0 + rows)`` (all by default), by ``plan``
    (default: ``_launch_plan`` for the device and the block)."""
    global LAUNCHES
    n = _check(pos, mass)
    rows = _row_range(n, row0, rows) - row0
    out = pos.new_empty((rows, 3))
    if rows == 0:
        return out
    launcher = getattr(_library(), _LAUNCHERS[pos.dtype])
    if plan is None:
        plan = _launch_plan(n, _build.sm_count(pos.device.index), rows)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        # eps^2 formed in double, as the JAX kernel's Python float is
        err = launcher(pos.data_ptr(), mass.data_ptr(), out.data_ptr(), n, row0, rows,
                       float(g), float(eps) * float(eps), *plan, stream)
    if err != 0:
        raise RuntimeError(f"pairwise_gravity launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def pairwise_gravity(pos, mass, g: float = 6.6743e-11, eps: float = 0.0,
                     use_pallas: bool | None = None, *, use_kernel: bool | None = None,
                     row0: int = 0, rows: int | None = None):
    """All-pairs gravitational acceleration (rows, 3) of bodies ``[row0,
    row0 + rows)`` (all N by default) from all the bodies at ``pos`` (N, 3)
    with masses ``mass`` (N,).

    ``use_kernel=None`` launches the CUDA kernel on a CUDA tensor and runs
    the plain version on a CPU tensor; ``False`` runs the plain version on
    any device; ``True`` launches the kernel and raises on a CPU tensor.
    ``use_pallas`` is the JAX package's name for it; pass one or the
    other."""
    if use_pallas is not None:
        if use_kernel is not None:
            raise TypeError("pairwise_gravity: pass use_pallas or use_kernel, not both")
        use_kernel = use_pallas
    if use_kernel is None:
        use_kernel = pos.device.type != "cpu"
    if not use_kernel:
        return pairwise_gravity_reference(pos, mass, g, eps, row0=row0, rows=rows)
    return _pairwise_gravity_cuda(_aligned(pos), _aligned(mass), g, eps, row0=row0,
                                  rows=rows)


def pairwise_gravity_sharded(pos, mass, mesh, axis: str | None = None,
                             g: float = 6.6743e-11, eps: float = 0.0):
    """All-pairs gravity with the bodies cut over the devices of ``mesh``'s
    ``axis`` (default: its first), as the JAX package's
    ``pairwise_gravity_sharded`` cuts them.  Each device computes a
    contiguous row block (sizes differing by at most one: N need not divide
    the axis) from all N bodies, with the kernel's row-block form on a card
    and the plain version on the CPU.  The JAX package places the row
    blocks and all-gathers them; here the whole input already lies on one
    device, so each other device receives the N positions and masses by
    one peer copy each, all issued before any launch and without waiting,
    and shards on one device share its copy.  Returns the (N, 3)
    accelerations gathered on the axis's first device.  On a mesh across
    processes each rank holds its row block and all-gathers the bodies, as
    the JAX package does (``_pairwise_gravity_ranks``), and the result is a
    ``Sharded`` of the rank's rows."""
    from ..parallel.mesh import gather, on_device, row_blocks, send

    axis = axis or mesh.axis_names[0]
    pos, mass = (x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
                 for x in (pos, mass))
    if mesh.distributed:
        return _pairwise_gravity_ranks(pos, mass, mesh, axis, g, eps)
    devices = mesh.axis_devices(axis)
    # every device's copy is sent before any launch: a peer copy runs on the
    # source's stream, so one issued after a launch there would wait for it
    held = {d: (send(pos, d), send(mass, d))
            for d in dict.fromkeys(devices)}
    outs = []
    for device, (start, stop) in zip(devices, row_blocks(pos.shape[0], len(devices))):
        with on_device(device):
            outs.append(pairwise_gravity(*held[device], g, eps, row0=start,
                                         rows=stop - start))
    return gather(outs, devices[0])


def _pairwise_gravity_ranks(pos, mass, mesh, axis: str, g: float, eps: float):
    """``pairwise_gravity_sharded`` on a mesh across processes, the JAX
    package's recipe: each rank takes its devices' row blocks of the bodies
    it was given, all-gathers every rank's blocks and launches the
    row-block form once a device of its own.  Positions and masses travel
    as one (rows, 4) block, one collective a call.  Returns a ``Sharded``
    (N, 3) of this rank's rows."""
    from ..parallel.mesh import NamedSharding, Sharded, on_device, send

    n = pos.shape[0]
    mine, sizes, comm = mesh.rank_blocks(axis, n)
    home = mine[0][0]
    start, stop = mine[0][1][0], mine[-1][1][1]
    whole = gather_bodies(comm, send(pos[start:stop], home), send(mass[start:stop], home),
                          sizes)
    outs, indices = [], []
    for device, (a, b) in mine:
        with on_device(device):
            outs.append(pairwise_gravity(*(send(x, device) for x in whole), g, eps,
                                         row0=a, rows=b - a))
        indices.append((slice(a, b), slice(None)))
    return Sharded(NamedSharding(mesh, (axis, None)), outs, None, indices=indices,
                   global_shape=(n, 3))


def gather_bodies(comm, pos, mass, sizes):
    """(positions (N, 3), masses (N,)) of every rank's bodies, from this
    rank's ``pos`` and ``mass`` blocks (rank k holds ``sizes[k]``), in
    rank order: one all-gather of (rows, 4) blocks."""
    bodies = torch.cat([pos, mass[:, None].to(pos.dtype)], dim=1)
    whole = comm.all_gather_rows(bodies, sizes)
    return whole[:, :3].contiguous(), whole[:, 3].contiguous()


def _aligned(x):
    """``x`` contiguous and 16-byte aligned, copied only where it is not."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x
