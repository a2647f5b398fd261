"""Whole-rollout batched 6-dof RK4 in one kernel launch (counterpart of
``elodin_tpu/ops/sixdof_kernel.py``).

``sixdof_rollout`` runs ``ticks`` RK4 ticks of the flagship model
(``models/sixdof_batch``) for N independent bodies.  On a CUDA tensor it
launches the hand-written kernel ``csrc/sixdof_rk4.cu`` (one thread per
body, state in registers, the tick loop inside the kernel) in blocks of
the size ``_launch_plan`` picks from N, or raises; on a CPU tensor it
runs ``_rollout_reference``, the plain PyTorch version of the same
per-channel algebra with a Python tick loop.

Layout: channel-major ``(13, N)`` state (qx..qw, px..pz, wx..wz, vx..vz)
and ``(4, N)`` parameters (1/Ixx, 1/Iyy, 1/Izz, 1/m), contiguous, with no
padding.  The effector constants come from ``models/sixdof_batch``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..models import sixdof_batch as model
from ..tick_metrics import span
from . import _build

N_STATE = 13  # qx qy qz qw | px py pz | wx wy wz | vx vy vz
N_PARAM = 4  # 1/ixx 1/iyy 1/izz 1/m

# kernel launches since import (or since a caller reset it to 0)
LAUNCHES = 0

_LAUNCHERS = {torch.float32: "sixdof_rk4_f32", torch.float64: "sixdof_rk4_f64"}

# the wrapper's spans (tick_metrics.span)
ROLLOUT, PACK, LAUNCH, UNPACK = "rollout", "rollout.pack", "rollout.launch", "rollout.unpack"


def pack_state(pos, vel, inertia, *, device, dtype):
    """(N,7) / (N,6) / (N,7) component columns -> ((13, N) state,
    (4, N) params), contiguous tensors of ``dtype`` on ``device``."""
    with span(PACK):
        pos, vel, inertia = (
            (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x)))
            .to(device=device, dtype=dtype)
            for x in (pos, vel, inertia))
        n = pos.shape[0]
        if pos.shape != (n, 7) or vel.shape != (n, 6) or inertia.shape != (n, 7):
            raise ValueError(
                f"expected (N,7)/(N,6)/(N,7) columns, got {tuple(pos.shape)}/"
                f"{tuple(vel.shape)}/{tuple(inertia.shape)}")
        u = torch.cat([pos.T, vel.T]).contiguous()
        par = torch.cat([1.0 / inertia[:, 0:3].T, 1.0 / inertia[:, 6:7].T]).contiguous()
        return u, par


def unpack_state(u):
    """(13, N) -> (pos (N,7), vel (N,6)) contiguous tensors."""
    with span(UNPACK):
        return u[0:7].T.contiguous(), u[7:13].T.contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _accel(q, p, v, par):
    """world_accel of the effector stack (gravity, body thrust and torque,
    drag) followed by sixdof_accel, per channel.  Tuples of (N,) tensors;
    returns (aw, av) tuples."""
    qx, qy, qz, qw = q
    px, py, pz = p
    vx, vy, vz = v
    inv_ixx, inv_iyy, inv_izz, inv_m = par
    m = 1.0 / inv_m

    xx, yy, zz, ww = qx * qx, qy * qy, qz * qz, qw * qw
    xy, xz, xw = qx * qy, qx * qz, qx * qw
    yz, yw, zw = qy * qz, qy * qw, qz * qw
    m00, m01, m02 = ww + xx - yy - zz, 2 * (xy - zw), 2 * (xz + yw)
    m10, m11, m12 = 2 * (xy + zw), ww - xx + yy - zz, 2 * (yz - xw)
    m20, m21, m22 = 2 * (xz - yw), 2 * (yz + xw), ww - xx - yy + zz
    inv_n2 = 1.0 / (xx + yy + zz + ww)

    inv_rn = torch.rsqrt(px * px + py * py + pz * pz)
    g = (-model.MU) * m * (inv_rn * inv_rn * inv_rn)
    sx = model.THRUST * m * inv_n2
    sz = model.TORQUE * m * inv_n2
    d = (-model.DRAG) * torch.sqrt(vx * vx + vy * vy + vz * vz)

    fx = g * px + m00 * sx + d * vx
    fy = g * py + m10 * sx + d * vy
    fz = g * pz + m20 * sx + d * vz
    taux, tauy, tauz = m02 * sz, m12 * sz, m22 * sz

    btx = (m00 * taux + m10 * tauy + m20 * tauz) * inv_n2
    bty = (m01 * taux + m11 * tauy + m21 * tauz) * inv_n2
    btz = (m02 * taux + m12 * tauy + m22 * tauz) * inv_n2
    angx, angy, angz = btx * inv_ixx, bty * inv_iyy, btz * inv_izz
    awx = (m00 * angx + m01 * angy + m02 * angz) * inv_n2
    awy = (m10 * angx + m11 * angy + m12 * angz) * inv_n2
    awz = (m20 * angx + m21 * angy + m22 * angz) * inv_n2

    bfx = (m00 * fx + m10 * fy + m20 * fz) * inv_n2
    bfy = (m01 * fx + m11 * fy + m21 * fz) * inv_n2
    bfz = (m02 * fx + m12 * fy + m22 * fz) * inv_n2
    linx, liny, linz = bfx * inv_m, bfy * inv_m, bfz * inv_m
    avx = (m00 * linx + m01 * liny + m02 * linz) * inv_n2
    avy = (m10 * linx + m11 * liny + m12 * linz) * inv_n2
    avz = (m20 * linx + m21 * liny + m22 * linz) * inv_n2
    return (awx, awy, awz), (avx, avy, avz)


def _quat_add_norm(q, hx, hy, hz):
    """normalize(q + (h, 0) * q): stf_add_motion's attitude update with
    h = angular_delta / 2."""
    qx, qy, qz, qw = q
    nx = qx + (hx * qw + hy * qz - hz * qy)
    ny = qy + (-hx * qz + hy * qw + hz * qx)
    nz = qz + (hx * qy - hy * qx + hz * qw)
    nw = qw + (-hx * qx - hy * qy - hz * qz)
    inv_n = torch.rsqrt(nx * nx + ny * ny + nz * nz + nw * nw)
    return nx * inv_n, ny * inv_n, nz * inv_n, nw * inv_n


def _rk4_tick(dt, state, par):
    """One tick in six_dof._rk4's stage sequence: for factor in
    (0, 1/2, 1/2, 1): u := u0 (+) dt*factor*du_prev; k_i := (vel, accel);
    then u := u0 (+) (dt/6)(k1 + 2k2 + 2k3 + k4)."""
    q0, p0, w0, v0 = state[0:4], state[4:7], state[7:10], state[10:13]

    def set_u(f, dv_w, dv_v, da_w, da_v):
        h = 0.5 * f
        q = _quat_add_norm(q0, h * dv_w[0], h * dv_w[1], h * dv_w[2])
        p = tuple(p0[i] + f * dv_v[i] for i in range(3))
        w = tuple(w0[i] + f * da_w[i] for i in range(3))
        v = tuple(v0[i] + f * da_v[i] for i in range(3))
        return q, p, w, v

    inv_n = torch.rsqrt(
        q0[0] * q0[0] + q0[1] * q0[1] + q0[2] * q0[2] + q0[3] * q0[3])
    qn = tuple(c * inv_n for c in q0)
    k1_w, k1_v = w0, v0
    k1_aw, k1_av = _accel(qn, p0, v0, par)

    q, p, w, v = set_u(0.5 * dt, k1_w, k1_v, k1_aw, k1_av)
    k2_w, k2_v = w, v
    k2_aw, k2_av = _accel(q, p, v, par)

    q, p, w, v = set_u(0.5 * dt, k2_w, k2_v, k2_aw, k2_av)
    k3_w, k3_v = w, v
    k3_aw, k3_av = _accel(q, p, v, par)

    q, p, w, v = set_u(dt, k3_w, k3_v, k3_aw, k3_av)
    k4_w, k4_v = w, v
    k4_aw, k4_av = _accel(q, p, v, par)

    sixth = 1.0 / 6.0

    def avg(a, b, c, d):
        return tuple((a[i] + 2 * b[i] + 2 * c[i] + d[i]) * sixth
                     for i in range(3))

    dv_w, dv_v = avg(k1_w, k2_w, k3_w, k4_w), avg(k1_v, k2_v, k3_v, k4_v)
    da_w, da_v = avg(k1_aw, k2_aw, k3_aw, k4_aw), avg(k1_av, k2_av, k3_av, k4_av)
    q, p, w, v = set_u(dt, dv_w, dv_v, da_w, da_v)
    return q + p + w + v


def _rollout_reference(u, par, dt: float, ticks: int):
    """Plain PyTorch version of the kernel: (13, N) -> (13, N)."""
    state = tuple(u.unbind(0))
    params = tuple(par.unbind(0))
    for _ in range(ticks):
        state = _rk4_tick(dt, state, params)
    return torch.stack(state)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


MIN_THREADS, MAX_THREADS = 32, 256  # the launcher's limits on threads a block


@functools.cache
def _launch_plan(n: int, sm_count: int) -> int:
    """Threads a block of the kernel (one thread a body) for ``n >= 1``
    bodies on a card of ``sm_count`` SMs, as ``scripts/sixdof_plan_sweep.py``
    measured it.  Cached: a caller asks for the same N every call.

    128 where that still gives every SM a block, else the largest multiple
    of 32 that does (or 32), so a narrow N spreads over the SMs.  Every
    body is one thread whatever the block size, so the plan changes no bit
    of the result; measured, it moves the time by a few % at most between
    32 and 128 threads (a block of 256 left SMs idle at 8192 bodies)."""
    threads = 128
    while threads > MIN_THREADS and -(-n // threads) < sm_count:
        threads -= 32
    return threads


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("sixdof_rk4")
    for name in _LAUNCHERS.values():
        fn = getattr(lib, name)
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # u par out
            ctypes.c_int, ctypes.c_int,  # n nticks
            ctypes.c_double, ctypes.c_double, ctypes.c_double,  # dt mu thrust
            ctypes.c_double, ctypes.c_double,  # torque drag
            ctypes.c_int,  # threads a block (the plan)
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Build (or load) the kernel's library now rather than at first use."""
    _library()


def _rollout_cuda(u, par, dt: float, ticks: int, threads: int | None = None):
    """Launch csrc/sixdof_rk4.cu on ``u``'s device and current stream in
    blocks of ``threads`` (``_launch_plan``'s by default; the launcher
    refuses a block size outside its limits, and this raises).  The kernel has no backward pass
    (nor has the JAX package's), so an input that requires grad is refused
    while autograd records: the result would carry no gradient."""
    global LAUNCHES
    if torch.is_grad_enabled() and (u.requires_grad or par.requires_grad):
        raise RuntimeError(
            "sixdof_rollout: the CUDA kernel has no backward pass and an input "
            "requires grad; run sixdof_rollout_reference (differentiable) or "
            "detach the inputs")
    if u.device.type != "cuda" or par.device != u.device:
        raise ValueError(f"kernel needs CUDA tensors on one device, got "
                         f"{u.device} and {par.device}")
    if u.dtype not in _LAUNCHERS or par.dtype != u.dtype:
        raise TypeError(f"kernel takes float32 or float64, got {u.dtype} "
                        f"and {par.dtype}")
    n = u.shape[1] if u.dim() == 2 else -1
    if u.shape != (N_STATE, n) or par.shape != (N_PARAM, n):
        raise ValueError(f"expected (13, N) and (4, N), got {tuple(u.shape)} "
                         f"and {tuple(par.shape)}")
    if not (u.is_contiguous() and par.is_contiguous()):
        raise ValueError("kernel needs contiguous tensors")
    if not 0 <= ticks < 2**31 or n >= 2**31:
        raise ValueError(f"ticks {ticks} or bodies {n} out of int32 range")
    out = torch.empty_like(u)
    if n == 0:
        return out
    launcher = getattr(_library(), _LAUNCHERS[u.dtype])
    with torch.cuda.device(u.device):
        if threads is None:
            threads = _launch_plan(n, _build.sm_count(torch.cuda.current_device()))
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = launcher(u.data_ptr(), par.data_ptr(), out.data_ptr(), n,
                       int(ticks), float(dt), model.MU, model.THRUST,
                       model.TORQUE, model.DRAG, int(threads), stream)
    if err != 0:
        raise RuntimeError(f"sixdof_rk4 launch failed: cudaError {err} ({threads} threads a block)")
    LAUNCHES += 1
    return out


def _rollout(u, par, dt: float, ticks: int):
    if u.device.type == "cpu":
        return _rollout_reference(u, par, dt, ticks)
    with span(LAUNCH):
        return _rollout_cuda(u, par, dt, ticks)


def sixdof_rollout(pos, vel, inertia, dt: float, ticks: int, *, device,
                   dtype):
    """Run ``ticks`` RK4 ticks of the flagship batched 6-dof model in one
    kernel launch.  Returns (pos (N,7), vel (N,6)) tensors on ``device``.

    On a CUDA device this launches the CUDA kernel (or raises; it refuses
    an input that requires grad); on the CPU it runs the plain PyTorch
    version, which is differentiable."""
    with span(ROLLOUT):
        u, par = pack_state(pos, vel, inertia, device=device, dtype=dtype)
        return unpack_state(_rollout(u, par, dt, ticks))


def sixdof_rollout_reference(pos, vel, inertia, dt: float, ticks: int, *,
                             device, dtype):
    """``sixdof_rollout`` through the plain PyTorch version, on any
    device."""
    u, par = pack_state(pos, vel, inertia, device=device, dtype=dtype)
    return unpack_state(_rollout_reference(u, par, dt, int(ticks)))


def sixdof_rollout_sharded(pos, vel, inertia, dt: float, ticks: int, mesh,
                           axis: str = "dp", *, dtype):
    """``sixdof_rollout`` with the bodies cut over the devices of
    ``mesh``'s ``axis`` (counterpart of the JAX package's
    ``sixdof_rollout_sharded``).  Bodies are independent, so no collective
    joins the shards: the (13, N) state is cut into contiguous blocks whose
    sizes differ by at most one (N need not divide the axis; nothing is
    padded), every block is sent to its device, then every shard's launch is
    issued on its device's current stream, before anything waits.  The
    results are gathered onto the axis's first device.  Returns (pos (N,7),
    vel (N,6)) tensors there, bitwise equal to ``sixdof_rollout`` on one
    device: each body's arithmetic does not depend on its neighbours.

    On a CUDA device each non-empty shard launches the kernel (or raises);
    on the CPU each shard runs the plain version.  On a mesh across
    processes each rank runs its own devices' blocks and returns (pos,
    vel) as ``Sharded`` columns of its rows."""
    from ..parallel.mesh import NamedSharding, Sharded, gather, on_device, row_blocks, send

    if mesh.distributed:
        # each rank launches once a device of its own, on its own block
        mine, _, _ = mesh.rank_blocks(axis, np.shape(pos)[0])
        start, stop = mine[0][1][0], mine[-1][1][1]
        u, par = pack_state(*(x[start:stop] for x in (pos, vel, inertia)),
                            device=mine[0][0], dtype=dtype)
        outs = []
        for device, (a, b) in mine:
            with on_device(device):
                outs.append(unpack_state(_rollout(
                    send(u[:, a - start:b - start], device).contiguous(),
                    send(par[:, a - start:b - start], device).contiguous(), dt, int(ticks))))
        indices = [(slice(a, b), slice(None)) for _, (a, b) in mine]
        return tuple(Sharded(NamedSharding(mesh, (axis, None)), [o[k] for o in outs], None,
                             indices=indices, global_shape=(np.shape(pos)[0], width))
                     for k, width in enumerate((7, 6)))
    devices = mesh.axis_devices(axis)
    u, par = pack_state(pos, vel, inertia, device=devices[0], dtype=dtype)
    # every shard's slice is sent before any launch: a peer copy runs on the
    # first device's stream, so one issued after its launch would wait for it
    held = [(send(u[:, a:b], d).contiguous(), send(par[:, a:b], d).contiguous())
            for d, (a, b) in zip(devices, row_blocks(u.shape[1], len(devices)))]
    outs = []
    for device, (u_k, par_k) in zip(devices, held):
        with on_device(device):
            outs.append(_rollout(u_k, par_k, dt, int(ticks)))
    return unpack_state(gather(outs, devices[0], dim=1))
