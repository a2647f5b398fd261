"""Spatial algebra on torch tensors, batched over leading axes
(counterpart of ``elodin_tpu/spatial.py``: the six-dof math, ``Quaternion``
the spatial value types with their methods, and ``MRP``).

Array layouts (trailing axis; any number of leading batch axes), the same
as the JAX package's:

* quaternion       -- ``(..., 4)`` as ``[x, y, z, w]`` (scalar last)
* SpatialTransform -- ``(..., 7)`` as ``[qx, qy, qz, qw, x, y, z]``
* SpatialMotion    -- ``(..., 6)`` as ``[wx, wy, wz, vx, vy, vz]``
* SpatialForce     -- ``(..., 6)`` as ``[tx, ty, tz, fx, fy, fz]``
* SpatialInertia   -- ``(..., 7)`` as ``[ixx, iyy, izz, px, py, pz, m]``

Each function keeps the JAX version's order of operations, and uses
``torch.rsqrt`` where it uses ``lax.rsqrt``, so the two agree to f64
round-off.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree

from . import _config

Tensor = torch.Tensor


def _as_f(x, device=None) -> Tensor:
    """``x`` at the policy's float dtype; a tensor stays on its device unless
    ``device`` is given (``Tensor.to`` rather than ``as_tensor``, so this
    also runs under ``torch.func.vmap``)."""
    if isinstance(x, Tensor):
        return x.to(device=device, dtype=_config.default_float())
    return torch.as_tensor(x, dtype=_config.default_float(), device=device)


def _zeros3(device=None) -> Tensor:
    return torch.zeros(3, dtype=_config.default_float(), device=device)


def _device_of(*parts):
    """The device of the first given part that is a tensor; None (the CPU)
    when no part is a tensor.  The constructors build their default parts
    there, so a value built from device tensors stays on the device."""
    for p in parts:
        if isinstance(p, Tensor):
            return p.device
    return None


# ---------------------------------------------------------------------------
# Raw batched math
# ---------------------------------------------------------------------------


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    x = aw * bx + ax * bw + ay * bz - az * by
    y = aw * by - ax * bz + ay * bw + az * bx
    z = aw * bz + ax * by - ay * bx + az * bw
    w = aw * bw - ax * bx - ay * by - az * bz
    return torch.stack([x, y, z, w], dim=-1)


def quat_norm_sq(q: Tensor) -> Tensor:
    return torch.sum(q * q, dim=-1, keepdim=True)


def quat_identity(shape=(), device=None) -> Tensor:
    """The identity quaternion, ``shape + (4,)`` (the JAX package's
    ``quat_identity(shape)``), on ``device``."""
    return _as_f([0.0, 0.0, 0.0, 1.0], device).expand(tuple(shape) + (4,)).contiguous()


def quat_inverse(q: Tensor) -> Tensor:
    """conjugate / |q|^2."""
    return quat_conj(q) / quat_norm_sq(q)


def quat_from_axis_angle(axis, angle) -> Tensor:
    axis = _as_f(axis)
    angle = _as_f(angle, axis.device)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = angle / 2.0
    return _concat_bcast(axis * torch.sin(half)[..., None], torch.cos(half)[..., None])


def quat_from_euler(angles) -> Tensor:
    """Roll/pitch/yaw (XYZ intrinsic) to quaternion."""
    angles = _as_f(angles)
    roll, pitch, yaw = angles.unbind(-1)
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([x, y, z, w], dim=-1)


def quat_integrate_body(q: Tensor, body_delta: Tensor) -> Tensor:
    """q' = normalize(q + q*(delta/2, 0)): a body-frame angular increment."""
    half = body_delta / 2.0
    hq = torch.cat([half, torch.zeros_like(half[..., :1])], dim=-1)
    return quat_normalize(q + quat_mul(q, hq))


def quat_to_mat3(q: Tensor) -> Tensor:
    """Rotation matrix (..., 3, 3) of a unit quaternion."""
    x, y, z, w = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def quat_from_mat3(m) -> Tensor:
    """Rotation matrix -> quaternion, branch-free through copysign."""
    m = _as_f(m)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    w = torch.sqrt(torch.clamp(1.0 + m00 + m11 + m22, min=0.0)) / 2.0
    x = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) / 2.0
    y = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) / 2.0
    z = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) / 2.0
    x = torch.copysign(x, m21 - m12)
    y = torch.copysign(y, m02 - m20)
    z = torch.copysign(z, m10 - m01)
    return torch.stack([x, y, z, w], dim=-1)


def skew(v: Tensor) -> Tensor:
    """Skew-symmetric (cross-product) matrix of a 3-vector; batched."""
    zero = torch.zeros_like(v[..., 0])
    row0 = torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1)
    row1 = torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1)
    row2 = torch.stack([-v[..., 1], v[..., 0], zero], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_normalize(q: Tensor) -> Tensor:
    return q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True))


def quat_conj(q: Tensor) -> Tensor:
    # a negation, not a product with a [-1,-1,-1,1] constant: the same
    # values, with no host-to-device copy per call
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def _quat_sandwich(q: Tensor, v: Tensor) -> Tensor:
    """(q * (v,0) * conj(q)).xyz: rotation without the |q|^2 division."""
    vq = torch.cat([v, torch.zeros_like(v[..., :1])], dim=-1)
    return quat_mul(quat_mul(q, vq), quat_conj(q))[..., :3]


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate 3-vector(s): (q (v,0) q̄) / |q|^2, the general form that also
    holds for a quaternion that is not unit."""
    return _quat_sandwich(q, v) * (1.0 / quat_norm_sq(q))


def stf_add_motion(transform: Tensor, motion: Tensor) -> Tensor:
    """SpatialTransform + SpatialMotion: first-order quaternion update with
    a world-frame angular delta, then renormalize; linear parts add."""
    q = transform[..., :4]
    half = motion[..., :3] / 2.0
    hq = torch.cat([half, torch.zeros_like(half[..., :1])], dim=-1)
    angular = quat_normalize(q + quat_mul(hq, q))
    linear = transform[..., 4:] + motion[..., 3:]
    return torch.cat([angular, linear], dim=-1)


def _quat_homog_mat(q: Tensor):
    """Rows of the homogeneous rotation matrix M with q(0,v)q̄ == M @ v
    (no |q|^2 normalization)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz, ww = x * x, y * y, z * z, w * w
    xy, xz, xw = x * y, x * z, x * w
    yz, yw, zw = y * z, y * w, z * w
    return (
        (ww + xx - yy - zz, 2 * (xy - zw), 2 * (xz + yw)),
        (2 * (xy + zw), ww - xx + yy - zz, 2 * (yz - xw)),
        (2 * (xz - yw), 2 * (yz + xw), ww - xx - yy + zz),
    )


def _mat_vec(m, v: Tensor, transpose: bool = False) -> Tensor:
    v0, v1, v2 = v.unbind(-1)
    if transpose:
        rows = ((m[0][0], m[1][0], m[2][0]), (m[0][1], m[1][1], m[2][1]),
                (m[0][2], m[1][2], m[2][2]))
    else:
        rows = m
    return torch.stack(
        [r[0] * v0 + r[1] * v1 + r[2] * v2 for r in rows], dim=-1
    )


def sixdof_accel(force: Tensor, inertia: Tensor, pos: Tensor) -> Tensor:
    """World-frame spatial acceleration R(q)((R(q)^-1 f) / I), with the
    |q|^2 factors shared so one reciprocal serves the whole chain."""
    q = pos[..., :4]
    m = _quat_homog_mat(q)
    inv_n2 = 1.0 / quat_norm_sq(q)
    body_torque = _mat_vec(m, force[..., :3], transpose=True) * inv_n2
    body_force = _mat_vec(m, force[..., 3:], transpose=True) * inv_n2
    ang = body_torque * (1.0 / inertia[..., :3])
    lin = body_force * (1.0 / inertia[..., 6:7])
    return torch.cat(
        [_mat_vec(m, ang), _mat_vec(m, lin)], dim=-1
    ) * inv_n2


# ---------------------------------------------------------------------------
# Value classes: one tensor each, ``.inner``
# ---------------------------------------------------------------------------


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """``jnp.cross`` over the trailing axis, with its broadcasting of the
    leading axes (``torch.linalg.cross`` needs equal ranks)."""
    return torch.linalg.cross(*torch.broadcast_tensors(a, b))


def _concat_bcast(a: Tensor, b: Tensor) -> Tensor:
    """Concatenate (..., k) and (..., j) with leading-dim broadcasting."""
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = a.expand(batch + (a.shape[-1],))
    b = b.expand(batch + (b.shape[-1],))
    return torch.cat([a, b], dim=-1)


class _SpatialBase:
    """``inner`` is the raw tensor.  Each subclass is a pytree node whose one
    leaf is ``inner``, so ``torch.func.vmap`` and the edge fold's carry
    flatten it as ``jax.tree_util`` does in the JAX package."""

    __slots__ = ("inner",)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        pytree.register_pytree_node(cls, cls._flatten, cls._unflatten)

    def _flatten(self):
        return [self.inner], None

    @classmethod
    def _unflatten(cls, children, _context):
        return cls.from_array(list(children)[0])

    @classmethod
    def from_array(cls, arr):
        obj = object.__new__(cls)
        obj.inner = arr if isinstance(arr, Tensor) else torch.as_tensor(arr)
        return obj

    def asarray(self) -> Tensor:
        return self.inner

    def __repr__(self):
        return f"{type(self).__name__}({self.inner})"


class Quaternion(_SpatialBase):
    """[x, y, z, w] quaternion."""

    def __init__(self, arr):
        self.inner = _as_f(arr)

    @staticmethod
    def identity(device=None) -> "Quaternion":
        return Quaternion.from_array(quat_identity(device=device))

    @staticmethod
    def from_axis_angle(axis, angle) -> "Quaternion":
        return Quaternion.from_array(quat_from_axis_angle(axis, angle))

    @staticmethod
    def from_euler(angles) -> "Quaternion":
        return Quaternion.from_array(quat_from_euler(angles))

    @staticmethod
    def from_rot_mat(mat) -> "Quaternion":
        return Quaternion.from_array(quat_from_mat3(mat))

    def vector(self) -> Tensor:
        return self.inner

    def normalize(self) -> "Quaternion":
        return Quaternion.from_array(quat_normalize(self.inner))

    def inverse(self) -> "Quaternion":
        return Quaternion.from_array(quat_inverse(self.inner))

    def conjugate(self) -> "Quaternion":
        return Quaternion.from_array(quat_conj(self.inner))

    def integrate_body(self, body_delta) -> "Quaternion":
        return Quaternion.from_array(quat_integrate_body(self.inner, _as_f(body_delta)))

    def angular_distance(self, other: "Quaternion") -> Tensor:
        dot = torch.sum(self.inner * other.inner, dim=-1)
        # |dot| of two normalised quaternions can round above 1, where
        # arccos is NaN
        return 2.0 * torch.arccos(torch.clamp(torch.abs(dot), 0.0, 1.0))

    def to_mat3(self) -> Tensor:
        return quat_to_mat3(self.inner)

    def __mul__(self, rhs: "Quaternion") -> "Quaternion":
        return Quaternion.from_array(quat_mul(self.inner, rhs.inner))

    def __add__(self, rhs: "Quaternion") -> "Quaternion":
        return Quaternion.from_array(self.inner + rhs.inner)

    def __matmul__(self, rhs):
        """Rotate a transform (composing the attitude), a motion or force
        (both halves) or a 3-vector."""
        q = self.inner
        if isinstance(rhs, SpatialTransform):
            return SpatialTransform.from_array(torch.cat(
                [quat_mul(q, rhs.inner[..., :4]), quat_rotate(q, rhs.inner[..., 4:])],
                dim=-1))
        if isinstance(rhs, (SpatialMotion, SpatialForce)):
            return type(rhs).from_array(torch.cat(
                [quat_rotate(q, rhs.inner[..., :3]), quat_rotate(q, rhs.inner[..., 3:])],
                dim=-1))
        return quat_rotate(q, rhs if isinstance(rhs, Tensor) else
                           torch.as_tensor(rhs, dtype=q.dtype, device=q.device))


class SpatialTransform(_SpatialBase):
    """[qx,qy,qz,qw, x,y,z] rigid transform; ``angular`` may be a
    ``Quaternion`` or its array."""

    def __init__(self, arr=None, angular=None, linear=None):
        if arr is not None:
            if angular is not None or linear is not None:
                raise ValueError("Cannot specify both array and linear/angular")
            self.inner = _as_f(arr)
            return
        if isinstance(angular, Quaternion):
            angular = angular.inner
        device = _device_of(angular, linear)
        q = quat_identity(device=device) if angular is None else _as_f(angular, device)
        lin = _zeros3(device) if linear is None else _as_f(linear, device)
        self.inner = _concat_bcast(q, lin)

    def linear(self) -> Tensor:
        return self.inner[..., 4:]

    def angular(self) -> Quaternion:
        return Quaternion.from_array(self.inner[..., :4])

    @staticmethod
    def from_axis_angle(axis, angle) -> "SpatialTransform":
        return SpatialTransform(angular=Quaternion.from_axis_angle(axis, angle))

    @staticmethod
    def zero() -> "SpatialTransform":
        return SpatialTransform()

    def __add__(self, rhs):
        if isinstance(rhs, SpatialTransform):
            return SpatialTransform.from_array(self.inner + rhs.inner)
        if isinstance(rhs, SpatialMotion):
            return SpatialTransform.from_array(stf_add_motion(self.inner, rhs.inner))
        raise TypeError("Unsupported type for addition")

    def __mul__(self, rhs: "SpatialTransform") -> "SpatialTransform":
        """Transform composition."""
        q = self.inner[..., :4]
        angular = quat_mul(q, rhs.inner[..., :4])
        linear = self.inner[..., 4:] + quat_rotate(q, rhs.inner[..., 4:])
        return SpatialTransform.from_array(torch.cat([angular, linear], dim=-1))


class SpatialMotion(_SpatialBase):
    """[wx,wy,wz, vx,vy,vz] velocity twist."""

    def __init__(self, angular=None, linear=None):
        device = _device_of(angular, linear)
        ang = _zeros3(device) if angular is None else _as_f(angular, device)
        lin = _zeros3(device) if linear is None else _as_f(linear, device)
        self.inner = _concat_bcast(ang, lin)

    def linear(self) -> Tensor:
        return self.inner[..., 3:]

    def angular(self) -> Tensor:
        return self.inner[..., :3]

    def __add__(self, rhs: "SpatialMotion") -> "SpatialMotion":
        return SpatialMotion.from_array(self.inner + rhs.inner)

    def __sub__(self, rhs: "SpatialMotion") -> "SpatialMotion":
        return SpatialMotion.from_array(self.inner - rhs.inner)

    def __mul__(self, scale) -> "SpatialMotion":
        return SpatialMotion.from_array(self.inner * scale)

    __rmul__ = __mul__

    def cross(self, other: "SpatialMotion") -> "SpatialMotion":
        """Spatial-motion cross product."""
        w, v = self.inner[..., :3], self.inner[..., 3:]
        ow, ov = other.inner[..., :3], other.inner[..., 3:]
        ang = _cross(w, ow)
        lin = _cross(w, ov) + _cross(v, ow)
        return SpatialMotion.from_array(torch.cat([ang, lin], dim=-1))

    def cross_dual(self, other: "SpatialForce") -> "SpatialForce":
        """Motion x* force."""
        w, v = self.inner[..., :3], self.inner[..., 3:]
        t, f = other.inner[..., :3], other.inner[..., 3:]
        force = _cross(w, t) + _cross(v, f)
        torque = _cross(w, f)
        return SpatialForce.from_array(torch.cat([torque, force], dim=-1))

    def offset(self, pos: "SpatialTransform") -> "SpatialMotion":
        """Re-express through a transform: rotate both halves by its
        attitude, then add the rotated angular part crossed with its
        translation to the linear part."""
        q = pos.inner[..., :4]
        ang = quat_rotate(q, self.inner[..., :3])
        vel = quat_rotate(q, self.inner[..., 3:]) + _cross(ang, pos.inner[..., 4:])
        return SpatialMotion.from_array(torch.cat([ang, vel], dim=-1))


class SpatialForce(_SpatialBase):
    """[tx,ty,tz, fx,fy,fz] wrench."""

    def __init__(self, arr=None, torque=None, linear=None):
        if arr is not None:
            if torque is not None or linear is not None:
                raise ValueError("Cannot specify both array and linear/torque")
            self.inner = _as_f(arr)
            return
        device = _device_of(torque, linear)
        t = _zeros3(device) if torque is None else _as_f(torque, device)
        f = _zeros3(device) if linear is None else _as_f(linear, device)
        self.inner = _concat_bcast(t, f)

    def force(self) -> Tensor:
        return self.inner[..., 3:]

    linear = force

    def torque(self) -> Tensor:
        return self.inner[..., :3]

    def __add__(self, rhs: "SpatialForce") -> "SpatialForce":
        return SpatialForce.from_array(self.inner + rhs.inner)

    def __sub__(self, rhs: "SpatialForce") -> "SpatialForce":
        return SpatialForce.from_array(self.inner - rhs.inner)

    def __mul__(self, scale) -> "SpatialForce":
        return SpatialForce.from_array(self.inner * scale)

    __rmul__ = __mul__

    def __truediv__(self, rhs: "SpatialInertia") -> SpatialMotion:
        """Force / inertia -> acceleration."""
        accel = self.force() / rhs.mass()[..., None]
        ang = self.torque() / rhs.inertia_diag()
        return SpatialMotion.from_array(torch.cat([ang, accel], dim=-1))


class SpatialInertia(_SpatialBase):
    """[ixx,iyy,izz, px,py,pz, m] diagonalized inertia."""

    def __init__(self, mass, inertia=None, momentum=None):
        device = _device_of(mass, inertia, momentum)
        m = _as_f(mass, device)
        i = (m[..., None] * torch.ones(3, dtype=m.dtype, device=m.device)
             if inertia is None else _as_f(inertia, device))
        p = (torch.zeros(3, dtype=m.dtype, device=m.device)
             if momentum is None else _as_f(momentum, device))
        batch = torch.broadcast_shapes(m.shape, i.shape[:-1], p.shape[:-1])
        i = i.expand(batch + (3,))
        p = p.expand(batch + (3,))
        m = m.expand(batch)[..., None]
        self.inner = torch.cat([i, p, m], dim=-1)

    def mass(self) -> Tensor:
        return self.inner[..., 6]

    def inertia_diag(self) -> Tensor:
        return self.inner[..., :3]

    def momentum(self) -> Tensor:
        return self.inner[..., 3:6]

    def __mul__(self, rhs: SpatialMotion) -> SpatialForce:
        """Inertia * motion -> momentum wrench."""
        force = self.mass()[..., None] * rhs.linear() - torch.linalg.cross(
            self.momentum(), rhs.angular())
        torque = self.inertia_diag() * rhs.angular() + torch.linalg.cross(
            self.momentum(), rhs.linear())
        return SpatialForce.from_array(torch.cat([torque, force], dim=-1))


# Default component descriptors, the JAX package's: an
# ``Annotated[Quaternion, Component("name")]`` without a type takes its
# type from here.
from .component import Component as _Component, ComponentType as _ComponentType  # noqa: E402
from .component import PrimitiveType as _PrimitiveType  # noqa: E402

for _cls, _name, _ty in (
    (Quaternion, "quaternion_f64", _ComponentType.Quaternion),
    (SpatialTransform, "spatial_transform_f64", _ComponentType.SpatialPosF64),
    (SpatialMotion, "spatial_motion_f64", _ComponentType.SpatialMotionF64),
    (SpatialForce, "spatial_force_f64", _ComponentType.SpatialMotionF64),
    (SpatialInertia, "spatial_inertia_f64", _ComponentType.SpatialPosF64),
):
    _cls.metadata = _Component(_name, _ty)
    _cls.__metadata__ = (_cls.metadata,)
del _cls, _name, _ty


class MRP(_SpatialBase):
    """Modified Rodrigues Parameters, ``(..., 3)``."""

    def __init__(self, arr=None):
        self.inner = _zeros3() if arr is None else _as_f(arr)

    @staticmethod
    def from_quaternion(q) -> "MRP":
        """The quaternion's vector part over ``w + 1`` (no switch to the
        shorter rotation; singular at ``w = -1``)."""
        if isinstance(q, Quaternion):
            q = q.inner
        qv = q if isinstance(q, Tensor) else _as_f(q)
        return MRP.from_array(qv[..., :3] / (qv[..., 3:4] + 1.0))

    def to_quaternion(self) -> Quaternion:
        m = self.inner
        mag2 = torch.sum(m * m, dim=-1, keepdim=True)
        q = torch.cat([2.0 * m, 1.0 - mag2], dim=-1) / (mag2 + 1.0)
        return Quaternion.from_array(q)

    def __add__(self, rhs: "MRP") -> "MRP":
        return MRP.from_array(self.inner + rhs.inner)


MRP.metadata = _Component("mrp_f64", _ComponentType(_PrimitiveType.F64, (3,)))
MRP.__metadata__ = (MRP.metadata,)
SpatialTransform.mrp = lambda self: MRP.from_quaternion(self.angular())
Quaternion.mrp = lambda self: MRP.from_quaternion(self)
