"""Op-coverage probe in torch (counterpart of ``examples/stablehlo/sim.py``):
seven systems, each over one category of ops, in one tick.

  1. math_step     unary and binary transcendental math
  2. sort_step     sort and a stable argsort
  3. shape_step    broadcast, concatenate, slice, reshape, transpose, gather
  4. control_step  a halving loop and a three-way switch
  5. bitwise_step  xor, or, and, shifts and not on a u32 column
  6. linalg_step   matrix products and reductions
  7. convert_step  dtype conversions, select, compare, clamp, pad

Where torch differs from JAX:

* torch has no ``cbrt``: it is ``copysign(|x| ** (1/3), x)``;
* the ``lax.while_loop`` that halves ``x = |s| + 2`` until ``x <= 1`` is a
  closed form: with ``x = m * 2**e``, ``m`` in [0.5, 1) (``torch.frexp``),
  the loop ends at ``m``, or at 1 when ``m == 0.5``.  Halving is exact, so
  this is the loop's value, with no host sync and no data-dependent trip
  count;
* ``lax.switch`` is a chain of ``torch.where``;
* the u32 column ``hlo_bits`` is held as int64 in [0, 2**32)
  (``interop``), so a left shift is masked back to 32 bits and ``~y`` is
  ``y ^ 0xFFFFFFFF``;
* ``convert_step`` sums ten f32 values, whose reduction order may differ
  from XLA's by an f32 ulp.

(This module defines ``@el.map`` functions, so it must not use postponed
annotations.)
"""

import typing as ty

import numpy as np
import torch

import elodin_tpu_torch as el

SIMULATION_RATE = 120.0
_MASK = 0xFFFF_FFFF

T = torch.Tensor

VecF = ty.Annotated[T, el.Component("hlo_vec", el.ComponentType(el.PrimitiveType.F64, (8,)))]
MatF = ty.Annotated[T, el.Component("hlo_mat", el.ComponentType(el.PrimitiveType.F64, (3, 3)))]
BitsU = ty.Annotated[T, el.Component("hlo_bits", el.ComponentType(el.PrimitiveType.U32, (4,)))]
Scalar = ty.Annotated[T, el.Component("hlo_scalar", el.ComponentType(el.PrimitiveType.F64, ()))]


@el.dataclass
class Probe(el.Archetype):
    hlo_vec: VecF
    hlo_mat: MatF
    hlo_bits: BitsU
    hlo_scalar: Scalar


def _cbrt(x: T) -> T:
    return torch.copysign(torch.abs(x) ** (1.0 / 3.0), x)


@el.map
def math_step(v: VecF) -> VecF:
    x = torch.clamp(v, -0.9, 0.9)
    y = (
        torch.sin(x) + torch.cos(x) + torch.tanh(x) + torch.arcsin(x)
        + torch.arctan2(x, 1.0 + x * x) + torch.sinh(x) + torch.expm1(x)
        + torch.log1p(torch.abs(x)) + _cbrt(x) + torch.special.erfc(x)
    )
    return y / 10.0


@el.map
def sort_step(v: VecF) -> VecF:
    s = torch.sort(v, stable=True).values
    order = torch.argsort(-v, stable=True)
    return s + v[order] * 1e-3


@el.map
def shape_step(v: VecF, m: MatF) -> MatF:
    col = v[:3].reshape(3, 1)
    b = col.expand(3, 3)
    cat = torch.cat([m[:, :2], b[:, :1]], dim=1)
    t = cat.T
    rev = torch.flip(t, dims=(0,))
    g = rev[torch.tensor([2, 0, 1], device=v.device)]
    # lax.dynamic_slice of the whole matrix, then row 1 replaced by v[3]
    row = torch.ones((1, 3), dtype=v.dtype, device=v.device) * v[3]
    return torch.cat([g[:1], row, g[2:]], dim=0) * 0.5


@el.map
def control_step(s: Scalar) -> Scalar:
    # lax.while_loop(x > 1, x * 0.5) from x = |s| + 2 >= 2, in closed form
    mantissa, _ = torch.frexp(torch.abs(s) + 2.0)
    shrunk = torch.where(mantissa == 0.5, 1.0, mantissa)
    branch = torch.abs(s).to(torch.int32) % 3
    return torch.where(branch == 0, shrunk + 1.0,
                       torch.where(branch == 1, shrunk * 2.0, -shrunk))


@el.map
def bitwise_step(b: BitsU) -> BitsU:
    x = b ^ 0xDEAD_BEEF
    y = (x | 0x0F0F_0F0F) & 0x7FFF_FFFF
    return (((y << 1) & _MASK) >> 1) ^ ((y ^ _MASK) & 0xFF)


@el.map
def linalg_step(m: MatF, v: VecF) -> VecF:
    mv = m @ v[:3]
    gram = m.T @ m
    red = torch.stack([
        torch.sum(mv), torch.max(gram), torch.min(gram),
        torch.prod(torch.diagonal(gram) + 1.0),
        torch.trace(gram), torch.sum(gram ** 2) ** 0.5,
        torch.mean(m), torch.var(m, correction=0),
    ])
    return torch.tanh(red)


@el.map
def convert_step(v: VecF, s: Scalar) -> Scalar:
    as_f32 = v.to(torch.float32)
    as_i32 = torch.clamp(as_f32 * 10, -100, 100).to(torch.int32)
    sel = torch.where(as_i32 > 0, as_f32, -as_f32)
    cmp = torch.sum((v > 0.0).to(torch.float64))
    padded = torch.nn.functional.pad(sel, (1, 1), value=1.0)
    return torch.clamp(torch.sum(padded).to(torch.float64) + cmp + s * 0.0, -1e6, 1e6)


def world() -> el.World:
    w = el.World()
    w.spawn(
        Probe(
            hlo_vec=np.linspace(-1.0, 1.0, 8),
            hlo_mat=np.eye(3) + 0.1,
            hlo_bits=np.arange(4, dtype=np.uint32),
            hlo_scalar=np.float64(0.5),
        ),
        name="probe",
    )
    return w


def system() -> el.System:
    return (
        math_step | sort_step | shape_step | control_step
        | bitwise_step | linalg_step | convert_step
    )


def build_world() -> el.World:
    return world()


def build_system() -> el.System:
    return system()
