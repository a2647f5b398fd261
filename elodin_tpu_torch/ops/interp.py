"""Piecewise-linear table lookup with ``jnp.interp``'s semantics (the
JAX package's falcon9 model calls ``jnp.interp``).

The JAX package's ``ops/interp.py`` rewrote the lookup without gathers
for the TPU; the port keeps ``jnp.interp``'s own form instead: the
segment index is a count of knots at or below ``x`` (``searchsorted``
with ``side='right'``), the values beyond either end are clamped to the
end values, and at a duplicate knot (a step) the value past the step
applies from the knot on.  Written with elementwise ops and an index
gather, so it runs under ``torch.func.vmap``.

``lerp_nd`` is the multilinear lookup of ``map_coordinates(order=1,
mode="nearest")`` at one point of a small grid, in the JAX package's form:
a contraction of per-axis hat weights against the table.
"""

from __future__ import annotations

import torch


def interp(x, xp, fp) -> torch.Tensor:
    """``fp`` at ``x`` by linear interpolation over sorted knots ``xp``;
    ``x`` may have any shape, ``xp`` and ``fp`` are 1-d of one length."""
    x = torch.as_tensor(x)
    xp = torch.as_tensor(xp, dtype=x.dtype, device=x.device)
    fp = torch.as_tensor(fp, dtype=x.dtype, device=x.device)
    if xp.dim() != 1 or xp.shape != fp.shape:
        raise ValueError("xp and fp must be one-dimensional arrays of equal size")
    n = xp.shape[0]
    i = torch.clamp((xp <= x[..., None]).sum(-1), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # np.spacing(eps), jnp.interp's threshold for a zero-width segment
    dx0 = torch.abs(dx) <= torch.finfo(x.dtype).eps ** 2
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _hat_weights(coord, n: int, dtype) -> torch.Tensor:
    """Linear-interpolation weights over ``n`` grid indices for the
    fractional index ``coord``, clamped to the grid (``map_coordinates``
    with ``order=1, mode='nearest'``)."""
    coord = (coord.to(dtype) if isinstance(coord, torch.Tensor)
             else torch.tensor(coord, dtype=dtype))
    c = torch.clamp(coord, 0.0, n - 1.0)
    idx = torch.arange(n, dtype=dtype, device=c.device)
    return torch.clamp(1.0 - torch.abs(c - idx), min=0.0)


def lerp_nd(table, coords) -> torch.Tensor:
    """Multilinear lookup of ``table`` (shape ``dims``, on the device of
    the coordinates) at one fractional index per axis (``coords``,
    scalars), clamped to the grid: each axis's hat weights contract the
    table's leading axis in turn.  A batch axis may come from
    ``torch.func.vmap``.  Returns a scalar."""
    out = torch.as_tensor(table)
    for c in coords:
        w = _hat_weights(c, out.shape[0], out.dtype)
        out = torch.tensordot(w, out, dims=([0], [0]))
    return out
