"""World state across the numpy boundary.

For this system the world's columns play the part that weights play in a
model: state and inertia are the parameters.  ``columns_from_numpy`` turns
a dict of numpy columns (``WorldBuilder.snapshot()`` of this package or of
the JAX package ``elodin_tpu``, or ``Exec.column_array`` of either) into the
port's device columns, after checking each name, shape and dtype against
the port's ``WorldMeta``; ``columns_to_numpy`` is its inverse.
``campaign_columns_from_numpy`` does the same for a Monte Carlo campaign's
columns, which carry a leading sample axis (``BatchedResult.final`` of
either package).

Unsigned 64-bit columns (``tick``, edges) are held as int64 on the device:
torch has no uint64 arithmetic.  Both functions convert, and refuse values
that int64 cannot hold.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _config


def _expected(meta, name: str) -> tuple[tuple[int, ...], np.dtype]:
    comp = meta.components[name]
    shape = (len(meta.comp_entities[name]),) + comp.ty.shape
    return shape, _config.numpy_column_dtype(name, comp)


def columns_from_numpy(cols: dict, meta, device,
                       n_samples: int | None = None) -> dict[str, torch.Tensor]:
    """numpy columns -> ``{name: tensor on device}``, checked against
    ``meta`` under the active float policy; with ``n_samples`` every column
    carries a leading sample axis of that length."""
    lead = () if n_samples is None else (int(n_samples),)
    missing = set(meta.components) - set(cols)
    extra = set(cols) - set(meta.components)
    if missing or extra:
        raise ValueError(
            f"columns do not match the world: missing {sorted(missing)}, "
            f"unknown {sorted(extra)}")
    out = {}
    for name in meta.components:
        v = np.asarray(cols[name])
        shape, dtype = _expected(meta, name)
        shape = lead + shape
        if v.shape != shape:
            raise ValueError(f"column {name!r}: shape {v.shape}, expected {shape}")
        if v.dtype != dtype:
            raise ValueError(f"column {name!r}: dtype {v.dtype}, expected {dtype}")
        if dtype == np.uint64:
            if v.size and v.max() > np.iinfo(np.int64).max:
                raise ValueError(f"column {name!r}: value exceeds int64")
            v = v.astype(np.int64)
        # a copy: the device columns never alias the caller's arrays
        out[name] = torch.tensor(v, device=device)
    return out


def campaign_columns_from_numpy(cols: dict, meta, device) -> dict[str, torch.Tensor]:
    """A campaign's numpy columns, each ``(n_samples, n_entities, *shape)``,
    -> the port's campaign state on ``device``; the sample count is read
    from the columns and must be the same in each."""
    counts = {np.shape(v)[0] if np.ndim(v) else None for v in cols.values()}
    if len(counts) != 1 or None in counts:
        raise ValueError(f"columns disagree on the sample count: {sorted(map(str, counts))}")
    return columns_from_numpy(cols, meta, device, n_samples=counts.pop())


def columns_to_numpy(cols: dict, meta) -> dict[str, np.ndarray]:
    """``{name: tensor}`` -> numpy columns at the dtypes
    ``columns_from_numpy`` accepts (int64 back to uint64)."""
    out = {}
    for name, t in cols.items():
        v = t.detach().cpu().numpy()
        dtype = _expected(meta, name)[1]
        if dtype == np.uint64:
            if v.size and v.min() < 0:
                raise ValueError(f"column {name!r}: negative value for uint64")
            v = v.astype(np.uint64)
        out[name] = v
    return out
