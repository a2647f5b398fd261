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

Unsigned columns are held as int64 on the device: torch has no uint64
arithmetic, and its uint32 lacks shifts, ``~`` and ``+``.  A u64 column
(``tick``, edges) holds values up to 2**63 - 1, a u32 column (the
stablehlo probe's ``hlo_bits``) values in [0, 2**32).  Both functions
convert, and refuse a value the column's type cannot hold.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _config


# the unsigned dtypes held as int64 on the device, and the largest value each
# holds there
_UNSIGNED_MAX = {np.dtype(np.uint64): np.iinfo(np.int64).max,
                 np.dtype(np.uint32): np.iinfo(np.uint32).max}


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
        if dtype in _UNSIGNED_MAX:
            if v.size and v.max() > _UNSIGNED_MAX[dtype]:
                raise ValueError(f"column {name!r}: value exceeds int64")
            v = v.astype(np.int64)
        # a copy: the device columns never alias the caller's arrays
        out[name] = torch.tensor(v, device=device)
    return out


def sample_count(cols: dict) -> int:
    """The sample count of a campaign's numpy columns, each ``(n_samples,
    n_entities, *shape)``; raises unless it is the same in each."""
    counts = {np.shape(v)[0] if np.ndim(v) else None for v in cols.values()}
    if len(counts) != 1 or None in counts:
        raise ValueError(f"columns disagree on the sample count: {sorted(map(str, counts))}")
    return counts.pop()


def campaign_columns_from_numpy(cols: dict, meta, device) -> dict[str, torch.Tensor]:
    """A campaign's numpy columns, each ``(n_samples, n_entities, *shape)``,
    -> the port's campaign state on ``device``; the sample count is read
    from the columns and must be the same in each."""
    return columns_from_numpy(cols, meta, device, n_samples=sample_count(cols))


def columns_to_numpy(cols: dict, meta) -> dict[str, np.ndarray]:
    """``{name: tensor}`` -> numpy columns at the dtypes
    ``columns_from_numpy`` accepts (int64 back to uint64 or uint32)."""
    out = {}
    for name, t in cols.items():
        v = t.detach().cpu().numpy()
        dtype = _expected(meta, name)[1]
        if dtype in _UNSIGNED_MAX:
            if v.size and (v.min() < 0 or v.max() > _UNSIGNED_MAX[dtype]):
                raise ValueError(f"column {name!r}: value out of range for {dtype}")
            v = v.astype(dtype)
        out[name] = v
    return out
