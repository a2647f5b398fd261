"""Float policy of the PyTorch port: 'f64', 'f32' or 'mixed'.

Counterpart of ``elodin_tpu/_config.py``.  JAX needs x64 switched on
globally; torch has no such switch, so every column and every tensor the
port creates carries an explicit dtype taken from here, and nothing is
downcast by a framework default.  ``ELODIN_FLOAT_POLICY`` selects the
policy as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_FLOAT_POLICY = os.environ.get("ELODIN_FLOAT_POLICY", "f64")

# numpy <-> torch for the float dtypes a policy can choose
_TORCH_OF_NP = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}
_NP_OF_TORCH = {v: k for k, v in _TORCH_OF_NP.items()}


def default_float() -> torch.dtype:
    return torch.float32 if _FLOAT_POLICY == "f32" else torch.float64


def device(name, who: str, hint: str) -> torch.device:
    """``torch.device(name)``, refusing "cuda" where there is no card:
    ``who`` names the caller and ``hint`` how to run on the host."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device {name!r} asked for, but no CUDA device is "
                           f"available ({hint})")
    return dev


def effector_compute_dtype() -> torch.dtype | None:
    """Under the 'mixed' policy the six-dof effector pipeline computes in
    f32 while the integrator state (world_pos/world_vel) and the
    u' = u + dt*du update stay f64.  None when effectors run at full
    precision."""
    if _FLOAT_POLICY != "mixed":
        return None
    return torch.float32


def set_float_policy(policy: str) -> None:
    global _FLOAT_POLICY
    if policy not in ("f64", "f32", "mixed"):
        raise ValueError("float policy must be 'f64', 'f32' or 'mixed'")
    _FLOAT_POLICY = policy


# Components whose columns stay f64 under the 'mixed' policy: the
# integrator state and the time step.  Per-component ``precision=``
# declarations override.
_MIXED_KEEP_F64 = ("world_pos", "world_vel", "simulation_time_step")


def column_dtype(name: str, metadata: dict | None,
                 declared: torch.dtype) -> torch.dtype:
    """The dtype a float column carries under the active policy.

    ``precision="f64"|"f32"`` component metadata wins over the policy;
    'f64' keeps the declared dtype, 'f32' downcasts everything, 'mixed'
    keeps ``_MIXED_KEEP_F64`` in f64 and downcasts the rest."""
    prec = (metadata or {}).get("precision")
    if prec == "f64":
        return torch.float64
    if prec == "f32":
        return torch.float32
    if _FLOAT_POLICY == "f32":
        return torch.float32
    if _FLOAT_POLICY == "mixed":
        return torch.float64 if name in _MIXED_KEEP_F64 else torch.float32
    return declared


def numpy_column_dtype(name: str, component) -> np.dtype:
    """The numpy dtype of a component's host column under the policy:
    float columns follow ``column_dtype``, the rest keep their declared
    type."""
    declared = np.dtype(component.ty.dtype)
    if declared.kind != "f":
        return declared
    dt = column_dtype(name, component.metadata, _TORCH_OF_NP[declared])
    return _NP_OF_TORCH[dt]


def apply_float_policy(meta, cols: dict) -> dict:
    """Cast a dict of numpy columns (at their declared dtypes) per the
    active policy and the per-component metadata.  Non-float columns pass
    through untouched."""
    return {
        name: v.astype(numpy_column_dtype(name, meta.components[name]),
                       copy=False)
        for name, v in cols.items()
    }
