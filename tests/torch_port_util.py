"""Shared helpers of the tests that hold the PyTorch port (elodin_tpu_torch)
to the JAX package (elodin_tpu).  Importing this module imports no JAX;
only ``float_policy`` needs the JAX package."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

# the suite runs under pytest-xdist with several workers: one intra-op
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

# channel groups of the trailing axis, each compared against its own scale:
# a (..., 7) transform is quaternion + translation, a (..., 6) motion,
# acceleration or force is angular (torque) + linear (force)
_GROUPS = {7: (("quaternion", slice(0, 4)), ("translation", slice(4, 7))),
           6: (("angular", slice(0, 3)), ("linear", slice(3, 6)))}


@contextlib.contextmanager
def float_policy(policy: str):
    """Switch both packages' float policy together, and restore both."""
    from elodin_tpu import _config as jax_config
    from elodin_tpu_torch import _config as torch_config

    prev_jax, prev_torch = jax_config._FLOAT_POLICY, torch_config._FLOAT_POLICY
    jax_config.set_float_policy(policy)
    torch_config.set_float_policy(policy)
    try:
        yield
    finally:
        jax_config.set_float_policy(prev_jax)
        torch_config.set_float_policy(prev_torch)


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def rel_errs(ours, ref) -> dict[str, float]:
    """max |ours - ref| / max |ref| in f64 for each channel group of the
    trailing axis (see ``_GROUPS``; any other width, or a 1-d array, is one
    group ``all``).  A group whose reference is all zero is held by
    max |ours - ref| alone."""
    ours, ref = _f64(ours), _f64(ref)
    if ours.shape != ref.shape:
        raise ValueError(f"shapes differ: {ours.shape} vs {ref.shape}")
    groups = _GROUPS.get(ref.shape[-1], ()) if ref.ndim >= 2 else ()
    out = {}
    for name, idx in groups or (("all", slice(None)),):
        d = float(np.abs(ours[..., idx] - ref[..., idx]).max())
        scale = float(np.abs(ref[..., idx]).max())
        out[name] = d / scale if scale > 0.0 else d
    return out


def rel_err(ours, ref) -> float:
    """The worst of ``rel_errs``: each channel group against its own scale."""
    return max(rel_errs(ours, ref).values())


def jax_falcon9(name: str):
    """``examples/falcon9/<name>.py`` of the JAX package, loaded under the
    key ``f9_<name>`` (as ``tests/test_falcon9.py`` loads it), with the
    example's directory on ``sys.path`` while it runs so that its own plain
    imports resolve."""
    import importlib.util
    import os
    import sys

    key = f"f9_{name}"
    if key in sys.modules:
        return sys.modules[key]
    f9_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "examples", "falcon9")
    sys.path.insert(0, f9_dir)
    try:
        spec = importlib.util.spec_from_file_location(key, os.path.join(f9_dir, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.pop(0)
