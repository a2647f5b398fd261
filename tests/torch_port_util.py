"""Shared helpers of the tests that hold the PyTorch port (elodin_tpu_torch)
to the JAX package (elodin_tpu).  Importing this module imports no JAX;
only ``float_policy`` and ``call_once`` need the JAX package."""

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


def jax_example(example: str, module: str, key: str | None = None, modules=None):
    """``examples/<example>/<module>.py`` of the JAX package, loaded once
    under ``key`` (by default ``jax_<example>_<module>``), with the
    example's directory on ``sys.path``, its top-level ``w.run``
    suppressed (``ELODIN_SKIP_RUN``) and ``modules`` in ``sys.modules``
    while it runs, so that its own plain imports resolve."""
    import importlib.util
    import os
    import sys

    key = key or f"jax_{example.replace('-', '_')}_{module}"
    if key in sys.modules:
        return sys.modules[key]
    ex_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "examples", example)
    saved_env = os.environ.get("ELODIN_SKIP_RUN")
    saved = {k: sys.modules.get(k) for k in modules or {}}
    os.environ["ELODIN_SKIP_RUN"] = "1"
    sys.path.insert(0, ex_dir)
    sys.modules.update(modules or {})
    try:
        spec = importlib.util.spec_from_file_location(key, os.path.join(ex_dir, f"{module}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path.pop(0)
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        if saved_env is None:
            os.environ.pop("ELODIN_SKIP_RUN", None)
        else:
            os.environ["ELODIN_SKIP_RUN"] = saved_env


def jax_falcon9(name: str):
    """``examples/falcon9/<name>.py`` of the JAX package under the key
    ``f9_<name>`` (as ``tests/test_falcon9.py`` loads it)."""
    return jax_example("falcon9", name, key=f"f9_{name}")


def call_once(jax_system, port_system, jax_meta, port_meta, cols: dict):
    """One call of a system in each package (no tick increment) from the
    same numpy columns; both packages' columns after it, as numpy."""
    import jax.numpy as jnp

    from elodin_tpu.system import SystemBuilder as JBuilder
    from elodin_tpu_torch.interop import columns_from_numpy, columns_to_numpy
    from elodin_tpu_torch.system import SystemBuilder as TBuilder

    jb = JBuilder(jax_meta, {k: jnp.asarray(v) for k, v in cols.items()})
    jax_system.call(jb)
    tb = TBuilder(port_meta, columns_from_numpy(cols, port_meta, "cpu"))
    port_system.call(tb)
    return ({k: np.asarray(v) for k, v in jb.cols.items()},
            columns_to_numpy(tb.cols, port_meta))


def mixed_errs(ours: dict, ref: dict) -> dict[str, float]:
    """max |ours - ref| / (1 + |ref|) of every float column, per channel
    group of a (..., 7) or (..., 6) trailing axis (``_GROUPS``) and as one
    group otherwise; integer columns must be equal."""
    out = {}
    for k, r in ref.items():
        r, o = np.asarray(r), np.asarray(ours[k])
        if r.dtype.kind != "f":
            np.testing.assert_array_equal(o, r, err_msg=k)
            continue
        o, r = o.astype(np.float64), r.astype(np.float64)
        if o.shape != r.shape:
            raise ValueError(f"{k}: shapes differ: {o.shape} vs {r.shape}")
        groups = _GROUPS.get(r.shape[-1], ()) if r.ndim >= 2 else ()
        for name, idx in groups or (("all", slice(None)),):
            d = np.abs(o[..., idx] - r[..., idx]) / (1.0 + np.abs(r[..., idx]))
            out[f"{k}.{name}"] = float(d.max()) if d.size else 0.0
    return out
