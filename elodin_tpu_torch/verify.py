"""Two-device differential verification (counterpart of
``elodin_tpu/verify.py``).

The same tick program (``system.build_step``) runs from the same world
snapshot on two torch devices, and the states are diffed under allclose
semantics: ``verify_step`` after one tick, ``verify_trajectory`` after
``ticks`` ticks (the "trajectories matching CPU to 1e-6" gate).
``checkpoint_first_tick`` saves an ``Exec``'s tick-0 inputs and tick-1
outputs for offline diffing when ``ELODIN_TPU_DEBUG_DIR`` is set; its tick
is one eager step, where the JAX package jits it.

The pair of devices is explicit: ``devices=(reference, test)``, by default
``("cpu", "cuda")``.  Where the JAX package finds no accelerator it quietly
runs the CPU twice; the port raises instead, and a caller who wants that
determinism check asks for ``devices=("cpu", "cpu")``.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path

import numpy as np
import torch

from .interop import columns_from_numpy, columns_to_numpy
from .system import build_step

DEFAULT_DEVICES = ("cpu", "cuda")
DEBUG_DIR_ENV = "ELODIN_TPU_DEBUG_DIR"


def _device(name) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"verify: device {name!r} asked for, but no CUDA device "
                           "is available (pass devices=('cpu', 'cpu') for a "
                           "determinism check)")
    return dev


def _run(meta, cols: dict, system, ticks: int, device) -> dict[str, np.ndarray]:
    """``ticks`` ticks of ``system`` from ``cols`` on ``device``; the final
    columns as numpy."""
    step = build_step(meta, system)
    state = columns_from_numpy(cols, meta, device)
    for _ in range(ticks):
        state = step(state)
    return columns_to_numpy(state, meta)


def _diff(a: dict, b: dict, rtol: float = 1e-6) -> dict:
    """Per column: max |Δ|, max relative |Δ|, the mixed error |Δ| / (1 +
    scale) and the largest excess |Δ| - rtol * scale, with scale =
    max(|a|, |b|) element by element."""
    report = {}
    for k in a:
        x = np.asarray(a[k], dtype=np.float64)
        y = np.asarray(b[k], dtype=np.float64)
        d = np.abs(x - y)
        scale = np.maximum(np.abs(x), np.abs(y))
        rel = np.where(scale > 0, d / np.maximum(scale, 1e-300), 0.0)
        report[k] = {
            "max_abs": float(d.max()) if d.size else 0.0,
            "max_rel": float(rel.max()) if rel.size else 0.0,
            "metric_rel": float((d / (1.0 + scale)).max()) if d.size else 0.0,
            "max_excess": float((d - rtol * scale).max()) if d.size else 0.0,
        }
    return report


def _assert_tol(report: dict, rtol: float, atol: float) -> None:
    """allclose semantics: a column fails when an element has |x - y| >
    atol + rtol * max(|x|, |y|).  A NaN excess (one side not finite where
    the other is) fails too: ``NaN > atol`` is False, so it is tested on its
    own."""
    bad = {k: v for k, v in report.items()
           if v["max_excess"] > atol or math.isnan(v["max_excess"])}
    if bad:
        raise AssertionError(f"device mismatch beyond tolerance: {bad}")


def verify_step(world, system, rtol: float = 1e-6, atol: float = 1e-6,
                devices=DEFAULT_DEVICES) -> dict:
    """One tick on each of ``devices`` = (reference, test), diffed
    (``_diff``); raises AssertionError past allclose(``atol``, ``rtol``)."""
    ref, test = (_device(d) for d in devices)
    meta, cols = world.snapshot()
    report = _diff(_run(meta, cols, system, 1, ref), _run(meta, cols, system, 1, test), rtol)
    _assert_tol(report, rtol, atol)
    return report


def verify_trajectory(world, system, ticks: int = 100, rtol: float = 1e-6,
                      atol: float = 1e-6, simulation_rate: float | None = None,
                      devices=DEFAULT_DEVICES) -> dict:
    """``ticks`` ticks of the same program on each of ``devices`` =
    (reference, test), the final states diffed; raises AssertionError when
    an element differs by more than ``atol + rtol * max(|x|, |y|)`` (atol
    == rtol == 1e-6, the ODE solvers' mixed error norm) or one side is not
    finite where the other is.  Returns the per-column report and a
    ``_summary`` of the worst values, the tick count and the devices."""
    ref, test = (_device(d) for d in devices)
    if simulation_rate is not None:
        world.set_sim_time_step(1.0 / simulation_rate)
    meta, cols = world.snapshot()
    out_ref = _run(meta, cols, system, ticks, ref)
    out_test = _run(meta, cols, system, ticks, test)
    report = _diff(out_ref, out_test, rtol)
    cols_report = dict(report)
    report["_summary"] = {
        "max_rel": max(v["max_rel"] for v in cols_report.values()),
        "metric_rel": max(v["metric_rel"] for v in cols_report.values()),
        "max_excess": max(v["max_excess"] for v in cols_report.values()),
        "max_abs": max(v["max_abs"] for v in cols_report.values()),
        "ticks": ticks,
        "devices": [str(ref), str(test)],
    }
    _assert_tol(cols_report, rtol, atol)
    return report


def checkpoint_first_tick(exec_) -> str | None:
    """With ``ELODIN_TPU_DEBUG_DIR`` set, write ``tick0_inputs.npz`` (the
    Exec's current state), ``tick1_outputs.npz`` (one tick of its step
    from there; the Exec itself does not advance) and ``manifest.json``
    (component names and shapes) there, and return the directory; else
    None."""
    debug_dir = os.environ.get(DEBUG_DIR_ENV)
    if not debug_dir:
        return None
    out = Path(debug_dir)
    out.mkdir(parents=True, exist_ok=True)
    inputs = columns_to_numpy(exec_.cols, exec_.meta)
    np.savez(out / "tick0_inputs.npz", **inputs)
    outputs = columns_to_numpy(exec_._step(dict(exec_.cols)), exec_.meta)
    np.savez(out / "tick1_outputs.npz", **outputs)
    (out / "manifest.json").write_text(json.dumps(
        {"components": sorted(inputs),
         "shapes": {k: list(v.shape) for k, v in inputs.items()}},
        indent=2))
    return str(out)
