"""Differentiable rollouts: reverse-mode gradients through whole rollouts
(counterpart of ``elodin_tpu/diff.py``).

``rollout(world, system, ticks)`` turns a world and a system into a pure
function ``overrides -> state``.  Every call starts from the world's
snapshot on ``device``, merges ``overrides`` over it and steps
``system.build_step`` (``increment_sim_tick`` piped before the system)
``ticks`` times.  Gradients are plain autograd (``loss.backward()``,
``torch.autograd.grad``, ``torch.func.grad``) and ``torch.func.vmap``
batches candidates.  Typical use::

    roll = rollout(world, system, ticks=600, outputs=("world_pos",))
    row = entity_row(roll.meta, "world_pos", "craft")
    v0 = torch.tensor(..., requires_grad=True)
    col = set_entity(roll.initial_state["world_vel"], roll.meta,
                     "world_vel", "craft", v0)
    final = roll({"world_vel": col})
    torch.sum((final["world_pos"][row, 4:] - target) ** 2).backward()

Where the JAX package scans one compiled program, the port's rollout is a
Python loop of eager ticks, and ``remat_segments=k`` wraps each of the k
segments in ``torch.utils.checkpoint`` (non-reentrant): the backward pass
keeps the k segment-boundary states and re-runs each segment's forward when
its adjoint is needed.  The recompute runs the same eager ops on the same
inputs, so it reproduces the forward bitwise; what the step keeps on the
host stays as the forward left it (an additive probe's verdict is cached
per system, so the recompute takes the fold path the forward took), and
``system.TOTAL_FOLDS`` counts the recomputed folds as well.  Checkpointing
needs autograd's saved-tensor hooks, which ``torch.func`` transforms do not
support: ``remat_segments`` inside ``torch.func.vmap`` or
``torch.func.grad`` raises ``NotImplementedError``.

The column writes are functional (``set_entity`` selects with
``torch.where``), so they work under autograd and under ``vmap`` with an
unbatched column and a batched value, where a slice assignment on a clone
does not.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .interop import columns_from_numpy
from .system import build_step


def _as_column_value(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` at ``like``'s dtype and device; a tensor keeps its
    autograd history."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.asarray(value), dtype=like.dtype, device=like.device)


def rollout(world, system, ticks: int, *, outputs=None, record: bool = False,
            remat_segments: int | None = None, simulation_rate: float | None = None,
            device="cuda"):
    """A differentiable function ``fn(overrides=None)`` of ``ticks`` ticks of
    ``system`` over ``world``'s columns on ``device``.

    ``overrides`` maps component names to column values (each takes the
    column's dtype and shape) merged over the snapshot.  With
    ``record=False`` ``fn`` returns the final state (only ``outputs`` when
    given); with ``record=True`` the trajectory of ``outputs``, each
    stacked on a leading tick axis ``(ticks, ...)``.  ``fn.meta`` is the
    world's metadata and ``fn.initial_state`` its columns on ``device``,
    which no call changes.

    ``remat_segments=k`` checkpoints each of k segments of ``ticks // k``
    ticks (module docstring); ``ticks`` must be divisible by k."""
    if simulation_rate is not None:
        world.set_sim_time_step(1.0 / simulation_rate)
    meta, cols = world.snapshot()
    step = build_step(meta, system)
    cols0 = columns_from_numpy(cols, meta, device)
    if outputs is not None:
        missing = [k for k in outputs if k not in cols0]
        if missing:
            raise KeyError(f"unknown output components: {missing}")
    if record and outputs is None:
        raise ValueError("record=True requires explicit outputs=(...)")
    if remat_segments is not None:
        if remat_segments <= 0 or ticks % remat_segments:
            raise ValueError(
                f"ticks ({ticks}) must be divisible by remat_segments "
                f"({remat_segments})"
            )

    def run(state, n):
        ys = []
        for _ in range(n):
            state = step(state)
            if record:
                ys.append({k: state[k] for k in outputs})
        return state, ys

    def fn(overrides=None):
        state = dict(cols0)
        for k, v in (overrides or {}).items():
            if k not in state:
                raise KeyError(f"unknown component {k!r}")
            state[k] = _as_column_value(v, state[k]).reshape(state[k].shape)
        if remat_segments is None:
            final, ys = run(state, ticks)
        else:
            if torch._C._functorch.maybe_current_level() is not None:
                raise NotImplementedError(
                    "rollout(remat_segments=...) inside a torch.func transform "
                    "(vmap, grad): torch.utils.checkpoint needs saved-tensor "
                    "hooks, which torch.func does not support; drop "
                    "remat_segments or take the gradient with torch.autograd "
                    "outside vmap")
            final, ys = state, []
            for _ in range(remat_segments):
                final, seg = checkpoint(run, final, ticks // remat_segments,
                                        use_reentrant=False)
                ys += seg
        if record:
            return {k: torch.stack([y[k] for y in ys]) for k in outputs}
        if outputs is not None:
            return {k: final[k] for k in outputs}
        return final

    fn.meta = meta
    fn.initial_state = cols0
    return fn


def entity_row(meta, component: str, entity_name: str) -> int:
    """Row index of ``entity_name`` inside ``component``'s column, for
    building override columns and reading per-entity outputs."""
    try:
        eid = meta.entity_names[entity_name]
    except KeyError:
        raise KeyError(f"entity {entity_name!r} not found") from None
    try:
        return meta.comp_index[component][eid]
    except KeyError:
        raise KeyError(
            f"entity {entity_name!r} has no component {component!r}"
        ) from None


def set_row(column: torch.Tensor, row: int, value) -> torch.Tensor:
    """``column`` with row ``row`` replaced by ``value`` (the JAX
    package's ``column.at[row].set(value)``), written by a select: the
    column is never written in place, autograd flows to both, and under
    ``vmap`` an unbatched column takes a batched value."""
    value = _as_column_value(value, column).reshape(column.shape[1:])
    mask = torch.arange(column.shape[0], device=column.device) == row
    return torch.where(mask.reshape((-1,) + (1,) * (column.dim() - 1)), value, column)


def set_entity(column, meta, component: str, entity_name: str, value):
    """Differentiable per-entity override: ``column`` with
    ``entity_name``'s row set to ``value`` (``set_row``)."""
    return set_row(column, entity_row(meta, component, entity_name), value)
