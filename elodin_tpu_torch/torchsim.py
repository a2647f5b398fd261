"""A functional simulation handle: the world's step as a function of a dict
of columns (counterpart of ``elodin_tpu/jaxsim.py``, whose ``JaxSim``
``World.to_jax`` returns; here ``World.to_torch`` and its alias
``World.to_jax`` return a ``TorchSim``, and ``el.JaxSim`` names it too).

``step(n)`` is an eager loop of ``n`` ticks (the JAX package runs one
``lax.fori_loop`` program); the tick column is incremented here, before
each call of ``py_sim``, as in the JAX package.  ``set_state`` applies its
value (the JAX package's repair of the reference, whose result was
dropped), through a select that never writes a column in place.  The
handle is a ``torch.utils._pytree`` node whose leaves are the state's
columns, so ``tree_flatten`` / ``tree_unflatten`` (and ``torch.func``
transforms over it) rebuild a sim with the same state and tick count.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree

from .diff import _as_column_value, set_row


class TorchSim:
    def __init__(self, step_fn, state: dict, entity_dict: dict,
                 component_entity_dict: dict, tick_name: str = "tick"):
        self.py_sim = step_fn  # dict -> dict, one tick (no tick increment)
        self.state = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                      for k, v in state.items()}
        self.entity_dict = dict(entity_dict)
        self.component_entity_dict = dict(component_entity_dict)
        self.tick_name = tick_name if tick_name in self.state else None
        self._tick_steps = 0

    # -- stepping ----------------------------------------------------------

    def _one(self, state):
        if self.tick_name is not None:
            state = dict(state)
            state[self.tick_name] = state[self.tick_name] + 1
        return self.py_sim(state)

    def step(self, max_steps: int = 1) -> None:
        for _ in range(max_steps):
            self.state = self._one(self.state)
        self._tick_steps += max_steps

    # -- state access ------------------------------------------------------

    def _entity_row(self, component_name: str, entity_name: str) -> int:
        try:
            eid = self.entity_dict[entity_name]
        except KeyError:
            raise Exception(f"Entity {entity_name} not found in world") from None
        try:
            ids = self.component_entity_dict[component_name]
        except KeyError:
            raise Exception(
                f"Component {component_name} not found in world"
            ) from None
        try:
            return ids.index(eid)
        except ValueError:
            raise Exception(
                f"Entity {entity_name} not found in component {component_name}"
            ) from None

    def get_state(self, component_name: str | None = None,
                  entity_name: str | None = None):
        if component_name is None:
            return self.state
        if entity_name is None:
            return self.state[component_name]
        row = self._entity_row(component_name, entity_name)
        return self.state[component_name][row]

    def set_state(self, component_name: str, entity_name: str, value) -> None:
        if component_name is None or entity_name is None:
            raise Exception("Component and entity name must be provided")
        row = self._entity_row(component_name, entity_name)
        col = self.state[component_name]
        value = _as_column_value(value, col)
        if col[row].shape != value.shape:
            raise Exception(
                f"Value shape: {tuple(value.shape)} does not match component: "
                f"{component_name}, entity: {entity_name} state shape: "
                f"{tuple(col[row].shape)}"
            )
        self.state[component_name] = set_row(col, row, value)

    def get_tick_count(self) -> int:
        # read from the tick column where the world has one: a pytree round
        # trip rebuilds the object, and the count must not live in the
        # context, or sims at different ticks would have unequal specs
        if self.tick_name is not None:
            return int(torch.max(self.state[self.tick_name]))
        return self._tick_steps

    def print_dictionary(self) -> None:
        for comp, ids in self.component_entity_dict.items():
            parts = []
            for name, eid in self.entity_dict.items():
                if eid in ids:
                    shape = tuple(self.state[comp][ids.index(eid)].shape)
                    parts.append(f"{name} (shape: {shape})")
            print(f"{comp}: {', '.join(parts)}")

    # -- pytree ------------------------------------------------------------

    def sim_flatten(self):
        keys = sorted(self.state)
        children = [self.state[k] for k in keys]
        context = (
            self.py_sim,
            tuple(keys),
            tuple(sorted(self.entity_dict.items())),
            tuple((k, tuple(v)) for k, v in sorted(self.component_entity_dict.items())),
            self.tick_name,
        )
        return children, context

    @classmethod
    def sim_unflatten(cls, children, context):
        py_sim, keys, ents, comp_ents, tick_name = context
        obj = object.__new__(cls)
        obj.py_sim = py_sim
        obj.state = dict(zip(keys, children))
        obj.entity_dict = dict(ents)
        obj.component_entity_dict = {k: list(v) for k, v in comp_ents}
        obj.tick_name = tick_name
        obj._tick_steps = 0  # host counter; get_tick_count reads the column
        return obj


pytree.register_pytree_node(
    TorchSim, TorchSim.sim_flatten, TorchSim.sim_unflatten,
    serialized_type_name="elodin_tpu_torch.torchsim.TorchSim",
)
