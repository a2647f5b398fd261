"""Entities, edges, archetypes (counterpart of ``elodin_tpu/entity.py``).

The JAX package reads a component value's array through
``jax.tree_util.tree_flatten``; here ``_leaf`` does the same job without
pytrees: the leaf of a value is the ``.inner`` of the port's own wrappers
(the spatial classes and ``EntityId``), the edge's id pair, or the value
itself (a tensor, a numpy array or a number), always as numpy.  A plain
``torch.Tensor`` is never unwrapped: ``Tensor.inner`` is a method.
"""

from __future__ import annotations

import re
import typing

import numpy as np
import torch

from .component import Component, ComponentType, component_type_of_value
from .spatial import _SpatialBase

_snake_case_pattern = re.compile(r"(?<!^)(?=[A-Z])")


def to_snake_case(name: str) -> str:
    return _snake_case_pattern.sub("_", name).lower()


def _leaf(value) -> np.ndarray:
    """The one array of a component value, as numpy."""
    if isinstance(value, Edge):
        return np.array([value.from_, value.to], dtype=np.uint64)
    if isinstance(value, (_SpatialBase, EntityId)):
        value = value.inner
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class EntityId:
    """Opaque entity handle."""

    __slots__ = ("inner",)

    def __init__(self, id: int):
        self.inner = int(id)

    def __index__(self):
        return self.inner

    def __int__(self):
        return self.inner

    def __eq__(self, other):
        if isinstance(other, EntityId):
            return self.inner == other.inner
        if isinstance(other, int):
            return self.inner == other
        return NotImplemented

    def __hash__(self):
        return hash(self.inner)

    def __str__(self):
        return str(self.inner)

    def __repr__(self):
        return f"EntityId({self.inner})"


class Edge:
    """Directed entity-pair component value, stored as a u64[2] column."""

    __slots__ = ("from_", "to")

    def __init__(self, from_, to):
        self.from_ = int(from_)
        self.to = int(to)

    def reverse(self) -> "Edge":
        return Edge(self.to, self.from_)

    def __repr__(self):
        return f"Edge({self.from_} -> {self.to})"


Edge.metadata = Component("edge", ComponentType.Edge)
Edge.__metadata__ = (Edge.metadata,)


class RevEdge:
    """Marker: traverse the edge component reversed."""


class TotalEdge:
    """Marker: a complete digraph over all entities."""


class Archetype(typing.Protocol):
    """Bundle of components spawned together."""

    @classmethod
    def archetype_name(cls) -> str:
        return to_snake_case(cls.__name__)

    def component_data(self) -> list[Component]:
        out = []
        hints = typing.get_type_hints(type(self), include_extras=True)
        for name, tp in hints.items():
            data = Component.of(tp)
            if data.ty is None:
                data = data._with_ty(
                    component_type_of_value(_leaf(getattr(self, name))))
            out.append(data)
        return out

    def arrays(self) -> list[np.ndarray]:
        # iterate the type hints (the order component_data uses), not
        # __dict__, so an extra instance attribute cannot shift the pairing
        hints = typing.get_type_hints(type(self), include_extras=True)
        return [_leaf(getattr(self, name)) for name in hints]


class C:
    """Ad-hoc component bundle."""

    def __init__(self, tys, values):
        if isinstance(tys, tuple) and isinstance(values, tuple):
            self.data = [Component.of(ty) for ty in tys]
            self.bufs = [_leaf(v) for v in values]
        else:
            self.data = [Component.of(tys)]
            self.bufs = [_leaf(values)]

    @classmethod
    def archetype_name(cls) -> str:
        return to_snake_case(cls.__name__)

    def arrays(self):
        return self.bufs

    def component_data(self):
        return self.data
