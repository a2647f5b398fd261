"""World construction: struct-of-arrays component columns (counterpart of
``elodin_tpu/world.py``).

Columns are built on the host as numpy arrays while spawning.  ``snapshot``
returns them at their policy dtypes; ``Exec`` moves them to the device
once, through ``interop.columns_from_numpy``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from . import _config
from .component import Component, ComponentType, PrimitiveType, component_type_of_value
from .entity import EntityId

DEFAULT_TIME_STEP = 1.0 / 120.0


def _name_to_id(name: str) -> str:
    """Entity display name -> snake_case id."""
    parts = re.findall(r"[A-Za-z0-9]+", name)
    out: list[str] = []
    for p in parts:
        # split CamelCase boundaries within each token
        out.extend(
            s.lower() for s in re.findall(r"[A-Z]+(?=[A-Z][a-z])|[A-Z]?[a-z0-9]+|[A-Z]+", p)
        )
    return "_".join(out) if out else name.lower()


@dataclass
class EntityMetadata:
    entity_id: int
    name: str
    metadata: dict = field(default_factory=dict)


class Column:
    """One component's struct-of-arrays storage."""

    def __init__(self, component: Component):
        self.component = component
        self.entity_ids: list[int] = []
        self.values: list[np.ndarray] = []  # one (shape,) array per entity

    def push(self, entity_id: int, value: np.ndarray) -> None:
        ty = self.component.ty
        value = np.asarray(value)
        expected = int(np.prod(ty.shape)) if ty.shape else 1
        if value.size != expected:
            raise ValueError(
                f"component {self.component.name!r}: value size {value.size} "
                f"does not match declared shape {ty.shape}"
            )
        self.entity_ids.append(entity_id)
        self.values.append(
            value.astype(ty.dtype, copy=False).reshape(ty.shape)
        )

    def stacked(self) -> np.ndarray:
        ty = self.component.ty
        if not self.values:
            return np.zeros((0,) + ty.shape, dtype=ty.dtype)
        return np.stack(self.values, axis=0)


class WorldMeta:
    """Static metadata snapshot read by the SystemBuilder."""

    def __init__(self, builder: "WorldBuilder"):
        self.components: dict[str, Component] = {
            n: c.component for n, c in builder.columns.items()
        }
        self.comp_entities: dict[str, tuple[int, ...]] = {
            n: tuple(c.entity_ids) for n, c in builder.columns.items()
        }
        self.comp_index: dict[str, dict[int, int]] = {
            n: {e: i for i, e in enumerate(ids)}
            for n, ids in self.comp_entities.items()
        }
        self.entity_count: int = builder.entity_len
        self.entity_metadata: dict[int, EntityMetadata] = dict(
            builder.entity_metadata
        )
        self.entity_names: dict[str, int] = {
            m.name: eid for eid, m in builder.entity_metadata.items()
        }
        # (from, to) pairs of every u64[2] column, for explicit-edge queries
        self._edge_cols: dict[str, list[tuple[int, int]]] = {
            n: [(int(v[0]), int(v[1])) for v in c.values]
            for n, c in builder.columns.items()
            if c.component.ty.shape == (2,)
            and c.component.ty.ty == PrimitiveType.U64
        }
        self.sim_time_step: float = builder.sim_time_step

    def edge_values(self, name: str) -> list[tuple[int, int]]:
        if name not in self._edge_cols:
            raise KeyError(f"edge component {name!r} not found")
        return self._edge_cols[name]


class WorldBuilder:
    """Mutable world under construction."""

    def __init__(self):
        self.columns: dict[str, Column] = {}
        self.entity_len: int = 0
        self.entity_metadata: dict[int, EntityMetadata] = {}
        self.sim_time_step: float = DEFAULT_TIME_STEP
        self._spawn_globals()

    # -- globals -------------------------------------------------------------

    def _spawn_globals(self) -> None:
        gid = self.entity_len
        self.entity_len += 1
        self.entity_metadata[gid] = EntityMetadata(gid, "Globals")
        tick = Component("tick", ComponentType(PrimitiveType.U64, ()), {"priority": 7})
        ts = Component(
            "simulation_time_step",
            ComponentType(PrimitiveType.F64, ()),
            {"priority": 8},
        )
        self._push(gid, tick, np.uint64(0))
        self._push(gid, ts, np.float64(self.sim_time_step))

    def set_sim_time_step(self, dt: float) -> None:
        self.sim_time_step = float(dt)
        col = self.columns["simulation_time_step"]
        col.values[0] = np.float64(dt).reshape(())

    # -- spawning ----------------------------------------------------------

    def _push(self, entity_id: int, component: Component, value) -> None:
        col = self.columns.get(component.name)
        if col is None:
            col = Column(component)
            self.columns[component.name] = col
        else:
            # merge metadata from later spawns (first explicit ty wins)
            if col.component.ty is None and component.ty is not None:
                col.component = component
            if component.metadata:
                col.component.metadata.update(component.metadata)
        col.push(entity_id, value)

    def spawn(self, spawnable, name: str | None = None, id: str | None = None) -> EntityId:
        entity_id = EntityId(self.entity_len)
        self.insert(entity_id, spawnable)
        self.entity_len += 1
        derived = None
        if name is not None and id is None:
            derived = _name_to_id(name)
        elif id is not None:
            derived = id
        if derived is not None:
            self.entity_metadata[entity_id.inner] = EntityMetadata(
                entity_id.inner, derived
            )
        return entity_id

    def spawn_batch(self, archetype, count: int, name_prefix: str | None = None) -> list[EntityId]:
        """Spawn ``count`` entities at once from an archetype whose arrays
        carry a leading batch axis (or are broadcast)."""
        arrays = archetype.arrays()
        data = archetype.component_data()
        first_id = self.entity_len
        ids = [EntityId(first_id + i) for i in range(count)]
        self.entity_len += count
        for arr, component in zip(arrays, data):
            if component.ty is None:
                value0 = np.asarray(arr)
                if value0.ndim == 1 and value0.shape == (count,):
                    # one (count,) vector could be per-entity scalars OR one
                    # count-long vector broadcast to all: require a type
                    raise ValueError(
                        f"spawn_batch: {component.name!r} value of shape "
                        f"({count},) is ambiguous with count={count} — "
                        "declare the component's ComponentType (or pass a "
                        f"({count}, 1) array for per-entity scalars)"
                    )
                shape = value0.shape[1:] if value0.shape[:1] == (count,) else value0.shape
                component = component._with_ty(
                    component_type_of_value(np.zeros(shape, dtype=value0.dtype))
                )
            ty = component.ty
            arr = np.asarray(arr)
            if arr.shape != (count,) + ty.shape:
                arr = np.broadcast_to(arr.reshape(ty.shape), (count,) + ty.shape)
            arr = arr.astype(ty.dtype, copy=False)
            col = self.columns.get(component.name)
            if col is None:
                col = Column(component)
                self.columns[component.name] = col
            col.entity_ids.extend(range(first_id, first_id + count))
            col.values.extend(arr)
        if name_prefix is not None:
            for i, eid in enumerate(ids):
                self.entity_metadata[int(eid)] = EntityMetadata(
                    int(eid), f"{name_prefix}{i}"
                )
        return ids

    def insert(self, entity_id: EntityId, spawnable) -> None:
        archetypes = spawnable if isinstance(spawnable, list) else [spawnable]
        for archetype in archetypes:
            arrays = archetype.arrays()
            data = archetype.component_data()
            if len(arrays) != len(data):
                raise ValueError(
                    f"archetype {archetype!r}: {len(arrays)} arrays vs "
                    f"{len(data)} components"
                )
            for arr, component in zip(arrays, data):
                if component.ty is None:
                    component = component._with_ty(component_type_of_value(arr))
                self._push(int(entity_id), component, arr)

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> tuple[WorldMeta, dict[str, np.ndarray]]:
        """(metadata, numpy columns at their policy dtypes)."""
        meta = WorldMeta(self)
        cols = {n: c.stacked() for n, c in self.columns.items()}
        return meta, _config.apply_float_policy(meta, cols)
