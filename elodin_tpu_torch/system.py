"""Systems, queries and the per-tick builder (counterpart of
``elodin_tpu/system.py``).

A ``SystemBuilder`` carries a dict of component columns (torch tensors, one
``(n_entities, *shape)`` tensor per component) through the pipeline.  The
JAX package traces this once into a compiled program; the port runs it
eagerly, once per tick.  Columns are never written in place: ``scatter``
rebinds the column, so a column that a system only reads keeps its
identity (the mixed float policy in ``six_dof`` relies on that).

``@system`` functions take ``Query`` and ``GraphQuery`` arguments as in the
JAX package.  ``Query.map`` runs under ``torch.func.vmap`` where JAX uses
``jax.vmap``; ``Query.map_seq`` and ``GraphQuery.edge_fold`` keep the JAX
package's semantics, with Python loops where it scans.  ``RateGroup``
(``every``) branches on the host where the JAX package uses ``lax.cond``.
"""

from __future__ import annotations

import inspect
import os
import types
import typing
from typing import Callable

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from . import _config
from .component import Component
from .entity import RevEdge, TotalEdge
from .parallel.distributed import current_window
from .tick_metrics import span

# which path each TotalEdge edge_fold took since import (or since a caller
# reset the counts to 0), the dense masked sum or the exact sequential fold,
# and how often the additive probe ran
TOTAL_FOLDS = {"dense": 0, "sequential": 0, "probes": 0}

# how often a TotalEdge edge_fold built its set-up (its ids and stand-in
# flags on the device) and how often it took one its system kept
# (``FnSystem.fold_setups``) since import, or since a caller reset them
FOLD_SETUPS = {"built": 0, "reused": 0}

# the set-ups a system keeps, one per query shape; the oldest goes first
FOLD_SETUP_CAP = 8

# right-hand entities per step of the dense TotalEdge fold
DENSE_FOLD_CHUNK = 1024

# spans (tick_metrics.span): a tick, the dense edge fold, the additive probe,
# the fold's set-up; each FnSystem and LambdaSystem names its own
# "system.<name>"
TICK, FOLD_DENSE, FOLD_PROBE, FOLD_SETUP = "tick", "fold.dense", "fold.probe", "fold.setup"


def from_array(cls, arr):
    """A typed component value from a raw tensor (a tensor or numpy
    annotation passes the tensor through)."""
    cls = getattr(cls, "__origin__", cls)
    if cls is torch.Tensor or cls is np.ndarray:
        return arr
    from_arr = getattr(cls, "from_array", None)
    if from_arr is None:
        return arr
    return from_arr(arr)


def _as_leaf(x, device) -> torch.Tensor:
    """One leaf of a fold's initial value as a tensor on ``device``; a
    Python float takes the policy's float dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, float):
        return torch.tensor(x, dtype=_config.default_float(), device=device)
    return torch.as_tensor(np.asarray(x), device=device)


def _to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A copy of host tensor ``t`` on ``device``; to a card through pinned
    memory without waiting for the copy, so the stream is not synchronised."""
    if torch.device(device).type != "cuda":
        return t.to(device, copy=True)
    return t.pin_memory().to(device, non_blocking=True)


def _passes_through(x, device) -> bool:
    """True for an initial-value leaf that the fold takes as it is: a tensor
    on ``device`` or another card already, or one that carries a gradient."""
    return isinstance(x, torch.Tensor) and (
        x.device.type != "cpu" or x.device == device or x.requires_grad)


class _FoldSetup:
    """What a ``TotalEdge`` fold derives from its entity ids alone, on the
    device: the left entities that have an edge (``keep``: None when all
    do), their ids (``lid``), the right ids (``rid``) and which left entity
    is the first right one (``is_r0``); and the initial carry last staged
    on the device with the host values it came from."""

    def __init__(self, lids, rids, device):
        # a left entity whose only right-hand entity is itself has no edge
        keep = [i for i, f in enumerate(lids) if not (len(rids) == 1 and rids[0] == f)]
        if not keep:
            raise RuntimeError("edge_fold matched no edges")
        self.from_ids = tuple(lids[i] for i in keep)
        self.keep = None if len(keep) == len(lids) else _to_device(
            torch.as_tensor(keep), device)
        self.lid = _to_device(torch.as_tensor(self.from_ids, dtype=torch.int64), device)
        self.rid = _to_device(torch.as_tensor(rids, dtype=torch.int64), device)
        self.is_r0 = _to_device(torch.as_tensor([f == rids[0] for f in self.from_ids]),
                                device)
        self.init_key = self.init = None

    def initial_carry(self, init_flat, device) -> list[torch.Tensor]:
        """The initial value's leaves on ``device``.  A leaf built on the
        host (a number, an array, a host tensor without a gradient) is kept
        on the device by its dtype, shape and bytes, so a tick that passes
        the values of the tick before copies nothing."""
        hosts = [None if _passes_through(x, device) else _as_leaf(x, "cpu")
                 for x in init_flat]
        key = tuple(None if h is None else
                    (h.dtype, tuple(h.shape), h.reshape(-1).view(torch.uint8).numpy().tobytes())
                    for h in hosts)
        if key != self.init_key:
            self.init = [None if h is None else _to_device(h, device) for h in hosts]
            self.init_key = key
        return [_as_leaf(x, device) if h is None else s
                for x, h, s in zip(init_flat, hosts, self.init)]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class SystemBuilder:
    """Static world metadata + current column values.

    Under a row window (the step's
    ``parallel.distributed.current_window()``: the rows of the columns cut
    over a mesh's ``ep`` axis that this rank holds), a cut column holds
    only the rank's block of rows, ``entities_of`` names the entities of
    that block, and ``gather``/``scatter`` address rows within it; columns
    that are not cut are whole, and identical, on every rank."""

    def __init__(self, world, cols: dict[str, torch.Tensor]):
        self.world = world  # WorldMeta
        self.cols = cols  # name -> (n_entities, *shape) tensor
        self.window = current_window()

    # -- static metadata helpers -----------------------------------------

    def global_entities_of(self, name: str) -> tuple[int, ...]:
        """Every entity of the column, on every rank."""
        try:
            return self.world.comp_entities[name]
        except KeyError:
            raise KeyError(
                f"component {name!r} does not exist in the world "
                "(no entity was spawned with it)"
            ) from None

    def entities_of(self, name: str) -> tuple[int, ...]:
        """The entities whose rows this builder's column holds: all of
        them, or the window's block of a cut column."""
        ents = self.global_entities_of(name)
        w = self.window
        if w is None or name not in w.cut:
            return ents
        key = ("entities", name)
        if key not in w.cache:
            r0, r1 = w.block(name)
            w.cache[key] = ents[r0:r1]
        return w.cache[key]

    def query_layout(self, names) -> tuple[list[int], list[int]] | None:
        """For a query over the components ``names`` under a row window that
        cuts any of them: (the query's entities on each rank, in rank order;
        all of its entities).  None when no window cuts them.  Decided from
        the metadata once a window; raises ``NotImplementedError`` when the
        ranks' parts do not add up to the whole query (components cut
        unalike)."""
        w = self.window
        if w is None or not w.cut.intersection(names):
            return None
        key = ("query", tuple(names))
        if key not in w.cache:
            whole = _intersect_ordered([self.global_entities_of(n) for n in names])
            sizes = []
            for k in range(len(w.comm.ranks)):
                parts = []
                for n in names:
                    ents = self.global_entities_of(n)
                    if n in w.cut:
                        r0, r1 = w.block(n, k)
                        ents = ents[r0:r1]
                    parts.append(ents)
                sizes.append(len(_intersect_ordered(parts)))
            if sum(sizes) != len(whole) or not sizes[w.comm.index]:
                raise NotImplementedError(
                    f"a query over {list(names)} whose entities the ranks' row windows do "
                    f"not split into one block each ({sizes} of {len(whole)} entities)")
            w.cache[key] = (sizes, whole)
        return w.cache[key]

    def all_rows(self, names, value: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(``value`` -- one row for each entity of the query over ``names``
        that this builder holds -- with every rank's rows joined in global
        order, the global index of this builder's first row).  ``(value,
        0)`` where no row window cuts the query; under one it is a
        collective, which every rank calls."""
        layout = self.query_layout(names)
        if layout is None:
            return value, 0
        sizes = layout[0]
        comm = self.window.comm
        return comm.all_gather_rows(value, sizes), sum(sizes[:comm.index])

    def rows_of(self, name: str, entity_ids) -> list[int]:
        index = self.world.comp_index[name]
        w = self.window
        r0 = w.block(name)[0] if w is not None and name in w.cut else 0
        return [index[e] - r0 for e in entity_ids]

    def _is_full_column(self, name: str, entity_ids) -> bool:
        """True when ``entity_ids`` are all of the column's rows in order.
        Runs every tick, so it compares the id sequences in C instead of
        building the row list."""
        return tuple(entity_ids) == self.entities_of(name)

    # -- column access ----------------------------------------------------

    def column(self, name: str) -> torch.Tensor:
        if name not in self.cols:
            raise KeyError(f"component {name!r} has no column")
        return self.cols[name]

    def write_column(self, name: str, value) -> None:
        """Rebind a whole column, at its dtype, device and shape."""
        col = self.cols[name]
        self.cols[name] = torch.as_tensor(value, dtype=col.dtype,
                                          device=col.device).reshape(col.shape)

    def gather(self, name: str, entity_ids) -> torch.Tensor:
        col = self.column(name)
        if self._is_full_column(name, entity_ids):
            return col
        rows = self.rows_of(name, entity_ids)
        return col[torch.as_tensor(rows, dtype=torch.int64, device=col.device)]

    def scatter(self, name: str, entity_ids, value) -> None:
        col = self.column(name)
        value = torch.as_tensor(value, dtype=col.dtype, device=col.device)
        if self._is_full_column(name, entity_ids):
            self.cols[name] = value.reshape(col.shape)
            return
        rows = self.rows_of(name, entity_ids)
        index = torch.as_tensor(rows, dtype=torch.int64, device=col.device)
        self.cols[name] = col.index_copy(
            0, index, value.reshape((len(rows),) + col.shape[1:]))


# ---------------------------------------------------------------------------
# System composition
# ---------------------------------------------------------------------------


class System:
    """Composable simulation pass: rebinds builder columns when called."""

    def call(self, builder: SystemBuilder) -> None:  # pragma: no cover
        raise NotImplementedError

    def pipe(self, other: "System") -> "System":
        return Pipe(self, as_system(other))

    def __or__(self, other) -> "System":
        """``a | b`` pipes systems."""
        return self.pipe(other)

    def __ror__(self, other) -> "System":
        """``f | b`` with a plain function ``f`` on the left."""
        return as_system(other).pipe(self)

    def system(self) -> "System":
        return self


class Pipe(System):
    def __init__(self, *systems: System):
        flat: list[System] = []
        for s in systems:
            if isinstance(s, Pipe):
                flat.extend(s.systems)
            else:
                flat.append(s)
        self.systems = flat

    def call(self, builder: SystemBuilder) -> None:
        for s in self.systems:
            s.call(builder)


class FnSystem(System):
    """A user function whose parameters and return value are
    ``Query``/``GraphQuery`` annotations (``@system``)."""

    def __init__(self, func: Callable, name: str | None = None):
        self.func = func
        self.name = name or getattr(func, "__name__", repr(func))
        self._span = "system." + self.name
        sig = inspect.signature(func)
        self.params = list(sig.parameters.values())
        self.return_annotation = sig.return_annotation
        self.input_ids: list[str] = []
        self.edge_ids: list[str] = []
        for p in self.params:
            ann = p.annotation
            if ann is inspect.Parameter.empty:
                raise TypeError(
                    f"system {self.name}: parameter {p.name!r} needs a Query "
                    "annotation")
            self.input_ids.extend(ann.component_ids(ann))
            if getattr(ann, "edge_ids", None) is not None:
                self.edge_ids.extend(ann.edge_ids(ann))
        self.output_ids: list[str] = []
        if self.return_annotation is not inspect.Signature.empty:
            self.output_ids.extend(
                self.return_annotation.component_ids(self.return_annotation))
        # the additive probe's verdicts for this system's TotalEdge folds,
        # kept across ticks as the JAX package keeps them for one trace
        self.fold_verdicts: dict = {}
        # those folds' set-ups on the device, by query shape (_FoldSetup)
        self.fold_setups: dict = {}

    def call(self, builder: SystemBuilder) -> None:
        with span(self._span):
            args = [p.annotation.from_builder(p.annotation, builder, [])
                    for p in self.params]
            for a in args:
                if isinstance(a, GraphQuery):
                    a.verdicts = self.fold_verdicts
                    a.setups = self.fold_setups
            output = self.func(*args)
            if output is not None:
                output.output(builder, [])

    def __repr__(self):
        return f"<system {self.name}>"


class LambdaSystem(System):
    """A system from a builder -> None callable (six_dof, the tick
    counter, model effectors)."""

    def __init__(self, fn: Callable[[SystemBuilder], None], name: str = ""):
        self.fn = fn
        self.name = name
        self._span = "system." + name

    def call(self, builder: SystemBuilder) -> None:
        with span(self._span):
            self.fn(builder)

    def __repr__(self):
        return f"<system {self.name}>"


class RateGroup(System):
    """Multi-rate scheduling: run the wrapped system only on every
    ``every``-th tick and hold its outputs in between.  Active ticks are 1,
    1+every, 1+2*every, ... (the tick increments before user systems, and
    the first tick must produce commands).  ``full_rate_when(cols)`` returns
    a bool tensor; while any element is true the system runs every tick.

    Where the JAX package gates with ``lax.cond``, the port branches on the
    host, so the wrapped system really does not run on inactive ticks.
    ``BatchedCampaign`` lifts the gate outside its sample vmap and tracks
    the tick on the host; a RateGroup nested inside a vmap (whose tick is a
    batched tensor) runs both branches and selects, as ``lax.cond`` does
    under ``jax.vmap``."""

    def __init__(self, every: int, sys_obj, full_rate_when=None):
        if int(every) < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.every = int(every)
        self.system = as_system(sys_obj)
        self.full_rate_when = full_rate_when

    def active(self, tick: int, *parts: dict, join=None) -> bool:
        """The gate for a sample-uniform host ``tick``: on schedule, or
        escalated by ``full_rate_when`` in any element of any of ``parts``
        (the column dicts of a campaign's shards, each on its own device: one
        device read in all, taken only off schedule).  ``join`` (a campaign
        across processes: ``Comm.any``) joins this process's vote with every
        rank's."""
        if (tick - 1) % self.every == 0:
            return True
        if self.full_rate_when is None:
            return False
        votes = [torch.any(self.full_rate_when(cols)) for cols in parts]
        vote = bool(torch.stack([v.to(votes[0].device) for v in votes]).any())
        return join(vote) if join is not None else vote

    def _run(self, builder: SystemBuilder) -> dict:
        b = SystemBuilder(builder.world, dict(builder.cols))
        self.system.call(b)
        # a rate-gated system cannot introduce columns: they would exist
        # only on active ticks
        return {k: b.cols[k] for k in builder.cols}

    def call(self, builder: SystemBuilder) -> None:
        if self.every == 1:
            self.system.call(builder)
            return
        tick = builder.column("tick")[0]
        if torch._C._functorch.is_batchedtensor(tick):
            pred = (tick - 1) % self.every == 0
            if self.full_rate_when is not None:
                pred = pred | torch.any(self.full_rate_when(builder.cols))
            new = self._run(builder)
            builder.cols = {k: torch.where(_bcast_mask(pred, v.dim()), new[k], v)
                            for k, v in builder.cols.items()}
        elif self.active(int(tick), builder.cols,
                         join=builder.window.comm.any if builder.window else None):
            builder.cols = self._run(builder)

    def __repr__(self):
        return f"<every {self.every} {self.system!r}>"


def every(every_n: int, sys_obj, full_rate_when=None) -> System:
    """``el.every(5, guidance)``: run a system at 1/N of the sim rate with
    zero-order hold; see ``RateGroup``."""
    return RateGroup(every_n, sys_obj, full_rate_when)


def as_system(obj) -> System:
    """A System as is; None or () as the empty pipe; a Query-annotated
    function as an ``FnSystem``."""
    if isinstance(obj, System):
        return obj
    if obj is None or obj == ():
        return Pipe()
    if callable(obj):
        return system(obj)
    raise TypeError(f"cannot convert {obj!r} to a System")


def system(func) -> System:
    """The ``@el.system`` decorator."""
    return FnSystem(func)


def build_step(meta, sys_obj):
    """The one-tick step function ``state -> state``: increment_sim_tick
    piped before the user system."""
    from .six_dof import increment_sim_tick_system  # avoid import cycle

    full = Pipe(increment_sim_tick_system, as_system(sys_obj))

    def step(state):
        with span(TICK):
            b = SystemBuilder(meta, dict(state))
            full.call(b)
            return b.cols

    return step


# ---------------------------------------------------------------------------
# Query
# ---------------------------------------------------------------------------


def _intersect_ordered(lists: list[tuple[int, ...]]) -> list[int]:
    """Entity-id intersection, ascending (ids ascend within each column in
    spawn order)."""
    if not lists:
        return []
    out = set(lists[0])
    for other in lists[1:]:
        out &= set(other)
    return sorted(out)


class Query:
    """Typed multi-component query over the entity intersection."""

    def __class_getitem__(cls, item):
        if not isinstance(item, tuple):
            item = (item,)
        return _QueryAlias(cls, item)

    def __init__(self, builder, entity_ids, component_data, component_classes,
                 bufs, batch1, layout=None):
        self.builder = builder
        self.entity_ids = list(entity_ids)
        self.component_data = component_data
        self.component_classes = component_classes
        self.bufs = bufs
        self.batch1 = batch1
        # under a row window that cuts the query: (its entities on each
        # rank, all of them) -- SystemBuilder.query_layout
        self.layout = layout

    # -- annotation protocol ---------------------------------------------

    @staticmethod
    def component_ids(new_tp) -> list[str]:
        return [Component.name(t) for t in _args_of(new_tp)]

    @staticmethod
    def from_builder(new_tp, builder: SystemBuilder, args) -> "Query":
        t_args = _args_of(new_tp)
        component_data = [Component.of(t) for t in t_args]
        names = [c.name for c in component_data]
        entity_ids = _intersect_ordered([builder.entities_of(n) for n in names])
        if not entity_ids:
            raise RuntimeError(f"query over {names} matched no entities")
        layout = builder.query_layout(names)
        batch1 = len(entity_ids) == 1
        bufs = []
        for n in names:
            g = builder.gather(n, entity_ids)
            bufs.append(g[0] if batch1 else g)
        return Query(builder, entity_ids, component_data, list(t_args), bufs,
                     batch1, layout)

    # -- mapping ----------------------------------------------------------

    def _wrap_outputs(self, out_tps, bufs):
        out_tps = (out_tps,) if not isinstance(out_tps, tuple) else out_tps
        if len(bufs) != len(out_tps):
            raise RuntimeError(
                f"query returned {len(bufs)} component values for "
                f"{len(out_tps)} declared output types")
        component_data = [Component.of(t) for t in out_tps]
        return Query(self.builder, self.entity_ids, component_data,
                     list(out_tps), list(bufs), self.batch1, self.layout)

    def _args(self, bufs):
        return [from_array(c, b) for c, b in zip(self.component_classes, bufs)]

    def map(self, out_tps, f) -> "Query":
        """``f`` over the entity axis, under ``torch.func.vmap``."""
        if self.batch1:
            out = f(*self._args(self.bufs))
        else:
            out = vmap(lambda bs: f(*self._args(bs)))(self.bufs)
        return self._wrap_outputs(out_tps, pytree.tree_flatten(out)[0])

    def map_seq(self, out_tps, f) -> "Query":
        """``f`` entity by entity in a Python loop, so a Python branch in
        ``f`` takes only the path its entity needs (the JAX package scans
        with ``lax.scan`` to keep ``lax.cond`` short-circuiting)."""
        if self.batch1:
            bufs = pytree.tree_flatten(f(*self._args(self.bufs)))[0]
        else:
            rows = [pytree.tree_flatten(f(*self._args([b[i] for b in self.bufs])))[0]
                    for i in range(self.bufs[0].shape[0] if self.bufs else 0)]
            device = self.bufs[0].device if self.bufs else None
            bufs = [torch.stack([_as_leaf(x, device) for x in leaves])
                    for leaves in zip(*rows)]
        return self._wrap_outputs(out_tps, bufs)

    def join(self, other: "Query") -> "Query":
        """The entities of both queries (this query's order), with both
        queries' components."""
        oset = set(other.entity_ids)
        ids = [e for e in self.entity_ids if e in oset]
        if not ids:
            raise RuntimeError("joined query matched no entities")

        def regather(q: Query):
            if q.batch1:
                if q.entity_ids != ids:
                    raise RuntimeError("join dropped the only entity")
                return list(q.bufs)
            pos = {e: i for i, e in enumerate(q.entity_ids)}
            rows = [pos[e] for e in ids]
            if len(ids) == 1:
                return [b[rows[0]] for b in q.bufs]
            if rows == list(range(len(q.entity_ids))):
                return list(q.bufs)
            return [b[torch.as_tensor(rows, device=b.device)] for b in q.bufs]

        if ids == self.entity_ids:
            layout = self.layout
        elif ids == other.entity_ids:
            layout = other.layout
        elif self.layout is None and other.layout is None:
            layout = None
        else:
            raise NotImplementedError("a join of queries cut over ep that keeps only some "
                                      "of the rank's entities")
        return Query(self.builder, ids,
                     self.component_data + other.component_data,
                     self.component_classes + other.component_classes,
                     regather(self) + regather(other), len(ids) == 1, layout)

    def whole(self) -> "Query":
        """This query with every rank's entities, all-gathered in global
        order where a row window cuts it (itself otherwise)."""
        if self.layout is None:
            return self
        sizes, ids = self.layout
        comm = self.builder.window.comm
        bufs = [comm.all_gather_rows(b, sizes) for b in _batched(self)]
        batch1 = len(ids) == 1
        return Query(self.builder, ids, self.component_data, self.component_classes,
                     [b[0] for b in bufs] if batch1 else bufs, batch1)

    def output(self, builder: SystemBuilder, args) -> None:
        """Write each component back for the query's entities.  Under a row
        window a column that is not cut takes every rank's rows (one
        all-gather), so it stays identical on every rank."""
        window = builder.window
        for data, buf in zip(self.component_data, self.bufs):
            value = buf if not self.batch1 else torch.as_tensor(buf)[None]
            ids = self.entity_ids
            if self.layout is not None and data.name not in window.cut:
                sizes, ids = self.layout
                value = window.comm.all_gather_rows(value, sizes)
            builder.scatter(data.name, ids, value)

    def __getitem__(self, index: int):
        if len(self.bufs) > 1:
            raise Exception("Cannot index into a query with multiple inputs")
        cls = self.component_classes[0]
        buf = self.bufs[0]
        if self.batch1:
            return from_array(cls, buf)
        return from_array(cls, buf[index])

    def __len__(self):
        return len(self.entity_ids)


class _QueryAlias:
    """Parameterized ``Query[...]`` annotation carrying its component types;
    attribute access forwards to the query class."""

    def __init__(self, cls, args):
        self._cls = cls
        self.__args__ = args

    def __getattr__(self, name):
        return getattr(self._cls, name)

    def __repr__(self):
        return f"{self._cls.__name__}[{', '.join(repr(a) for a in self.__args__)}]"


def _args_of(tp) -> tuple:
    """Type arguments of a Query/GraphQuery alias or typing generic."""
    args = getattr(tp, "__args__", None)
    if args is not None:
        return tuple(args)
    return typing.get_args(tp)


# ---------------------------------------------------------------------------
# GraphQuery / edge_fold
# ---------------------------------------------------------------------------


def _batched(q: Query) -> list[torch.Tensor]:
    return [torch.as_tensor(b)[None] if q.batch1 else b for b in q.bufs]


def _bcast_mask(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """``mask`` with trailing unit axes up to ``ndim`` dimensions."""
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


class GraphQuery:
    """Edge-indexed query.  Explicit edges are static world data; a
    ``TotalEdge`` query stands for the complete digraph without listing its
    n^2 edges."""

    def __class_getitem__(cls, item):
        if not isinstance(item, tuple):
            item = (item,)
        return _QueryAlias(cls, item)

    def __init__(self, builder: SystemBuilder,
                 edges: list[tuple[int, int]] | None, total: bool = False):
        self.builder = builder
        self.edges = edges  # None for TotalEdge
        self.total = total
        # probe verdicts and fold set-ups shared across ticks (set by the
        # calling FnSystem); None probes, and builds, on every fold
        self.verdicts: dict | None = None
        self.setups: dict | None = None

    @staticmethod
    def component_ids(_new_tp) -> list[str]:
        return []

    @staticmethod
    def edge_ids(new_tp) -> list[str]:
        return [Component.name(t) for t in _args_of(new_tp) if t is not TotalEdge]

    @staticmethod
    def from_builder(new_tp, builder: SystemBuilder, args) -> "GraphQuery":
        edge_ty = _args_of(new_tp)[0]
        if edge_ty is TotalEdge:
            return GraphQuery(builder, None, total=True)
        name = Component.name(edge_ty)
        # RevEdge may sit anywhere in the metadata, before or after the
        # Component
        reverse = any(m is RevEdge for m in getattr(edge_ty, "__metadata__", ()))
        edge_vals = builder.world.edge_values(name)
        edges = [(b, a) for (a, b) in edge_vals] if reverse else list(edge_vals)
        return GraphQuery(builder, edges)

    def edge_fold(self, left_query: Query, right_query: Query, return_type,
                  init_value, fold_fn, additive: bool | None = None) -> Query:
        """Fold ``fold_fn(carry, *left, *right)`` over each left entity's
        edges, in edge order, left entities ascending; a left entity with no
        edge is not written.

        ``additive`` applies to ``TotalEdge`` queries: None probes the fold
        (``_fold_is_additive``, once per system, fold and argument shapes:
        ``_probe_once``) and sums the pairs densely when the carry
        enters additively; True sums densely without probing; False keeps
        the exact sequential fold.  ``ELODIN_EDGE_FOLD_DENSE=0`` turns the
        dense sum off everywhere.  Explicit-edge queries always fold
        exactly."""
        if self.total:
            return self._edge_fold_total(left_query, right_query, return_type,
                                         init_value, fold_fn, additive=additive)
        builder = left_query.builder
        # under a row window the left entities are the rank's, the right
        # ones every rank's: an edge may reach a row another rank holds
        right_query = right_query.whole()
        left_set = set(left_query.entity_ids)
        right_set = set(right_query.entity_ids)

        # edges grouped by left entity (ascending), edge order kept
        from_map: dict[int, list[int]] = {}
        for f, t in self.edges:
            if f in left_set and t in right_set:
                from_map.setdefault(f, []).append(t)
        from_ids = sorted(from_map)
        if not from_ids:
            raise RuntimeError("edge_fold matched no edges")
        max_e = max(len(v) for v in from_map.values())

        lpos = {e: i for i, e in enumerate(left_query.entity_ids)}
        rpos = {e: i for i, e in enumerate(right_query.entity_ids)}
        n_from = len(from_ids)
        left_rows = [lpos[f] for f in from_ids]
        right_rows = np.zeros((n_from, max_e), dtype=np.int64)
        mask = np.zeros((n_from, max_e), dtype=bool)
        for i, f in enumerate(from_ids):
            tos = from_map[f]
            # pad with the last real edge so fold_fn sees finite values
            right_rows[i] = [rpos[t] for t in tos] + [rpos[tos[-1]]] * (max_e - len(tos))
            mask[i, :len(tos)] = True

        lbufs, rbufs = _batched(left_query), _batched(right_query)
        device = lbufs[0].device
        left_vals = [b[torch.as_tensor(left_rows, device=device)] for b in lbufs]
        right_vals = [
            b[torch.as_tensor(right_rows.reshape(-1), device=device)].reshape(
                (n_from, max_e) + b.shape[1:]) for b in rbufs]
        mask_t = torch.as_tensor(mask, device=device)

        init_flat, init_spec = pytree.tree_flatten(init_value)
        init = [_as_leaf(x, device) for x in init_flat]

        def step(carry_flat, lvals, rvals):
            new = fold_fn(pytree.tree_unflatten(carry_flat, init_spec),
                          *left_query._args(lvals), *right_query._args(rvals))
            return pytree.tree_flatten(new)[0]

        # the sequential scan over each entity's edges, vectorized over the
        # left entities
        carry = [x.expand((n_from,) + x.shape) for x in init]
        for j in range(max_e):
            new = vmap(step)(carry, left_vals, [rv[:, j] for rv in right_vals])
            carry = [torch.where(_bcast_mask(mask_t[:, j], n.dim()), n, c)
                     for n, c in zip(new, carry)]

        buf = carry[0]
        return _fold_result(builder, left_query, from_ids, return_type, buf)

    # -- complete-graph path ----------------------------------------------

    def _fold_is_additive(self, left_query: Query, right_query: Query,
                          init_value, fold_fn) -> bool:
        """Numeric probe: does ``fold_fn(c, l, r) == c + fold_fn(0, l, r)``
        hold at three magnitudes (1, 1e3, 1e-3) of random carries and
        arguments?  Physics folds (force and torque accumulation) are
        additive in the carry, which lets the sequential fold reassociate
        into a dense masked sum.  The draws are the JAX package's: the same
        generator, seed and order, so both packages classify a fold alike.
        Any doubt (an exception, a non-finite value) means the exact
        sequential fold.  Kill switch: ``ELODIN_EDGE_FOLD_DENSE=0``."""
        if os.environ.get("ELODIN_EDGE_FOLD_DENSE", "1") == "0":
            return False
        TOTAL_FOLDS["probes"] += 1
        bufs = list(left_query.bufs) + list(right_query.bufs)
        device = bufs[0].device if bufs else None
        init_flat, init_spec = pytree.tree_flatten(init_value)
        rng = np.random.default_rng(0x5EED)

        def draw(shape, dtype, scale):
            return torch.as_tensor(scale * rng.standard_normal(tuple(shape)),
                                   dtype=dtype, device=device)

        def draws(q: Query, scale):
            return [from_array(c, draw(b.shape if q.batch1 else b.shape[1:],
                                       b.dtype, scale))
                    for c, b in zip(q.component_classes, q.bufs)]

        try:
            init = [_as_leaf(x, device) for x in init_flat]
            for scale in (1.0, 1e3, 1e-3):
                largs = draws(left_query, scale)
                rargs = draws(right_query, scale)
                carry = [draw(x.shape, x.dtype, scale) for x in init]
                zero = [torch.zeros_like(x) for x in init]
                out_c = pytree.tree_flatten(fold_fn(
                    pytree.tree_unflatten(carry, init_spec), *largs, *rargs))[0]
                out_z = pytree.tree_flatten(fold_fn(
                    pytree.tree_unflatten(zero, init_spec), *largs, *rargs))[0]
                for oc, oz, c in zip(out_c, out_z, carry):
                    oc, oz, c = _np(oc), _np(oz), _np(c)
                    if not (np.isfinite(oc).all() and np.isfinite(oz).all()):
                        return False
                    tol = 1e-9 * np.maximum(np.abs(oc).max(), 1.0)
                    if np.abs(oc - (c + oz)).max() > tol:
                        return False
            return True
        except Exception:
            return False

    def _probe_once(self, left_query: Query, right_query: Query, init,
                    init_spec, init_value, fold_fn) -> bool:
        """``_fold_is_additive``, run once per fold code and argument
        shapes within the calling system: the JAX package probes once per
        trace, where the port would otherwise probe on every eager tick.  A
        fold whose closure holds anything but constants, modules and
        classes is probed on every call."""
        cells = [c.cell_contents for c in getattr(fold_fn, "__closure__", None) or ()]
        code = getattr(fold_fn, "__code__", None)
        if self.verdicts is None or code is None or not all(
                isinstance(v, (bool, int, float, str, type, types.ModuleType))
                or v is None for v in cells):
            return self._probe(left_query, right_query, init_value, fold_fn)

        def shapes(tensors):
            return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)

        key = (code, tuple(cells), str(init_spec), shapes(init),
               tuple(left_query.component_classes), left_query.batch1,
               shapes(left_query.bufs), tuple(right_query.component_classes),
               right_query.batch1, shapes(right_query.bufs))
        if key not in self.verdicts:
            self.verdicts[key] = self._probe(left_query, right_query, init_value, fold_fn)
        return self.verdicts[key]

    def _probe(self, left_query: Query, right_query: Query, init_value, fold_fn) -> bool:
        """``_fold_is_additive``; under a row window every rank must reach
        the same verdict (its draws do not depend on the rank's rows), which
        one all-reduce checks."""
        with span(FOLD_PROBE):
            verdict = self._fold_is_additive(left_query, right_query, init_value, fold_fn)
            window = left_query.builder.window
            if window is not None:
                verdict = window.comm.agree(verdict, "the additive probe's verdict")
            return verdict

    def _setup(self, left_query: Query, rids: tuple, device) -> _FoldSetup:
        """The fold's ``_FoldSetup``: the one the calling system keeps for
        these left and right ids, this device and row window, or a new one
        (kept, the oldest of ``FOLD_SETUP_CAP`` dropped).  A hit compares the
        id sequences in C; a spawn or despawn changes them and builds anew."""
        layout = left_query.layout
        window = None if layout is None else (
            left_query.builder.window.comm.index, tuple(layout[0]))
        key = (tuple(left_query.entity_ids), rids, device, window)
        setups = self.setups
        setup = None if setups is None else setups.get(key)
        if setup is not None:
            FOLD_SETUPS["reused"] += 1
            return setup
        setup = _FoldSetup(key[0], rids, device)
        FOLD_SETUPS["built"] += 1
        if setups is not None:
            if len(setups) >= FOLD_SETUP_CAP:
                del setups[next(iter(setups))]
            setups[key] = setup
        return setup

    def _edge_fold_total(self, left_query: Query, right_query: Query,
                         return_type, init_value, fold_fn,
                         additive: bool | None = None) -> Query:
        """TotalEdge edge_fold without an edge list.  Additive folds run as
        a dense masked sum over chunks of ``DENSE_FOLD_CHUNK`` right-hand
        entities (nested ``vmap`` inside a chunk, so intermediates stay
        O(n_left x chunk)); other folds run the exact sequential fold over
        the right-hand entities, vectorized over the left ones.  Each call
        adds one to ``TOTAL_FOLDS`` under the path it took."""
        builder = left_query.builder
        # under a row window: the rank's left entities against every rank's
        # right ones, in global order, so each left row sums the same chunks
        # in the same order as the unsharded fold
        right_query = right_query.whole()
        rids = tuple(right_query.entity_ids)
        lbufs, rbufs = _batched(left_query), _batched(right_query)
        device = lbufs[0].device
        init_flat, init_spec = pytree.tree_flatten(init_value)
        with span(FOLD_SETUP):
            setup = self._setup(left_query, rids, device)
            init = setup.initial_carry(init_flat, device)
        from_ids, lid, rid = setup.from_ids, setup.lid, setup.rid
        if setup.keep is not None:
            lbufs = [b[setup.keep] for b in lbufs]
        n_i, n_j = len(from_ids), len(rids)

        if os.environ.get("ELODIN_EDGE_FOLD_DENSE", "1") == "0":
            additive = False  # the global kill switch wins over additive=True
        elif additive is None:
            additive = self._probe_once(left_query, right_query, init,
                                        init_spec, init_value, fold_fn)

        # stand-in right-hand values for the masked (self and padding)
        # pairs: a real other entity's, right entity 0 or the last one when
        # the left entity is entity 0, so fold_fn never sees a zero distance
        alt = [torch.where(_bcast_mask(setup.is_r0, b.dim()), b[-1], b[0]) for b in rbufs]

        def fold_args(lvals, rvals):
            return left_query._args(lvals) + right_query._args(rvals)

        if additive:
            with span(FOLD_DENSE):
                TOTAL_FOLDS["dense"] += 1
                zero = pytree.tree_unflatten([torch.zeros_like(x) for x in init],
                                             init_spec)

                def contrib(lvals, alt_vals, rvals, m):
                    rvals = [torch.where(m, rv, a) for rv, a in zip(rvals, alt_vals)]
                    return pytree.tree_flatten(fold_fn(zero, *fold_args(lvals, rvals)))[0]

                pair = vmap(vmap(contrib, in_dims=(None, None, 0, 0)),  # over j
                            in_dims=(0, 0, None, 0))  # over i
                chunk = min(n_j, DENSE_FOLD_CHUNK)
                n_chunks = -(-n_j // chunk)
                pad = n_chunks * chunk - n_j
                if pad:
                    rbufs = [torch.cat([b, b[:1].expand((pad,) + b.shape[1:])])
                             for b in rbufs]
                    rid = torch.cat([rid, torch.full((pad,), -1, dtype=torch.int64,
                                                     device=device)])
                acc = [x.expand((n_i,) + x.shape) for x in init]
                for c in range(n_chunks):
                    part = slice(c * chunk, (c + 1) * chunk)
                    rid_c = rid[part]
                    mask = (lid[:, None] != rid_c[None, :]) & (rid_c[None, :] >= 0)
                    outs = pair(lbufs, alt, [b[part] for b in rbufs], mask)
                    acc = [a + torch.where(_bcast_mask(mask, o.dim()), o, 0).sum(dim=1)
                           for a, o in zip(acc, outs)]
                out_flat = acc
        else:
            TOTAL_FOLDS["sequential"] += 1

            def body(carry_flat, lvals, alt_vals, rvals, keep):
                rvals = [torch.where(keep, v, a) for v, a in zip(rvals, alt_vals)]
                new = fold_fn(pytree.tree_unflatten(carry_flat, init_spec),
                              *fold_args(lvals, rvals))
                return [torch.where(keep, n, c)
                        for n, c in zip(pytree.tree_flatten(new)[0], carry_flat)]

            step = vmap(body, in_dims=(0, 0, 0, None, 0))
            out_flat = [x.expand((n_i,) + x.shape) for x in init]
            for j in range(n_j):
                out_flat = step(out_flat, lbufs, alt, [b[j] for b in rbufs],
                                lid != rids[j])

        return _fold_result(builder, left_query, from_ids, return_type, out_flat[0])


def _fold_result(builder: SystemBuilder, left_query: Query, from_ids, return_type,
                 buf) -> Query:
    """An edge fold's result over the left entities ``from_ids``; under a
    row window it keeps the left query's layout, which needs every left
    entity to have an edge."""
    layout = None
    if left_query.layout is not None:
        if list(from_ids) != left_query.entity_ids:
            raise NotImplementedError("an edge fold cut over ep in which some of the rank's "
                                      "left entities have no edge")
        layout = left_query.layout
    batch1 = len(from_ids) == 1
    return Query(builder, from_ids, [Component.of(return_type)], [return_type],
                 [buf[0] if batch1 else buf], batch1, layout)


# ---------------------------------------------------------------------------
# map decorators
# ---------------------------------------------------------------------------


def _map_decorator(func, seq: bool) -> System:
    """A one-query ``FnSystem`` over ``func``'s annotated parameters, whose
    return annotation (one component or a ``tuple[...]`` of them) names the
    outputs."""
    sig = inspect.signature(func)
    tys = [p.annotation for p in sig.parameters.values()]
    return_ty = sig.return_annotation
    if isinstance(return_ty, types.GenericAlias):
        return_ty = tuple(return_ty.__args__)

    def inner(q):
        if seq:
            return q.map_seq(return_ty, func)
        return q.map(return_ty, func)

    inner.__name__ = getattr(func, "__name__", "map")
    inner.__signature__ = inspect.Signature(
        parameters=[inspect.Parameter(
            "q", inspect.Parameter.POSITIONAL_OR_KEYWORD, annotation=Query[tuple(tys)])],
        return_annotation=Query[return_ty if isinstance(return_ty, tuple) else (return_ty,)],
    )
    return FnSystem(inner, name=inner.__name__)


def map(func) -> System:  # noqa: A001  (the el.map decorator)
    """``@el.map``: ``func`` over every entity that has all of its
    parameters' components, under ``torch.func.vmap``."""
    return _map_decorator(func, seq=False)


def map_seq(func) -> System:
    """``@el.map_seq``: as ``map``, entity by entity (``Query.map_seq``)."""
    return _map_decorator(func, seq=True)
