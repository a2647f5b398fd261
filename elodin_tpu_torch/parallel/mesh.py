"""Device meshes for the sample and entity axes (counterpart of
``elodin_tpu/parallel/mesh.py``).

A ``Mesh`` is a grid of torch devices with named axes, as a
``jax.sharding.Mesh`` is:

* ``dp`` -- the sample axis of a batched campaign (no collectives),
* ``ep`` -- the entity axis within one world.

The JAX package jits a step over the mesh, and GSPMD inserts whatever
collectives the step needs.  The port runs eagerly: a placed column
(``Sharded``) is one tensor a shard, each on its own device, and
``sharded_step`` calls the step once a shard, in turn, from the calling
thread (each device runs its shard's launches asynchronously).

In one process that runs the splits that need no collective: samples over
``dp``, or over the mesh's first axis when it has no ``dp``.  Rows split
over ``ep`` need one process a device along that axis: in an eager tick the
exchange must happen where a fold reads (four times a tick under RK4), so
the shards advance in lockstep, which shards stepped one after another from
one thread cannot do.  After ``init_multihost`` (``parallel/distributed.py``,
one process a device list, ``distributed.launch`` starts them),
``make_mesh()`` spans every rank's devices in rank order; a ``Sharded``
then holds only this rank's shards (``addressable_shards``, each with its
index into the global shape), and a step whose rows are cut over ``ep``
runs under the rank's ``RowWindow``: ``SystemBuilder`` serves the rank's
rows, folds all-gather their right-hand side, and joins all-reduce.  A mesh
whose ``ep`` axis holds two devices of one process raises
``NotImplementedError``.

``make_mesh(devices=...)`` takes the devices as given, the port's
counterpart of XLA's ``--xla_force_host_platform_device_count``:
``["cpu"] * 8`` builds an 8-device mesh on the host, ``["cuda:0"] * 4``
four shards on one card.  Without it the mesh takes the job's devices
after ``init_multihost``, else the visible CUDA cards, and raises when
there are none or fewer than asked.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from . import distributed


class Mesh:
    """A grid of torch devices with one name an axis; ``shape`` maps each
    axis name to its size, in axis order.  ``owners`` (a mesh across
    processes) is the grid of the rank that holds each device; None: every
    device is this process's."""

    def __init__(self, devices, axis_names, owners=None):
        grid = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs {grid.ndim} axis names, "
                             f"got {self.axis_names}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            self.devices[idx] = torch.device(d)
        self.owners = None
        if owners is not None:
            self.owners = np.asarray(owners, dtype=np.int64).reshape(grid.shape)
            self._make_groups()

    @property
    def distributed(self) -> bool:
        """Built over a ``torch.distributed`` job (``owners`` is set)."""
        return self.owners is not None

    @property
    def process_index(self) -> int:
        return distributed.process().rank if self.distributed else 0

    def _make_groups(self) -> None:
        """Form the process group of every line of every axis, on every rank
        in the same order (``new_group`` is collective)."""
        for k in range(len(self.axis_names)):
            for line in self._lines(k):
                distributed._group(tuple(sorted(set(line))))

    def _lines(self, k: int):
        """The owners along axis ``k`` at every index of the other axes."""
        moved = np.moveaxis(self.owners, k, -1)
        return [tuple(int(r) for r in line) for line in moved.reshape(-1, moved.shape[-1])]

    def local_positions(self) -> list[tuple[int, ...]]:
        """The grid positions of this process's devices, in grid order."""
        if not self.distributed:
            return [idx for idx, _ in np.ndenumerate(self.devices)]
        rank = self.process_index
        return [idx for idx, r in np.ndenumerate(self.owners) if r == rank]

    def line(self, axis: str, position=None) -> list[tuple[int, ...]]:
        """The grid positions along ``axis`` through ``position`` (default:
        index 0 of the other axes)."""
        k = self.axis_names.index(axis)
        base = list(position) if position is not None else [0] * len(self.axis_names)
        return [tuple(base[:k] + [i] + base[k + 1:]) for i in range(self.devices.shape[k])]

    def line_owners(self, axis: str, position=None) -> list[int]:
        """The rank of each device along ``axis`` through ``position``
        (default: index 0 of the other axes, ``axis_devices``' line)."""
        return [int(self.owners[q]) for q in self.line(axis, position)]

    def line_comm(self, axis: str, position) -> "distributed.Comm":
        """The collectives of the ranks along ``axis`` through ``position``
        (one rank a device: raises ``NotImplementedError`` where the line
        holds two devices of one process)."""
        owners = self.line_owners(axis, position)
        if len(set(owners)) != len(owners):
            raise NotImplementedError(_one_process_a_device(self, axis))
        return distributed.Comm(owners)

    def rank_blocks(self, axis: str, n: int):
        """``n`` rows cut into one block a device along ``axis`` (at index 0
        of the other axes; by ``row_blocks``, the rule ``shard_index``
        places by) on a mesh across processes: (this rank's [(device,
        (start, stop))], the rows each rank of the axis holds, the
        collectives of those ranks).  Raises ``ValueError`` when this rank
        holds no device of the axis."""
        devices = self.axis_devices(axis)
        owners = self.line_owners(axis)
        blocks = row_blocks(n, len(devices))
        ranks = sorted(set(owners))
        rank = self.process_index
        if rank not in ranks:
            raise ValueError(f"rank {rank} holds no device of the mesh's {axis} axis")
        mine = [(d, b) for d, b, r in zip(devices, blocks, owners) if r == rank]
        sizes = [sum(b - a for (a, b), r in zip(blocks, owners) if r == q) for q in ranks]
        return mine, sizes, distributed.Comm(ranks)

    def comm(self) -> "distributed.Comm":
        """The collectives of every rank of the mesh."""
        return distributed.Comm(sorted({int(r) for r in self.owners.flat}))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis: one
        device a shard of a column cut over ``axis``."""
        return [self.devices[q] for q in self.line(axis)]

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def __repr__(self):
        ranks = "" if self.owners is None else f", ranks={self.owners.flatten().tolist()}"
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}{ranks})"


def _one_process_a_device(mesh: Mesh, axis: str) -> str:
    return (f"rows split over the mesh's {axis} axis ({mesh.shape[axis]} devices) need one "
            f"process a device along it: the shards of an eager tick exchange rows where a "
            f"fold reads, in lockstep.  Start one process a device "
            f"(elodin_tpu_torch.parallel.distributed.launch, or init_multihost in each), "
            f"then make_mesh(ep=...) spans them; in one process build the mesh with "
            f"{axis}=1")


class NamedSharding:
    """Where a column goes on a mesh: ``spec[d]`` names the mesh axis that
    dimension ``d`` is cut over, or is None (that dimension stays whole), as
    ``jax.sharding.NamedSharding(mesh, PartitionSpec(*spec))``."""

    def __init__(self, mesh: Mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def cuts(self) -> list[tuple[int, str]]:
        """(dimension, axis) of each cut this sharding makes: on a mesh in
        one process those across more than one device (at most one, and
        never over ``ep``: ``NotImplementedError``), on a mesh across
        processes every axis the spec names."""
        mesh = self.mesh
        cuts = [(d, a) for d, a in enumerate(self.spec)
                if a is not None and (mesh.distributed or mesh.shape[a] > 1)]
        if mesh.distributed:
            for _, a in cuts:
                k = mesh.axis_names.index(a)
                if a == "ep" and any(len(set(line)) != len(line) for line in mesh._lines(k)):
                    raise NotImplementedError(_one_process_a_device(mesh, a))
            return cuts
        for _, a in cuts:
            if a == "ep":
                raise NotImplementedError(_one_process_a_device(mesh, a))
        if len(cuts) > 1:
            raise NotImplementedError(f"a column cut over two mesh axes in one process: "
                                      f"{self.spec}")
        return cuts

    def split(self) -> tuple[int, str] | None:
        """(dimension, axis) of the one cut this sharding makes on a mesh
        in one process, or None when every shard holds the whole column."""
        cuts = self.cuts()
        return cuts[0] if cuts else None

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, spec={self.spec})"


class Shard(NamedTuple):
    """One addressable shard of a ``Sharded`` (``jax.Shard``'s fields):
    its tensor, its device, and its index (a slice a dimension) into the
    global shape."""
    data: torch.Tensor
    device: torch.device
    index: tuple


class Sharded:
    """A column placed on a mesh.  In one process ``shards[k]`` is shard
    k's part on ``devices[k]``, cut along dimension ``dim`` (``dim`` None:
    one shard, the whole column on the mesh's first device).  On a mesh
    across processes it holds this rank's shards only, one a device of the
    rank (``indices[k]`` places shard k in ``global_shape``), and
    ``dim`` is None.  ``gather(device)`` puts a whole column back together
    on one device and ``np.asarray`` reads it on the host; both raise for a
    column that spans other processes, as JAX does: read
    ``addressable_shards`` there."""

    def __init__(self, sharding: NamedSharding, shards, dim: int | None, *,
                 indices=None, global_shape=None):
        self.sharding = sharding
        self.shards = list(shards)
        self.dim = dim
        self.indices = indices
        self.global_shape = global_shape

    @property
    def devices(self) -> list[torch.device]:
        return [s.device for s in self.shards]

    @property
    def shape(self) -> tuple[int, ...]:
        if self.global_shape is not None:
            return tuple(self.global_shape)
        shape = list(self.shards[0].shape)
        if self.dim is not None:
            shape[self.dim] = sum(s.shape[self.dim] for s in self.shards)
        return tuple(shape)

    @property
    def is_fully_addressable(self) -> bool:
        return not self.sharding.mesh.distributed

    @property
    def addressable_shards(self) -> list[Shard]:
        if self.indices is not None:
            return [Shard(t, t.device, i) for t, i in zip(self.shards, self.indices)]
        out, start = [], 0
        for t in self.shards:
            index = [slice(None)] * t.dim()
            if self.dim is not None:
                index[self.dim] = slice(start, start + t.shape[self.dim])
                start += t.shape[self.dim]
            out.append(Shard(t, t.device, tuple(index)))
        return out

    def gather(self, device=None) -> torch.Tensor:
        """The whole column on ``device`` (default: the mesh's first)."""
        if not self.is_fully_addressable:
            raise RuntimeError("a column placed on a mesh across processes spans devices of "
                               "other processes; read its addressable_shards")
        device = device if device is not None else self.sharding.mesh.first_device
        return gather(self.shards, device, self.dim or 0)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.gather("cpu").numpy(), dtype=dtype)

    def __repr__(self):
        return f"Sharded(shape={self.shape}, dim={self.dim}, devices={self.devices})"


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device (nothing for
    a CPU device): tensors a step makes without a device land on its card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def send(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``.  A copy to a card is queued without waiting (it
    is ordered on the cards' streams); a copy to the host waits for it to
    land, as a non-blocking one would hand back memory still being
    written."""
    device = torch.device(device)
    return t.to(device, non_blocking=device.type == "cuda")


def gather(parts, device, dim: int = 0) -> torch.Tensor:
    """The tensors ``parts`` (one a shard, on any devices) joined along
    ``dim`` on ``device``."""
    if len(parts) == 1:
        return send(parts[0], device)
    return torch.cat([send(p, device) for p in parts], dim=dim)


def row_blocks(n: int, parts: int) -> list[tuple[int, int]]:
    """``n`` rows cut into ``parts`` contiguous blocks [start, stop) whose
    sizes differ by at most one, the larger first; a block may be empty
    when ``n < parts``."""
    base, extra = divmod(n, parts)
    out, start = [], 0
    for k in range(parts):
        stop = start + base + (k < extra)
        out.append((start, stop))
        start = stop
    return out


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              ep: int | None = None, *, devices=None) -> Mesh:
    """A (dp, ep) device mesh; dp-only (``ep=1``) by default, as the JAX
    package's.  ``devices`` gives the devices (repeats allowed: shards on one
    card, or on the host).  Without it the mesh takes every rank's devices
    in rank order after ``init_multihost`` (all of them: a mesh across
    processes spans every rank), else the first ``n_devices`` visible CUDA
    cards, and raises when there are fewer, or none."""
    job = distributed.process() if devices is None else None
    owners = None
    if job is not None:
        owners = [r for r, _ in job.global_devices]
        available = [d for _, d in job.global_devices]
    elif devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA card is visible; pass devices= "
                               "(e.g. ['cpu'] * 8) for a mesh on the host")
        available = [torch.device("cuda", i) for i in range(count)]
    else:
        available = [torch.device(d) for d in devices]
    n = n_devices or len(available)
    if n > len(available):
        raise ValueError(f"make_mesh: {n} devices asked, {len(available)} available")
    if owners is not None and set(owners[:n]) != set(owners):
        raise ValueError(f"make_mesh: a mesh across processes spans every rank's devices; "
                         f"{n} of {len(available)} leave a rank out")
    if dp is None and ep is None:
        dp, ep = n, 1
    elif dp is None:
        dp = n // ep
    elif ep is None:
        ep = n // dp
    if dp * ep != n:
        raise ValueError(f"mesh {dp}x{ep} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = available[:n]
    return Mesh(grid.reshape(dp, ep), ("dp", "ep"),
                owners=None if owners is None else owners[:n])


def entity_sharding(mesh: Mesh, rows: int, ndim: int,
                    sample_axis: bool = False) -> NamedSharding:
    """The sharding of one component column, decided as the JAX package
    decides it.  Without a sample axis the column is (rows, *shape): rows
    over 'ep' when the mesh has it and they divide it, else whole.  With a
    sample axis the column is (samples, rows, *shape): samples over 'dp'
    (or the mesh's first axis), rows as before."""
    ep = mesh.shape.get("ep", 1)
    row_spec = "ep" if "ep" in mesh.shape and rows > 1 and rows % ep == 0 else None
    if sample_axis:
        sample_spec = "dp" if "dp" in mesh.shape else mesh.axis_names[0]
        return NamedSharding(mesh, (sample_spec, row_spec) + (None,) * (ndim - 2))
    return NamedSharding(mesh, (row_spec,) + (None,) * (ndim - 1))


def put_global(sharding: NamedSharding, arr) -> Sharded:
    """Place a whole column (numpy or a tensor) on ``sharding``: cut into
    equal parts, one on each device along the cut's axis, or whole on the
    mesh's first device.  On a mesh across processes each rank keeps only
    its own devices' parts, sliced from the whole column it was given (the
    JAX package's ``make_array_from_callback`` path).  A dimension the axis
    does not divide raises ``ValueError``, as ``jax.device_put`` does."""
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(np.asarray(arr))
    mesh = sharding.mesh
    cuts = sharding.cuts()
    for dim, axis in cuts:
        parts, size = mesh.shape[axis], t.shape[dim]
        if size % parts:
            raise ValueError(f"sharding {sharding.spec} cuts dimension {dim} over the "
                             f"{parts} devices of axis {axis!r}, which must divide its "
                             f"size {size} (full shape {tuple(t.shape)})")
    if mesh.distributed:
        positions = mesh.local_positions()
        indices = [shard_index(sharding, t.shape, p) for p in positions]
        shards = [send(t[i], mesh.devices[p]).contiguous() for i, p in zip(indices, positions)]
        return Sharded(sharding, shards, None, indices=indices, global_shape=tuple(t.shape))
    if not cuts:
        return Sharded(sharding, [t.to(mesh.first_device)], None)
    dim, axis = cuts[0]
    return Sharded(sharding, [send(t[shard_index(sharding, t.shape, p)], mesh.devices[p])
                              .contiguous() for p in mesh.line(axis)], dim)


def shard_index(sharding: NamedSharding, shape, position) -> tuple:
    """The index (a slice a dimension) into a column of ``shape`` of the
    shard that ``sharding`` places at grid ``position``: ``row_blocks`` of
    each cut dimension.  The one rule of which rows a device holds:
    ``put_global`` places by it and ``row_windows`` reads it."""
    mesh = sharding.mesh
    index = [slice(None)] * len(shape)
    for dim, axis in sharding.cuts():
        k = position[mesh.axis_names.index(axis)]
        start, stop = row_blocks(shape[dim], mesh.shape[axis])[k]
        index[dim] = slice(start, stop)
    return tuple(index)


def shard_cols(mesh: Mesh, cols: dict, sample_axis: bool = False) -> dict[str, Sharded]:
    """Place a column dict onto the mesh, each column by
    ``entity_sharding``."""
    out = {}
    for name, v in cols.items():
        rows = v.shape[1] if sample_axis else v.shape[0]
        out[name] = put_global(entity_sharding(mesh, rows, len(v.shape), sample_axis), v)
    return out


def sharded_step(step_fn, mesh: Mesh, cols: dict, sample_axis: bool = False):
    """(fn, placed): ``placed`` is ``cols`` on the mesh (``shard_cols``) and
    ``fn(placed)`` runs ``step_fn`` on every shard's columns and returns its
    columns placed as the inputs were.

    In one process each shard's call sees only its own part of a cut
    column, so ``step_fn`` must act on each sample (each row of the cut
    dimension) on its own, as a vmapped tick does: no collective joins the
    shards.  The shards are called in turn from this thread; each call is
    issued under its device and runs there asynchronously.  A step whose
    columns are all whole runs once, on the mesh's first device.

    On a mesh across processes every rank calls ``fn`` with its own shards
    (``addressable_shards``), and a shard whose entity rows are cut over
    ``ep`` runs ``step_fn`` under its ``RowWindow``: a ``SystemBuilder``
    made inside it serves the rank's rows, and its folds and joins reach
    the other ranks' rows through the window's collectives."""
    placed = shard_cols(mesh, cols, sample_axis)
    if mesh.distributed:
        return _distributed_step(step_fn, mesh, placed, 1 if sample_axis else 0), placed

    def fn(state: dict) -> dict:
        cut = [c for c in state.values() if c.dim is not None]
        devices = cut[0].devices if cut else [mesh.first_device]
        for c in cut:
            if c.devices != devices:
                raise ValueError(f"columns cut over different devices: {c.devices} "
                                 f"and {devices}")
        outs = []
        for k, device in enumerate(devices):
            with on_device(device):
                outs.append(step_fn({name: c.shards[k] if c.dim is not None
                                     else c.gather(device) for name, c in state.items()}))
        return {name: Sharded(state[name].sharding, [o[name] for o in outs],
                              state[name].dim) if state[name].dim is not None
                else Sharded(state[name].sharding, [outs[0][name]], None)
                for name in outs[0]}

    return fn, placed


def row_windows(mesh: Mesh, placed: dict, row_dim: int) -> list:
    """The ``RowWindow`` of each of this rank's devices (in
    ``local_positions`` order) for the columns ``placed`` (name ->
    ``Sharded``) on a mesh across processes, whose entity rows are
    dimension ``row_dim``: each cut column's rows on every device of the
    ``ep`` line, by ``shard_index`` as ``put_global`` placed them.  None for
    every device when no column's rows are cut over ``ep``."""
    cut = {name: c for name, c in placed.items()
           if c.sharding.spec[row_dim:row_dim + 1] == ("ep",) and c.sharding.cuts()}
    if not cut:
        return [None] * len(mesh.local_positions())
    windows = []
    for p in mesh.local_positions():
        blocks = {}
        for name, c in cut.items():
            rows = [shard_index(c.sharding, c.global_shape, q)[row_dim]
                    for q in mesh.line("ep", p)]
            blocks[name] = [(r.start, r.stop) for r in rows]
        windows.append(distributed.RowWindow(mesh.line_comm("ep", p), blocks))
    return windows


def _distributed_step(step_fn, mesh: Mesh, placed: dict, row_dim: int):
    positions = mesh.local_positions()
    windows = row_windows(mesh, placed, row_dim)

    def fn(state: dict) -> dict:
        outs = []
        for k, (position, window) in enumerate(zip(positions, windows)):
            with on_device(mesh.devices[position]), distributed.row_window(window):
                outs.append(step_fn({name: c.shards[k] for name, c in state.items()}))
        return {name: Sharded(state[name].sharding, [o[name] for o in outs], None,
                              indices=state[name].indices,
                              global_shape=state[name].global_shape)
                for name in outs[0]}

    return fn
