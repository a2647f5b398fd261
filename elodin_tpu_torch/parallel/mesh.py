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
thread (each device runs its shard's launches asynchronously).  So it runs
the splits that need no collective: samples over ``dp``, or over the mesh's
first axis when it has no ``dp``.  A column whose rows would split over an
``ep`` axis of more than one device raises ``NotImplementedError``, as does
``init_multihost``: both wait for ``torch.distributed``, one process a card
(``ROADMAP.md`` §1, "the ep axis and init_multihost").

``make_mesh(devices=...)`` takes the devices as given, the port's
counterpart of XLA's ``--xla_force_host_platform_device_count``:
``["cpu"] * 8`` builds an 8-device mesh on the host, ``["cuda:0"] * 4``
four shards on one card.  Without it the mesh takes the visible CUDA cards,
and raises when there are none or fewer than asked.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


class Mesh:
    """A grid of torch devices with one name an axis; ``shape`` maps each
    axis name to its size, in axis order."""

    def __init__(self, devices, axis_names):
        grid = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs {grid.ndim} axis names, "
                             f"got {self.axis_names}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            self.devices[idx] = torch.device(d)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis: one
        device a shard of a column cut over ``axis``."""
        k = self.axis_names.index(axis)
        index = [0] * len(self.axis_names)
        out = []
        for i in range(self.devices.shape[k]):
            index[k] = i
            out.append(self.devices[tuple(index)])
        return out

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


class NamedSharding:
    """Where a column goes on a mesh: ``spec[d]`` names the mesh axis that
    dimension ``d`` is cut over, or is None (that dimension stays whole), as
    ``jax.sharding.NamedSharding(mesh, PartitionSpec(*spec))``."""

    def __init__(self, mesh: Mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def split(self) -> tuple[int, str] | None:
        """(dimension, axis) of the one cut this sharding makes across more
        than one device, or None when every shard holds the whole column.
        Raises ``NotImplementedError`` for a cut over ``ep``, or over two
        axes."""
        cuts = [(d, a) for d, a in enumerate(self.spec)
                if a is not None and self.mesh.shape[a] > 1]
        for _, a in cuts:
            if a == "ep":
                raise NotImplementedError(
                    f"rows split over the mesh's ep axis ({self.mesh.shape['ep']} devices) "
                    "need collectives between shards, which wait for torch.distributed "
                    "(ROADMAP.md §1, the ep axis and init_multihost); build the mesh with "
                    "ep=1")
        if len(cuts) > 1:
            raise NotImplementedError(f"a column cut over two mesh axes: {self.spec}")
        return cuts[0] if cuts else None

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, spec={self.spec})"


class Sharded:
    """A column placed on a mesh: ``shards[k]`` is shard k's part on
    ``devices[k]``, cut along dimension ``dim`` (``dim`` None: one shard, the
    whole column on the mesh's first device).  ``gather(device)`` puts the
    whole column back together on one device; ``np.asarray`` reads it on the
    host."""

    def __init__(self, sharding: NamedSharding, shards, dim: int | None):
        self.sharding = sharding
        self.shards = list(shards)
        self.dim = dim

    @property
    def devices(self) -> list[torch.device]:
        return [s.device for s in self.shards]

    @property
    def shape(self) -> tuple[int, ...]:
        shape = list(self.shards[0].shape)
        if self.dim is not None:
            shape[self.dim] = sum(s.shape[self.dim] for s in self.shards)
        return tuple(shape)

    def gather(self, device=None) -> torch.Tensor:
        """The whole column on ``device`` (default: the mesh's first)."""
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


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   local_device_count: int | None = None) -> None:
    """The JAX package joins a multi-host mesh through
    ``jax.distributed.initialize``.  The port's counterpart is
    ``torch.distributed``, one process a card, and is not ported yet."""
    raise NotImplementedError(
        "init_multihost: a mesh across processes waits for torch.distributed, one "
        "process a card (ROADMAP.md §1, the ep axis and init_multihost)")


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              ep: int | None = None, *, devices=None) -> Mesh:
    """A (dp, ep) device mesh; dp-only (``ep=1``) by default, as the JAX
    package's.  ``devices`` gives the devices (repeats allowed: shards on one
    card, or on the host); without it the mesh takes the first
    ``n_devices`` visible CUDA cards and raises when there are fewer, or
    none."""
    if devices is None:
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
    return Mesh(grid.reshape(dp, ep), ("dp", "ep"))


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
    mesh's first device.  A dimension the axis does not divide raises
    ``ValueError``, as ``jax.device_put`` does."""
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(np.asarray(arr))
    cut = sharding.split()
    if cut is None:
        return Sharded(sharding, [t.to(sharding.mesh.first_device)], None)
    dim, axis = cut
    devices = sharding.mesh.axis_devices(axis)
    size = t.shape[dim]
    if size % len(devices):
        raise ValueError(f"sharding {sharding.spec} cuts dimension {dim} over the "
                         f"{len(devices)} devices of axis {axis!r}, which must divide its "
                         f"size {size} (full shape {tuple(t.shape)})")
    parts = torch.split(t, size // len(devices), dim=dim)
    return Sharded(sharding, [send(p, d).contiguous() for p, d in zip(parts, devices)], dim)


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

    Each shard's call sees only its own part of a cut column, so
    ``step_fn`` must act on each sample (each row of the cut dimension) on
    its own, as a vmapped tick does: no collective joins the shards.  The
    shards are called in turn from this thread; each call is issued under
    its device and runs there asynchronously.  A step whose columns are all
    whole runs once, on the mesh's first device."""
    placed = shard_cols(mesh, cols, sample_axis)

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
