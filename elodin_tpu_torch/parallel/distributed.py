"""Processes joined into one mesh over ``torch.distributed`` (the port's
counterpart of ``jax.distributed``, which the JAX package's
``init_multihost`` starts).

``init_multihost`` forms the process group; each process states its own
devices (``devices=`` or ``ELODIN_DEVICES``): ``cuda:<local index>`` on a
card, or ``cpu``.  After it, ``parallel.make_mesh()`` takes every rank's
devices in rank order, as ``jax.devices()`` is global after
``jax.distributed.initialize``.

The backend is stated, never swapped after an error: ``nccl`` when the
rank's devices are cards, ``gloo`` on the CPU.  NCCL refuses two ranks on
one card, so ranks that share a card pass ``backend="gloo"``; gloo's
collectives take host tensors only, so ``Comm`` copies a card's tensor to
the host, runs the collective there and copies the result back (compute
stays on the card).  ``Comm.transport`` says which of the two a run used.

``Comm`` holds the few collectives the mesh needs: an all-gather of row
blocks in global row order, an all-reduce of a host vote (ANY, ALL, or
that every rank agrees) and, at ``init_multihost``, an object all-gather
of the device lists.  ``RowWindow`` is a rank's block of the columns cut
over a mesh's ``ep`` axis, which ``SystemBuilder`` reads through
``current_window()`` while ``sharded_step`` or an ``Exec`` on a mesh runs
a step.

``launch(target, devices)`` starts one process a device list (a new
interpreter each, never a fork), joins them on a free local port and runs
``target`` ("module:function") in every rank; see ``parallel/__main__.py``.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist

# seconds a rank waits for the others (to form the group, or in a
# collective) before it fails: a rank that hangs fails its caller instead
# of holding the others until an outer time limit
TIMEOUT_S = 60

# collectives run since import (or since a caller reset the counts to 0)
COLLECTIVES = {"all_gather": 0, "all_reduce": 0}

# the line a rank started by ``launch`` prints its target's result on
RESULT_PREFIX = "ELODIN_RESULT "

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _Process:
    """What ``init_multihost`` fixed for this process: its devices, the
    backend, and every rank's devices in rank order."""

    def __init__(self, devices: list[torch.device], backend: str):
        self.devices = devices
        self.backend = backend
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        lists = [None] * self.world_size
        dist.all_gather_object(lists, [str(d) for d in devices])
        # (rank, device) of every device of the job, in rank order
        self.global_devices = [(r, torch.device(d)) for r, names in enumerate(lists)
                               for d in names]
        self.groups: dict[tuple[int, ...], object] = {}


_PROCESS: _Process | None = None


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   local_device_count: int | None = None, *,
                   backend: str | None = None, devices=None) -> None:
    """Join this process to a job of ``num_processes`` over
    ``torch.distributed``, coordinated at ``coordinator_address``
    ("host:port").

    The arguments fall back to ``ELODIN_COORDINATOR``,
    ``ELODIN_NUM_PROCESSES`` and ``ELODIN_PROCESS_ID`` as in the JAX
    package; ``devices`` (this rank's devices: ``["cuda:0"]``, ``["cpu"] *
    4``) to ``ELODIN_DEVICES`` (comma-separated), and ``backend`` to
    ``ELODIN_BACKEND``, then to ``nccl`` on a card and ``gloo`` on the CPU.
    ``local_device_count`` keeps the first that many devices.  A second call
    does nothing.  A card's index is made the current device before the
    group forms; a card that is not there raises (nothing falls back to the
    CPU)."""
    global _PROCESS
    if dist.is_initialized():
        return
    env = os.environ
    coordinator_address = coordinator_address or env.get("ELODIN_COORDINATOR")
    if num_processes is None and env.get("ELODIN_NUM_PROCESSES"):
        num_processes = int(env["ELODIN_NUM_PROCESSES"])
    if process_id is None and env.get("ELODIN_PROCESS_ID"):
        process_id = int(env["ELODIN_PROCESS_ID"])
    if devices is None and env.get("ELODIN_DEVICES"):
        devices = env["ELODIN_DEVICES"].split(",")
    backend = backend or env.get("ELODIN_BACKEND") or None
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_multihost needs the coordinator address, the number of processes and "
            "this process's id (or ELODIN_COORDINATOR, ELODIN_NUM_PROCESSES and "
            "ELODIN_PROCESS_ID); torch.distributed detects no cluster")
    if not devices:
        raise ValueError("init_multihost: state this process's devices (devices=['cuda:0'], "
                         "or ELODIN_DEVICES=cuda:0); they are never guessed")
    devices = [torch.device(d) for d in devices][:local_device_count or None]
    kinds = {d.type for d in devices}
    if len(kinds) != 1 or kinds - {"cuda", "cpu"}:
        raise ValueError(f"init_multihost: a process's devices are all cards or all the "
                         f"CPU, got {[str(d) for d in devices]}")
    on_card = kinds == {"cuda"}
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError(f"init_multihost: devices {[str(d) for d in devices]} but no "
                               "CUDA card is visible")
        devices = [torch.device("cuda", d.index or 0) for d in devices]
        torch.cuda.set_device(devices[0])
    backend = backend or ("nccl" if on_card else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _PROCESS = _Process(devices, backend)


def process() -> _Process | None:
    """This process's part of the job, or None before ``init_multihost``."""
    return _PROCESS if dist.is_initialized() else None


def _group(ranks: tuple[int, ...]):
    """The process group of ``ranks`` (the default group when it is every
    rank).  Every rank must ask for the same groups in the same order:
    ``torch.distributed.new_group`` is collective."""
    p = _PROCESS
    if ranks == tuple(range(p.world_size)):
        return None
    if ranks not in p.groups:
        p.groups[ranks] = dist.new_group(list(ranks))
    return p.groups[ranks]


class Comm:
    """The collectives of the ranks ``ranks`` (ascending, this rank among
    them)."""

    def __init__(self, ranks):
        p = _PROCESS
        self.ranks = tuple(ranks)
        self.group = _group(self.ranks)
        self.index = self.ranks.index(p.rank)
        # the device the backend's tensors live on
        self.device = p.devices[0] if p.backend == "nccl" else torch.device("cpu")
        self.staged = p.backend == "gloo" and p.devices[0].type == "cuda"

    @property
    def transport(self) -> str:
        if self.staged:
            return "gloo, staged through the host"
        return f"{_PROCESS.backend} on {self.device.type}"

    def all_gather_rows(self, t: torch.Tensor, sizes) -> torch.Tensor:
        """The blocks ``t`` of every rank (rank k's has ``sizes[k]`` rows)
        joined along dimension 0 in rank order, on ``t``'s device."""
        COLLECTIVES["all_gather"] += 1
        width = max(sizes)
        if t.shape[0] != sizes[self.index]:
            raise ValueError(f"rank {self.index} holds {t.shape[0]} rows, {sizes[self.index]} "
                             "expected")
        x = t.to(self.device)
        if x.shape[0] < width:
            x = torch.cat([x, x.new_zeros((width - x.shape[0],) + x.shape[1:])])
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in self.ranks]
        dist.all_gather(parts, x, group=self.group)
        out = torch.cat([part[:s] for part, s in zip(parts, sizes)])
        return out.to(t.device)

    def _reduce(self, value: int, op) -> int:
        COLLECTIVES["all_reduce"] += 1
        v = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.all_reduce(v, op=op, group=self.group)
        return int(v.item())

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any."""
        return bool(self._reduce(int(bool(flag)), dist.ReduceOp.MAX))

    def all(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on all."""
        return bool(self._reduce(int(bool(flag)), dist.ReduceOp.MIN))

    def agree(self, flag: bool, what: str) -> bool:
        """``flag``, after one all-reduce shows that every rank holds the
        same; raises where they differ."""
        votes = self._reduce(int(bool(flag)), dist.ReduceOp.SUM)
        if votes not in (0, len(self.ranks)):
            raise RuntimeError(f"{what}: {votes} of {len(self.ranks)} ranks hold true")
        return bool(flag)


class RowWindow:
    """This rank's rows of the columns cut over a mesh's ``ep`` axis.
    ``blocks[name][k]`` is the rows [r0, r1) of column ``name`` that the
    ``k``-th rank of ``comm`` holds, as the mesh placed its shards
    (``parallel.mesh.row_windows``)."""

    def __init__(self, comm: Comm, blocks: dict[str, list[tuple[int, int]]]):
        self.comm = comm
        self.blocks = blocks
        self.cut = frozenset(blocks)
        # per-world caches of what the window decides from the metadata
        self.cache: dict = {}

    def block(self, name: str, index: int | None = None) -> tuple[int, int]:
        """Rows [r0, r1) of cut column ``name`` held by rank ``index`` of
        ``comm`` (this rank by default)."""
        return self.blocks[name][self.comm.index if index is None else index]

    def sizes(self, name: str) -> list[int]:
        """The rows of cut column ``name`` that each rank holds, in rank
        order."""
        return [r1 - r0 for r0, r1 in self.blocks[name]]


_WINDOW: contextvars.ContextVar[RowWindow | None] = contextvars.ContextVar(
    "elodin_row_window", default=None)


def current_window() -> RowWindow | None:
    """The row window of the step running now, or None outside an ``ep``
    cut."""
    return _WINDOW.get()


@contextlib.contextmanager
def row_window(window: RowWindow | None):
    """Run the enclosed step with ``window`` as its row window."""
    token = _WINDOW.set(window)
    try:
        yield
    finally:
        _WINDOW.reset(token)


# ---------------------------------------------------------------------------
# Launching the processes
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A TCP port that is free on this host now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def import_target(target: str):
    """The object that "module:attribute.path" names."""
    module, _, attr = target.partition(":")
    if not attr:
        raise ValueError(f"expected 'module:function', got {target!r}")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def launch(target: str, devices, *, backend: str | None = None, kwargs: dict | None = None,
           timeout: float = 600.0) -> list:
    """Run ``target(**kwargs)`` ("module:function", importable in a new
    interpreter) in ``len(devices)`` new processes, rank k on the devices
    ``devices[k]``, joined by ``init_multihost`` on a free local port with
    ``backend`` (default: by the devices).  Every rank is started before
    any is waited for.  Returns each rank's result (what ``target``
    returned, through JSON), in rank order.

    A rank that exits non-zero fails the launch: the others are stopped and
    ``RuntimeError`` carries the end of each failed rank's stderr.  Each
    rank's other output is printed, line by line under its rank, after it
    ends."""
    port = free_port()
    procs = []
    for rank, devs in enumerate(devices):
        env = dict(os.environ)
        env.update(ELODIN_COORDINATOR=f"127.0.0.1:{port}",
                   ELODIN_NUM_PROCESSES=str(len(devices)), ELODIN_PROCESS_ID=str(rank),
                   ELODIN_DEVICES=",".join(str(d) for d in devs))
        env.pop("ELODIN_BACKEND", None)
        if backend:
            env["ELODIN_BACKEND"] = backend
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (REPO, os.getcwd(), env.get("PYTHONPATH")) if p)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "elodin_tpu_torch.parallel", target,
             json.dumps(kwargs or {})],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs: list = [None] * len(procs)

    def drain(k):
        outs[k] = procs[k].communicate()

    readers = [threading.Thread(target=drain, args=(k,), daemon=True)
               for k in range(len(procs))]
    for r in readers:
        r.start()
    deadline = time.monotonic() + timeout
    timed_out = False
    while any(p.poll() is None for p in procs):
        if any(p.returncode not in (None, 0) for p in procs):
            break
        if time.monotonic() > deadline:
            timed_out = True
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for r in readers:
        r.join()
    rcs = [p.returncode for p in procs]
    results, errors = [], []
    for rank, (rc, (out, err)) in enumerate(zip(rcs, outs)):
        lines = out.splitlines()
        for line in lines:
            if not line.startswith(RESULT_PREFIX):
                print(f"[rank {rank}] {line}", flush=True)
        if rc != 0:
            errors.append(f"rank {rank} exited {rc}:\n{err[-3000:]}")
            continue
        found = [line for line in lines if line.startswith(RESULT_PREFIX)]
        if not found:
            errors.append(f"rank {rank} printed no result:\n{err[-3000:]}")
            continue
        results.append(json.loads(found[-1][len(RESULT_PREFIX):]))
    if errors:
        cause = f"timed out after {timeout:g} s" if timed_out else "failed"
        raise RuntimeError(f"launch of {target} over {len(procs)} processes {cause} "
                           f"(exit codes {rcs}):\n" + "\n".join(errors))
    return results
