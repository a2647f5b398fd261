"""Flight-software host framework (counterpart of ``elodin_tpu/fsw.py``;
parity: fsw/roci — typed-World systems with Componentize/Decomponentize
derives, Hz rate drivers, impeller2 DB plumbing, CSV logging).

A ``World`` is a dataclass whose fields are annotated components (the same
``typing.Annotated[..., el.Component(...)]`` aliases the sim SDK uses); the
framework synchronizes those fields with an elodin-db instance around each
``update`` call, so the same component vocabulary flows sim -> DB -> FSW.

A world's fields are host numpy, as in the JAX package.  The estimator
and controller come from ``elodin_tpu_torch.adcs`` and run eagerly on a
device, the card unless ``device=`` says otherwise: ``mekf_system`` and
``lqr_system`` keep their state there across updates, move the fields
they read to it as tensors of the float policy's dtype, and write their
output back as host numpy with one copy.  A tensor that a user system
writes into the world is copied to the host once when it is pushed.
"""

from __future__ import annotations

import time
import typing

import numpy as np
import torch

from . import _config
from .component import Component


def world_components(world_cls) -> dict[str, Component]:
    """Field name -> Component for a dataclass world (the Componentize /
    Decomponentize derive equivalent, fsw/roci/src/lib.rs:23-48)."""
    hints = typing.get_type_hints(world_cls, include_extras=True)
    out = {}
    for name, tp in hints.items():
        try:
            out[name] = Component.of(tp)
        except ValueError:
            continue
    return out


class FswSystem:
    """Base class: override ``update(world)``; compose with ``pipe``."""

    def update(self, world) -> None:  # pragma: no cover
        raise NotImplementedError

    def pipe(self, other: "FswSystem") -> "FswSystem":
        return _FswPipe(self, other)


class _FswPipe(FswSystem):
    def __init__(self, left: FswSystem, right: FswSystem):
        self.left = left
        self.right = right

    def update(self, world) -> None:
        self.left.update(world)
        self.right.update(world)


class _FnSystem(FswSystem):
    def __init__(self, fn):
        self.fn = fn

    def update(self, world) -> None:
        self.fn(world)


def as_fsw_system(obj) -> FswSystem:
    if isinstance(obj, FswSystem):
        return obj
    if callable(obj):
        return _FnSystem(obj)
    raise TypeError(f"not a system: {obj!r}")


def _host(value) -> np.ndarray:
    """A world field as host numpy: a tensor on any device is copied once."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class HzDriver:
    """OS-sleep rate driver (fsw/roci/src/drivers.rs Hz<N>/OsSleepDriver):
    calls ``system.update(world)`` at the requested rate, optionally
    synchronizing annotated fields with a DB."""

    def __init__(self, hz: float, system, world, db_addr: str | None = None,
                 subscribe: list[str] | None = None,
                 publish: list[str] | None = None, csv_path: str | None = None):
        self.hz = hz
        self.system = as_fsw_system(system)
        self.world = world
        self.components = world_components(type(world))
        self.subscribe = subscribe or []
        self.publish = publish or []
        self._client = None
        self._writer = None
        self._csv = None
        if db_addr:
            from . import db as edb

            self._client = edb.Client.connect(db_addr)
            if self.publish:
                schema = {}
                for field in self.publish:
                    comp = self.components[field]
                    spec = edb.Field(comp.ty.ty.value, tuple(comp.ty.shape))
                    schema[comp.name] = spec
                self._writer = self._client.table_writer(schema)
        if csv_path:
            self._csv = open(csv_path, "w")
            self._csv.write(
                "time," + ",".join(self.components[f].name for f in self.publish or self.components) + "\n"
            )
        self.ticks = 0

    def _pull(self) -> None:
        if self._client is None:
            return
        for field in self.subscribe:
            comp = self.components[field]
            sample = self._client.latest(comp.name)
            if sample is not None:
                setattr(self.world, field, np.asarray(sample.values))

    def _push(self, t_us: int) -> None:
        if self._writer is None and self._csv is None:
            return
        fields = self.publish if self._csv is None else (self.publish or list(self.components))
        host = {f: _host(getattr(self.world, f)) for f in fields}
        if self._writer is not None:
            values = {self.components[f].name: host[f] for f in self.publish}
            self._writer.write_nowait(timestamp_us=t_us, values=values)
        if self._csv is not None:
            # explicit join: np.array2string wraps lines at 75 chars and
            # elides >1000-element arrays, corrupting CSV records
            row = [str(t_us)] + [
                "[" + ";".join(
                    repr(x) for x in np.atleast_1d(host[f]).reshape(-1)
                ) + "]"
                for f in fields
            ]
            self._csv.write(",".join(row) + "\n")

    def step(self) -> None:
        t_us = time.time_ns() // 1000
        self._pull()
        self.system.update(self.world)
        self._push(t_us)
        self.ticks += 1

    def run(self, max_ticks: int | None = None,
            is_canceled=None) -> None:
        period = 1.0 / self.hz
        next_t = time.perf_counter()
        while max_ticks is None or self.ticks < max_ticks:
            if is_canceled is not None and is_canceled():
                break
            self.step()
            next_t += period
            sleep = next_t - time.perf_counter()
            if sleep > 0:
                time.sleep(sleep)
            else:
                next_t = time.perf_counter()  # fell behind; resync
        if self._csv:
            self._csv.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
        if self._client is not None:
            self._client.close()
        if self._csv is not None:
            self._csv.close()


def _device(device) -> torch.device:
    return _config.device(device, "fsw", "pass device='cpu' to run on the host")


def _on(value, device: torch.device) -> torch.Tensor:
    """``value`` (numpy, a list or a tensor) at the policy's float dtype on
    ``device``."""
    ft = _config.default_float()
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=ft)
    # a copy: a database sample's array is read-only
    return torch.tensor(np.asarray(value), dtype=ft, device=device)


def lqr_system(j, q_ang_vel, q_pos, r, q_field="att_est",
               omega_field="gyro_omega", goal_field="att_goal",
               out_field="control_torque", device="cuda"):
    """Ready-made attitude-LQR FSW system (parity with the fsw/lqr
    service): reads estimated attitude + body rates + goal quaternion,
    writes the Yang-LQR control torque.  The gains live on ``device``."""
    from .adcs.lqr import YangLQR

    dev = _device(device)
    ctrl = YangLQR(*(_on(x, dev) for x in (j, q_ang_vel, q_pos, r)))

    def update(world):
        torque = ctrl.control(
            _on(getattr(world, q_field), dev).reshape(4),
            _on(getattr(world, omega_field), dev).reshape(3),
            _on(getattr(world, goal_field), dev).reshape(4),
        )
        setattr(world, out_field, torque.cpu().numpy())

    return _FnSystem(update)


def mekf_system(sigma_g, sigma_b, dt, refs_fields, body_fields, sigmas,
                q_field="att_est", omega_field="gyro_omega", device="cuda"):
    """Ready-made MEKF FSW system over world fields (parity with the
    fsw/mekf service: reads gyro + vector observations, writes attitude).
    The filter's state lives on ``device``; the observations are moved
    there before the update (``Mekf.estimate_attitude`` keeps a tensor
    where it is)."""
    from .adcs.mekf import Mekf

    dev = _device(device)
    state = {"mekf": Mekf.new(_on(sigma_g, dev), _on(sigma_b, dev), dt, device=dev)}
    sigmas = [_on(s, dev) for s in sigmas]

    def update(world):
        m = state["mekf"]
        m.omega = _on(getattr(world, omega_field), dev).reshape(3)
        bodies = [_on(getattr(world, f), dev).reshape(3) for f in body_fields]
        refs = [_on(getattr(world, f), dev).reshape(3) for f in refs_fields]
        m = m.estimate_attitude(bodies, refs, sigmas)
        m = m.reset_if_invalid()
        state["mekf"] = m
        setattr(world, q_field, m.q_hat.cpu().numpy())

    return _FnSystem(update)
