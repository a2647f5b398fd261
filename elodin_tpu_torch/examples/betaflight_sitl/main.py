"""SITL lockstep example (counterpart of
``examples/betaflight-sitl/main.py``).

A 1-D hover vehicle runs in the sim at 1 kHz; an external controller
process (``controller.py``) closes the altitude loop over the binary UDP
lockstep bridge, one exchange per tick.  ``run`` drives it pipelined
(``UdpLockstep.run_pipelined``) or strict (``step`` then ``Exec.run(1)``);
``run_batched`` holds each command over ``hold`` plant ticks of one
``lockstep_session`` exchange, with a PD controller on the host.  Each
prints its lockstep rate and asserts that the altitude holds at 2 m.  The
UDP ports are picked free at run time.

    python -m elodin_tpu_torch.examples.betaflight_sitl.main [--device cpu]

(This module defines ``@el.map`` functions, so it must not use postponed
annotations.)
"""

import socket
import subprocess
import sys
import time
import typing as ty
from dataclasses import field
from pathlib import Path

import numpy as np
import torch

import elodin_tpu_torch as el

from ...lockstep import UdpLockstep

SIM_RATE = 1000.0
SEND, RECV = ["craft.z_pos", "craft.z_vel"], ["craft.thrust_cmd"]

ZPos = ty.Annotated[torch.Tensor, el.Component("z_pos", el.ComponentType.F64)]
ZVel = ty.Annotated[torch.Tensor, el.Component("z_vel", el.ComponentType.F64)]
ThrustCmd = ty.Annotated[
    torch.Tensor,
    el.Component("thrust_cmd", el.ComponentType.F64,
                 metadata={"external_control": "true"}),
]


@el.dataclass
class Hover(el.Archetype):
    z_pos: ZPos = field(default_factory=lambda: np.float64(2.0))
    z_vel: ZVel = field(default_factory=lambda: np.float64(0.0))
    thrust_cmd: ThrustCmd = field(default_factory=lambda: np.float64(0.0))


@el.map
def integrate(z: ZPos, v: ZVel, thrust: ThrustCmd) -> tuple[ZPos, ZVel]:
    dt = 1.0 / SIM_RATE
    a = thrust - 9.81
    v2 = v + a * dt
    return z + v2 * dt, v2


def build(device: str = "cuda"):
    """The hover vehicle's Exec at SIM_RATE on ``device``."""
    w = el.World()
    w.spawn(Hover(), name="craft")
    return w.build(integrate, simulation_rate=SIM_RATE, device=device)


def control(z: float, v: float) -> float:
    """PD altitude hold at 2 m: run_batched's controller."""
    return float(np.clip(9.81 + 4.0 * (2.0 - z) - 2.0 * v, 0.0, 30.0))


def _free_udp_ports(n: int) -> list[int]:
    socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def run(ticks: int = 4000, pipeline: bool = True, device: str = "cuda",
        stats: dict | None = None) -> float:
    """``ticks`` exchanges with the controller process; returns the
    lockstep rate in Hz.  ``stats``, when given, receives the rate, the
    missed and stale replies and the final altitude."""
    exec_ = build(device)
    state_port, cmd_port = _free_udp_ports(2)
    bridge = UdpLockstep(exec_, send=SEND, recv=RECV, state_port=state_port,
                         command_port=cmd_port, timeout=0.05)
    ctrl = subprocess.Popen(
        [sys.executable, str(Path(__file__).with_name("controller.py")),
         str(state_port), str(cmd_port)]
    )
    try:
        time.sleep(0.3)
        if pipeline:
            bridge.run_pipelined(50)  # first ops + link sync outside the clock
        t0 = time.perf_counter()
        if pipeline:
            # overlap the controller round-trip with the device step
            # (one-tick actuator transport delay, like the real SITL link)
            bridge.run_pipelined(ticks)
        else:
            for tick in range(ticks):
                bridge.step(tick)
                exec_.run(1)
        wall = time.perf_counter() - t0
        rate = ticks / wall
        z = float(exec_.read_component("craft.z_pos")[0])
        mode = "pipelined" if pipeline else "strict"
        print(f"lockstep rate ({mode}, {exec_.device}): {rate:,.0f} Hz over {ticks} "
              f"ticks (missed {bridge.missed}); altitude {z:.3f} m")
        if stats is not None:
            stats.update(hz=rate, missed=bridge.missed, stale=bridge.stale, z=z)
        if abs(z - 2.0) >= 0.5:
            raise AssertionError(f"altitude hold failed: {z:.3f} m")
        return rate
    finally:
        ctrl.terminate()
        ctrl.wait(timeout=10)
        bridge.close()


def run_batched(trips: int = 40, hold: int = 64, device: str = "cuda",
                stats: dict | None = None) -> float:
    """Batched lockstep: each exchange holds the thrust command over
    ``hold`` plant ticks, and the controller (a host PD on the window's
    last telemetry row) runs at SIM_RATE / hold.  Returns the plant rate in
    Hz; ``stats``, when given, receives it, the control rate, the final
    altitude and the last telemetry stack."""
    exec_ = build(device)
    exec_.record_history = False
    session = exec_.lockstep_session(SEND, RECV, hold_ticks=hold)
    session.cmd_bufs["thrust_cmd"][0] = control(2.0, 0.0)
    tele = session.tick()  # warm-up outside the clock
    t0 = time.perf_counter()
    for _ in range(trips):
        session.cmd_bufs["thrust_cmd"][0] = control(float(tele[-1, 0]), float(tele[-1, 1]))
        tele = session.tick()
    wall = time.perf_counter() - t0
    rate = trips * hold / wall
    z = float(tele[-1, 0])
    print(f"lockstep rate (batched, hold={hold}, {exec_.device}): {rate:,.0f} Hz plant / "
          f"{SIM_RATE / hold:.1f} Hz control; altitude {z:.3f} m")
    if stats is not None:
        stats.update(plant_hz=rate, control_hz=trips / wall, z=z, tele=tele)
    if abs(z - 2.0) >= 0.5:
        raise AssertionError(f"altitude hold failed: {z:.3f} m")
    return rate


if __name__ == "__main__":
    dev = sys.argv[sys.argv.index("--device") + 1] if "--device" in sys.argv else "cuda"
    run(device=dev)
    run_batched(device=dev)
