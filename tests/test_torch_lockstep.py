"""The port's lockstep sessions, ``UdpLockstep`` and the betaflight-sitl
example, on the CPU.

* The four session tests of ``tests/test_core.py``: the session against
  the generic ``write_component`` + ``run(1)`` path (1e-12), the batched
  hold (a ``(4, 1)`` stack equal to four single exchanges, bitwise) and
  ``ValueError`` for ``hold_ticks < 1``, the batched history emitted at
  the right times, pending host writes applied once and ``emit``.
* The same command sequence through a JAX session and a port session, at
  hold 1 and 4, on the hover plant: outputs within 1e-12 (the same f64
  arithmetic).
* ``UdpLockstep`` strict and pipelined, runt packets and the wire tick
  across calls, with a thread as the controller, as ``tests/test_core.py``.
* The example: ``run(ticks=1500)`` with the ``controller.py`` process,
  ``run_batched(trips=10, hold=256)``, and ``run_batched(trips=40,
  hold=64)``'s PD loop in both packages: telemetry stacks within 1e-12.

Every socket binds a port the system picked free.
"""

import socket
import struct
import threading
import time
import typing as ty
from dataclasses import dataclass

import numpy as np
import pytest
import torch

import elodin_tpu_torch as tel
from elodin_tpu_torch.examples.betaflight_sitl import main as tsitl
from elodin_tpu_torch.lockstep import UdpLockstep
from torch_port_util import float_policy, jax_example

X = ty.Annotated[torch.Tensor, tel.Component("x", tel.ComponentType.F64)]
Ctrl = ty.Annotated[torch.Tensor, tel.Component("ctrl", tel.ComponentType.F64,
                                                metadata={"external_control": "true"})]


@tel.map
def apply_ctrl(x: X, c: Ctrl) -> X:
    return x + c


@dataclass
class T(tel.Archetype):
    x: X
    ctrl: Ctrl


@pytest.fixture(autouse=True)
def _f64():
    with float_policy("f64"):
        yield


def fresh(x0=0.0, ctrl0=0.0, **build):
    w = tel.World()
    w.spawn(T(np.float64(x0), np.float64(ctrl0)), "v")
    return w.build(apply_ctrl, device="cpu", **build)


def _x(ex) -> float:
    return float(ex.column_array("x")[0])


def _free_udp_ports(n):
    return tsitl._free_udp_ports(n)


def test_session_matches_the_generic_path():
    ex_a, ex_b = fresh(), fresh()
    session = ex_a.lockstep_session(["v.x"], ["v.ctrl"])
    np.testing.assert_array_equal(session.peek(), [0.0])
    for k in range(4):
        cmd = float(k + 1)
        session.cmd_bufs["ctrl"][0] = cmd
        out = session.tick()
        ex_b.write_component("v.ctrl", cmd)
        ex_b.run(1, show_progress=False)
        assert abs(float(out[0]) - _x(ex_b)) < 1e-12, (k, out, _x(ex_b))
    assert ex_a.tick() == 4
    np.testing.assert_array_equal(session.peek(), [_x(ex_a)])


def test_session_batched_hold():
    ex_b, ex_1 = fresh(), fresh()
    batched = ex_b.lockstep_session(["v.x"], ["v.ctrl"], hold_ticks=4)
    single = ex_1.lockstep_session(["v.x"], ["v.ctrl"])

    batched.cmd_bufs["ctrl"][0] = 2.0
    out = batched.tick()
    assert out.shape == (4, 1), out.shape
    single.cmd_bufs["ctrl"][0] = 2.0
    singles = [single.tick()[0] for _ in range(4)]
    np.testing.assert_allclose(out[:, 0], singles, rtol=0, atol=0)
    assert ex_b.tick() == ex_1.tick() == 4

    # the controller acts once per window on the last row
    batched.cmd_bufs["ctrl"][0] = -1.0
    out2 = batched.tick()
    assert abs(float(out2[-1, 0]) - (8.0 - 4.0)) < 1e-12
    assert ex_b.tick() == 8

    with pytest.raises(ValueError, match="hold_ticks"):
        fresh().lockstep_session(["v.x"], ["v.ctrl"], hold_ticks=0)


def test_session_batched_history_emit():
    ex = fresh(ctrl0=1.0, simulation_rate=10.0)
    ex.record_history = True
    session = ex.lockstep_session(["v.x"], ["v.ctrl"], hold_ticks=3)
    session.cmd_bufs["ctrl"][0] = 1.0
    session.tick()
    session.tick()
    df = ex.history("v.x")
    xs = np.asarray(df["v.x"]).ravel()
    np.testing.assert_allclose(xs[-6:], [1, 2, 3, 4, 5, 6])
    # the JAX package's timestamps: (tick + 1 + i) * dt from each window's start
    dt = ex.sim_time_step
    assert ex._history.times == [0.0] + [dt + i * dt for i in range(3)] + \
        [4 * dt + i * dt for i in range(3)]


def test_session_applies_pending_host_writes():
    ex = fresh(x0=5.0)
    ex.write_component("v.x", 100.0)  # a host write, never run()
    session = ex.lockstep_session(["v.x"], ["v.ctrl"])
    session.cmd_bufs["ctrl"][0] = 1.0
    out = session.tick()
    assert abs(float(out[0]) - 101.0) < 1e-12, out  # applied before the step
    session.cmd_bufs["ctrl"][0] = 0.0
    session.tick()
    ex.run(1, show_progress=False)  # must not revert to the written value
    assert abs(_x(ex) - 101.0) < 1e-12
    assert session.emit == ex.record_history
    ex.record_history = False
    assert ex.lockstep_session(["v.x"], ["v.ctrl"]).emit is False


def test_session_writes_no_command_buffer_through():
    """The session copies the host buffers: writing them after an exchange
    leaves the state and the history as they were."""
    ex = fresh()
    session = ex.lockstep_session(["v.x"], ["v.ctrl"])
    session.cmd_bufs["ctrl"][0] = 3.0
    session.tick()
    session.cmd_bufs["ctrl"][0] = 99.0
    np.testing.assert_array_equal(ex.column_array("ctrl"), [3.0])
    assert ex.history_frame("v.ctrl")["v.ctrl"][-1] == 3.0


def test_session_ticks_are_timed_into_the_profile():
    """``Exec.profile()`` times a session's ticks as it times ``run``'s:
    every tick sleeps 2 ms, so neither the tick ms nor the real-time factor
    may read as if the session's ticks took no time."""
    ex = fresh()
    step = ex._step

    def slow(cols):
        time.sleep(0.002)
        return step(cols)

    ex._step = slow
    ex.lockstep_session(["v.x"], ["v.ctrl"], hold_ticks=3).tick()
    ex.run(3)
    assert ex.profiler.ticks == 6
    profile = ex.profile()
    assert profile["tick"] >= 2.0
    assert profile["real_time_factor"] <= ex.sim_time_step / 0.002


def test_session_commits_are_not_timed_as_ticks():
    """A session's commits to the history lie outside its ticks' time, as
    ``run``'s do: each commit here sleeps 0.1 s, the three ticks far less."""
    ex = fresh()
    commit = ex._commit

    def slow(t, cols):
        time.sleep(0.1)
        commit(t, cols)

    ex._commit = slow
    session = ex.lockstep_session(["v.x"], ["v.ctrl"], hold_ticks=3)
    assert session.emit
    session.tick()
    assert ex.profiler.ticks == 3 and len(ex.history_frame("v.x")["v.x"]) == 4
    assert ex.profiler.kernel_s < 0.1


@pytest.mark.parametrize("hold", [1, 4])
def test_session_matches_the_jax_package(hold):
    jsitl = jax_example("betaflight-sitl", "main")
    import elodin_tpu as jel

    jw = jel.World()
    jw.spawn(jsitl.Hover(), name="craft")
    jex = jw.build(jsitl.integrate, simulation_rate=jsitl.SIM_RATE)
    tex = tsitl.build("cpu")
    jses = jex.lockstep_session(tsitl.SEND, tsitl.RECV, hold_ticks=hold)
    tses = tex.lockstep_session(tsitl.SEND, tsitl.RECV, hold_ticks=hold)
    np.testing.assert_array_equal(tses.peek(), jses.peek())
    cmds = np.random.default_rng(3).uniform(0.0, 20.0, 25)
    for cmd in cmds:
        jses.cmd_bufs["thrust_cmd"][0] = cmd
        tses.cmd_bufs["thrust_cmd"][0] = cmd
        ref, ours = np.asarray(jses.tick()), tses.tick()
        assert ours.shape == ref.shape and ours.dtype == np.float64
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    assert tex.tick() == jex.tick() == 25 * hold


def _controller_socket(state_port):
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", state_port))
    sock.settimeout(10.0)
    return sock


def test_udp_lockstep_bridge():
    ex = fresh()
    state_port, cmd_port = _free_udp_ports(2)
    bridge = UdpLockstep(ex, send=["v.x"], recv=["v.ctrl"],
                         state_port=state_port, command_port=cmd_port, timeout=0.5)
    ctrl_sock = _controller_socket(state_port)

    def controller():
        for _ in range(3):
            raw, _ = ctrl_sock.recvfrom(65536)
            (tick,) = struct.unpack_from("<Q", raw)
            ctrl_sock.sendto(struct.pack("<Qd", tick, 2.0), ("127.0.0.1", cmd_port))

    t = threading.Thread(target=controller, daemon=True)
    t.start()
    for tick in range(3):
        bridge.step(tick)
        ex.run(1)
    t.join(timeout=10)
    assert not t.is_alive()
    bridge.close()
    ctrl_sock.close()
    # each tick's command arrives before its run: ctrl = 2 on all 3 ticks
    assert _x(ex) >= 4.0, f"lockstep commands not applied: x={_x(ex)}"
    assert bridge.missed == 0


def test_pipelined_bridge_one_tick_transport_delay():
    ex = fresh()
    state_port, cmd_port = _free_udp_ports(2)
    bridge = UdpLockstep(ex, send=["v.x"], recv=["v.ctrl"],
                         state_port=state_port, command_port=cmd_port, timeout=0.5)
    ctrl_sock = _controller_socket(state_port)
    seen = []

    def controller():
        # sync ping (tick 0) + 4 pipelined ticks
        while True:
            raw, _ = ctrl_sock.recvfrom(65536)
            (tick,), x = struct.unpack_from("<Q", raw), struct.unpack_from("<d", raw, 8)[0]
            seen.append((tick, x))
            ctrl_sock.sendto(struct.pack("<Qd", tick, 10.0), ("127.0.0.1", cmd_port))
            if tick >= 4:
                return

    t = threading.Thread(target=controller, daemon=True)
    t.start()
    bridge.run_pipelined(4)
    t.join(timeout=10)
    bridge.close()
    ctrl_sock.close()
    # the sync reply (10.0) lands before tick 1, so all 4 ticks add 10.0
    assert abs(_x(ex) - 40.0) < 1e-12, _x(ex)
    assert bridge.missed == 0
    # state(t) is the state before tick t's step: x = 10 (t - 1)
    assert [x for _t, x in seen] == [0.0, 0.0, 10.0, 20.0, 30.0]


def test_pipelined_runt_packets_and_wire_tick():
    ex = fresh()
    state_port, cmd_port = _free_udp_ports(2)
    bridge = UdpLockstep(ex, send=["v.x"], recv=["v.ctrl"],
                         state_port=state_port, command_port=cmd_port, timeout=0.5)
    ctrl_sock = _controller_socket(state_port)
    ticks_seen = []

    def controller(stop_at):
        while True:
            raw, _ = ctrl_sock.recvfrom(65536)
            (tick,) = struct.unpack_from("<Q", raw)
            ticks_seen.append(tick)
            # a runt first (the tick only, no payload): must be dropped
            ctrl_sock.sendto(struct.pack("<Q", tick), ("127.0.0.1", cmd_port))
            ctrl_sock.sendto(struct.pack("<Qd", tick, 1.0), ("127.0.0.1", cmd_port))
            if tick >= stop_at:
                return

    t = threading.Thread(target=controller, args=(3,), daemon=True)
    t.start()
    bridge.run_pipelined(3)
    t.join(timeout=10)
    assert bridge.missed == 0
    assert bridge.stale >= 3  # one runt per tick, all dropped

    # second call: the wire tick continues from 4, it does not restart at 1
    t = threading.Thread(target=controller, args=(6,), daemon=True)
    t.start()
    bridge.run_pipelined(3)
    t.join(timeout=10)
    bridge.close()
    ctrl_sock.close()
    assert [tk for tk in ticks_seen if tk > 0] == [1, 2, 3, 4, 5, 6]


def test_betaflight_sitl_lockstep():
    """The external controller process at the 1 kHz plant rate."""
    stats = {}
    rate = tsitl.run(ticks=1500, device="cpu", stats=stats)
    # the threshold only guards against a stuck bridge
    assert rate > 100, f"lockstep too slow: {rate:.0f} Hz"
    assert abs(stats["z"] - 2.0) < 0.5


def test_betaflight_sitl_batched_deep_hold():
    """hold=256 on the 1 kHz plant, the controller decimated to 3.9 Hz: the
    PD hover loop still closes (run_batched raises otherwise)."""
    assert tsitl.run_batched(trips=10, hold=256, device="cpu") > 0


def test_betaflight_sitl_batched_matches_the_jax_package():
    jsitl = jax_example("betaflight-sitl", "main")
    import elodin_tpu as jel

    trips, hold = 40, 64
    jw = jel.World()
    jw.spawn(jsitl.Hover(), name="craft")
    jex = jw.build(jsitl.integrate, simulation_rate=jsitl.SIM_RATE)
    jex.record_history = False
    jses = jex.lockstep_session(tsitl.SEND, tsitl.RECV, hold_ticks=hold)
    jses.cmd_bufs["thrust_cmd"][0] = tsitl.control(2.0, 0.0)
    tele = np.asarray(jses.tick())
    stacks = [tele]
    for _ in range(trips):
        jses.cmd_bufs["thrust_cmd"][0] = tsitl.control(float(tele[-1, 0]), float(tele[-1, 1]))
        tele = np.asarray(jses.tick())
        stacks.append(tele)

    stats = {}
    tsitl.run_batched(trips=trips, hold=hold, device="cpu", stats=stats)
    np.testing.assert_allclose(stats["tele"], stacks[-1], rtol=0, atol=1e-12)
    # every window of the port's loop, the commands derived from its own rows
    tex = tsitl.build("cpu")
    tex.record_history = False
    tses = tex.lockstep_session(tsitl.SEND, tsitl.RECV, hold_ticks=hold)
    tses.cmd_bufs["thrust_cmd"][0] = tsitl.control(2.0, 0.0)
    ours = tses.tick()
    for i, ref in enumerate(stacks):
        assert ours.shape == ref.shape == (hold, 2)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12, err_msg=f"window {i}")
        tses.cmd_bufs["thrust_cmd"][0] = tsitl.control(float(ours[-1, 0]), float(ours[-1, 1]))
        ours = tses.tick()
    assert abs(float(stacks[-1][-1, 0]) - 2.0) < 0.5
