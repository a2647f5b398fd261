"""UDP lockstep bridge for external SITL co-processes (counterpart of
``elodin_tpu/lockstep.py``).

Each tick the bridge sends selected component values to the controller and
blocks (with a timeout) for a control packet that is written back into
``external_control`` components before the next tick.  ``step`` is the
strict same-tick exchange; ``run_pipelined`` overlaps the controller's
round trip with the step, through ``Exec.lockstep_session``.

Wire format (little-endian): state packet = u64 tick + concatenated f64
component values in declaration order; command packet = the echoed u64
tick + the f64 values of the write-back components.  A JSON mode is kept
for script-friendly controllers.  Only numpy and sockets: the device work
is ``Exec``'s.
"""

from __future__ import annotations

import json
import socket
import struct
import time as _time

import numpy as np


class UdpLockstep:
    def __init__(self, exec_, send: list[str], recv: list[str],
                 state_port: int, command_port: int,
                 host: str = "127.0.0.1", timeout: float = 0.02,
                 mode: str = "binary", sync_timeout: float = 30.0):
        self.exec = exec_
        self.send_names = list(send)
        self.recv_names = list(recv)
        self.host = host
        self.state_port = state_port
        self.timeout = timeout
        self.sync_timeout = sync_timeout
        self.mode = mode
        self._state_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._cmd_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._cmd_sock.bind((host, command_port))
        self._cmd_sock.settimeout(timeout)
        self._last_cmd: dict[str, np.ndarray] = {}
        self.missed = 0
        self.stale = 0  # dropped replies: late, or runts
        self._session = None
        self._synced = False
        self._wire_tick = 0

        # wait_for_write components must receive a command before the sim
        # proceeds (reference metadata contract, examples/rocket/main.py:64-71)
        self.blocking = {
            name: self._wait_for_write(name) for name in self.recv_names
        }

    def _wait_for_write(self, qualified: str) -> bool:
        comp = qualified.split(".", 1)[1]
        meta = self.exec.meta.components.get(comp)
        if meta is None:
            return False
        return meta.metadata.get("wait_for_write", "false") == "true"

    # -- per-tick ---------------------------------------------------------

    def step(self, tick: int) -> None:
        self._send_state(tick)
        self._recv_commands(tick)
        for name, value in self._last_cmd.items():
            self.exec.write_component(name, value)

    def _send_state(self, tick: int) -> None:
        values = [
            np.atleast_1d(np.asarray(self.exec.read_component(n), dtype="<f8"))
            for n in self.send_names
        ]
        if self.mode == "json":
            payload = json.dumps(
                {
                    "tick": tick,
                    **{n: v.tolist() for n, v in zip(self.send_names, values)},
                }
            ).encode()
        else:
            payload = struct.pack("<Q", tick) + b"".join(
                v.tobytes() for v in values
            )
        self._state_sock.sendto(payload, (self.host, self.state_port))

    def _recv_commands(self, tick: int) -> None:
        must_block = any(self.blocking.values())
        deadline_tries = 50 if must_block else 1
        for _ in range(deadline_tries):
            try:
                raw, _addr = self._cmd_sock.recvfrom(65536)
            except (TimeoutError, socket.timeout):
                self.missed += 1
                continue
            # binary mode echoes our tick: a reply that missed its own
            # tick's deadline would otherwise be consumed by the NEXT
            # tick's recv, leaving the loop permanently one tick stale
            if self.mode != "json" and len(raw) >= 8:
                echoed = int(np.frombuffer(raw[:8], dtype="<u8")[0])
                if echoed != tick:
                    self.stale += 1
                    continue  # drop the stale reply, keep waiting
            self._parse(raw)
            return

    def _parse(self, raw: bytes) -> None:
        if self.mode == "json":
            data = json.loads(raw.decode())
            for n in self.recv_names:
                key = n.split(".")[-1]
                if key in data:
                    self._last_cmd[n] = np.asarray(data[key], dtype=np.float64)
                elif n in data:
                    self._last_cmd[n] = np.asarray(data[n], dtype=np.float64)
        else:
            counts = []
            need = 8  # echoed tick
            for n in self.recv_names:
                comp = n.split(".", 1)[1]
                meta = self.exec.meta.components[comp]
                count = 1
                for s in meta.ty.shape:
                    count *= s
                counts.append(count)
                need += count * 8
            if len(raw) < need:
                # UDP is unauthenticated and unreliable: a runt or stray
                # datagram must not crash the sim step loop
                return
            off = 8
            for n, count in zip(self.recv_names, counts):
                vals = np.frombuffer(raw, dtype="<f8", count=count, offset=off)
                off += count * 8
                self._last_cmd[n] = vals.copy()

    # -- pipelined fast path ------------------------------------------------

    def run_pipelined(self, ticks: int) -> None:
        """Drive ``ticks`` exchanges overlapping the controller round-trip
        with the device step (one-tick actuator transport delay, as real
        SITL links behave).

        Timeline per tick t: send state(t) (the controller starts computing
        its reply), step the device with the reply to state(t-1), then
        collect reply(t), which usually arrived while the device was busy.
        Strict same-tick semantics (wait_for_write) stay on ``step()``.
        """
        if any(self.blocking.values()):
            raise RuntimeError(
                "wait_for_write components need same-tick replies; "
                "use step(), not run_pipelined()"
            )
        session = self._session
        if session is None or session.emit != self.exec.record_history:
            # the session reads record_history once, when it is built;
            # rebuild when the exec-level knob was toggled since
            session = self._session = self.exec.lockstep_session(
                self.send_names, self.recv_names
            )
        recv_rows = [self.exec._history.resolve(q) for q in self.recv_names]
        out = session.peek()
        sock_cmd = self._cmd_sock
        sock_cmd.setblocking(True)
        sock_cmd.settimeout(self.timeout)

        # expected command-packet length: echoed tick + every recv value.
        # UDP is unauthenticated and unreliable: a runt or stray datagram
        # must be dropped, never handed to np.frombuffer (same guard as
        # _parse's `len(raw) < need`).
        need = 8 + sum(
            (int(np.prod(session.cmd_bufs[comp].shape[1:], dtype=np.int64)) or 1) * 8
            for comp, _row in recv_rows
        )

        def parse_into_bufs(raw: bytes) -> None:
            off = 8
            for comp, row in recv_rows:
                buf = session.cmd_bufs[comp]
                n = int(np.prod(buf.shape[1:], dtype=np.int64)) or 1
                vals = np.frombuffer(raw, dtype="<f8", count=n, offset=off)
                off += n * 8
                buf[row] = vals.reshape(buf.shape[1:]).astype(buf.dtype)

        # Link sync: the co-process may still be booting (a cold Python
        # interpreter takes seconds on a loaded box); ping tick 0 until the
        # first reply instead of charging its startup as missed deadlines.
        if not self._synced:
            payload = struct.pack("<Q", 0) + out.tobytes()
            deadline = _time.monotonic() + self.sync_timeout
            sock_cmd.settimeout(0.1)
            while True:
                self._state_sock.sendto(payload, (self.host, self.state_port))
                try:
                    raw, _addr = sock_cmd.recvfrom(65536)
                except (TimeoutError, socket.timeout):
                    if _time.monotonic() > deadline:
                        raise RuntimeError(
                            "lockstep peer never answered the sync ping"
                        ) from None
                    continue
                if len(raw) >= need:
                    parse_into_bufs(raw)
                    self._synced = True
                    break
                if len(raw) >= 8:
                    self.stale += 1
            sock_cmd.settimeout(self.timeout)

        # the wire tick persists across run_pipelined calls: restarting at 1
        # would let a late reply from the previous call (echoed tick up to
        # its final value) pass the `echoed < tick` stale filter, and the
        # peer would see the tick sequence go backwards
        start = self._wire_tick
        for tick in range(start + 1, start + ticks + 1):
            self._state_sock.sendto(
                struct.pack("<Q", tick) + out.tobytes(),
                (self.host, self.state_port),
            )
            self._wire_tick = tick
            out = session.tick()
            # reply(t) should have landed during the device step
            got = False
            while not got:
                try:
                    raw, _addr = sock_cmd.recvfrom(65536)
                except (TimeoutError, socket.timeout):
                    self.missed += 1
                    break
                if len(raw) < 8:
                    continue
                echoed = int(np.frombuffer(raw[:8], dtype="<u8")[0])
                if echoed < tick:
                    self.stale += 1
                    continue  # late reply from an earlier tick: drop, rewait
                if len(raw) < need:
                    self.stale += 1
                    continue  # runt with a current tick: drop, rewait
                parse_into_bufs(raw)
                got = True

    def as_post_step(self):
        def post_step(tick: int, _ctx) -> None:
            self.step(tick)

        return post_step

    def close(self) -> None:
        self._state_sock.close()
        self._cmd_sock.close()
