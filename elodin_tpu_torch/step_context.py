"""Pre/post-step host context (counterpart of
``elodin_tpu/step_context.py``; libs/nox-py/src/step_context.rs:97).

Gives host callbacks read/write access to component state between ticks:
the lockstep bridge for external controllers (SITL) using
``external_control`` components.
"""

from __future__ import annotations

import numpy as np


class StepContext:
    def __init__(self, exec_):
        self._exec = exec_

    def read_component(self, qualified: str) -> np.ndarray:
        value = self._exec.read_component(qualified)
        return np.atleast_1d(np.asarray(value))

    def write_component(self, qualified: str, value) -> None:
        self._exec.write_component(qualified, value)

    def tick(self) -> int:
        return self._exec.tick()

    def truncate(self) -> None:
        """Clear the stored history and reset the tick counter to 0,
        keeping the live device state (step_context.rs:335-349: the
        simulation continues from its current physical state at a fresh
        tick 0).  The telemetry pump is flushed first, so no row committed
        before the call lands after it."""
        self._exec.flush_telemetry()
        self._exec._history.truncate(0)
        self._exec._tick = 0
