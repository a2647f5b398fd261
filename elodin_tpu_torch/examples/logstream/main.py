"""Log streaming in torch (counterpart of ``examples/logstream/main.py``):
structured FSW text logs into elodin-db alongside sim telemetry (parity:
the reference's examples/logstream/main.py — the reference builds a C++ log
client, libs/db/examples/log-client.cpp, and launches it via s10; here the
producer is a subprocess of this same module started through an s10
ProcessRecipe, sending LogEntry-style messages while a bouncing-ball sim
serves telemetry).

Run headless (the sim's own CLI arguments follow; the card unless
``--device`` says otherwise):
    ELODIN_MAX_TICKS=600 python -m elodin_tpu_torch.examples.logstream.main run 127.0.0.1:2240
then inspect:
    python -m elodin_tpu_torch db repl 127.0.0.1:2240
    >>> client.get_msgs("fsw_log")
"""

import os
import sys
import time

LOG_TOPIC = "fsw_log"
DB_ADDR = "127.0.0.1:2240"  # the loopback form of the sim CLI's default address


def log_producer(addr: str, n: int = 40, retries: int = 40) -> int:
    """Producer half (the log-client role): boot banner, telemetry chatter,
    a warning and an error, as structured log messages
    ({level, message}; levels per impeller2/wkt LogEntry: 0 trace .. 4 error)."""
    from ...db import Client

    client = None
    for _ in range(retries):
        try:
            client = Client.connect(addr)
            break
        except OSError:
            time.sleep(0.25)
    if client is None:
        raise SystemExit(f"could not reach db at {addr}")
    t0_us = time.time_ns() // 1000

    def emit(i, level, message):
        client.send_msg(
            LOG_TOPIC, {"level": level, "message": message},
            timestamp_us=t0_us + i * 1000,
        )

    emit(0, 2, "boot: flight software v1.2.0")
    emit(1, 2, "boot: IMU online")
    emit(2, 2, "boot: entering main loop")
    for i in range(3, n - 2):
        emit(i, 1 if i % 4 else 2, f"tick {i}: attitude nominal")
    emit(n - 2, 3, "battery: cell 2 below 3.5 V")
    emit(n - 1, 4, "nav: GPS fix lost")
    client.close()
    return n


def main(argv: list[str]) -> None:
    """The ball sim serving on its address (the sim CLI's arguments
    ``argv``), with the producer started as an s10 process beside it."""
    from ... import s10
    from ...cli import serve_addr
    from ..ball.sim import SIM_TIME_STEP, system, world

    addr = serve_addr(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    path = os.environ.get("PYTHONPATH", "")
    recipe = s10.PyRecipe.process(
        "log-client",
        sys.executable,
        ["-m", __spec__.name, "--producer", addr],
        env={**os.environ,
             "PYTHONPATH": os.pathsep.join(p for p in (root, path) if p)},
    )
    sup = s10.Supervisor()
    sup.start([recipe])
    try:
        w = world(seed=1)
        w.run(system(), simulation_rate=1.0 / SIM_TIME_STEP)
    finally:
        sup.stop_all()


if __name__ == "__main__":
    if "--producer" in sys.argv:
        log_producer(sys.argv[sys.argv.index("--producer") + 1])
        sys.exit(0)
    main(sys.argv[1:])
