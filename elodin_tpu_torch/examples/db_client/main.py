"""DB client example in torch (counterpart of ``examples/db-client/main.py``;
parity target: reference examples/db-client): launch the ball sim as an s10
recipe, attach with ``elodin_tpu_torch.db.Client``, read live telemetry, run
SQL and EQL, write external telemetry back.

    ELODIN_MAX_TICKS=400 python -m elodin_tpu_torch.examples.db_client.main [--device cpu]

The sim is a child process (``python -m elodin_tpu_torch run
elodin_tpu_torch.examples.ball.sim ADDR``), on the card unless ``--device``
says otherwise; it serves until it is stopped, and ``stop`` ends its whole
process group.
"""

import argparse
import os
import time

from ... import db as edb
from ... import s10

ADDR = os.environ.get("ELODIN_SIM_ADDR", "127.0.0.1:2263")
BALL = "elodin_tpu_torch.examples.ball.sim"


def run(addr: str = ADDR, device=None, env=None, timeout_s: float = 60.0) -> dict:
    """Start the sim, read and write through a client, stop the sim.
    Returns what the client saw: ``components``, ``latest``,
    ``series_rows``, ``sql_rows``, ``written`` (the value read back),
    ``startup_s`` (spawn to five ``ball.world_pos`` rows served) and ``pgid``
    (the stopped child's process group)."""
    recipe = s10.PyRecipe.sim("ball-sim", BALL, addr, device=device)
    recipe.inner.env["ELODIN_KEEP_ALIVE"] = "1"
    recipe.inner.env.update(env or {})
    t0 = time.perf_counter()
    running = recipe.spawn()
    out = {"pgid": os.getpgid(running.proc.pid)}
    try:
        client = _connect_with_retry(addr, timeout_s, running)
        # wait for telemetry: a few rows, so that the SQL below has its 5
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            comps = client.components()
            if "ball.world_pos" in comps and len(
                    client.time_series("ball.world_pos", 0, 2**62, limit=5)[0]) == 5:
                break
            if running.poll() is not None:
                raise SystemExit(f"the sim exited with {running.poll()}")
            time.sleep(0.25)
        else:
            raise SystemExit(
                "timed out waiting for ball.world_pos telemetry — did the "
                "sim fail to start?"
            )
        out["startup_s"] = time.perf_counter() - t0
        out["components"] = sorted(comps)
        print("components:", sorted(comps)[:6], "...")

        sample = client.latest("ball.world_pos")
        out["latest"] = sample.values
        print("latest ball.world_pos:", sample.values)

        ts, zs = client.time_series("ball.world_pos", 0, 2**62, limit=50)
        out["series_rows"] = len(ts)
        print(f"time series: {len(ts)} rows, z range "
              f"[{zs[:, 6].min():.2f}, {zs[:, 6].max():.2f}]")

        table = client.sql(
            f"SELECT * FROM {edb.sql_table_name('ball.world_pos')} LIMIT 5"
        )
        out["sql_rows"] = table.num_rows
        print("sql rows:", table.num_rows)

        client.send("ground.station_temp", [21.5], timestamp_us=int(time.time() * 1e6))
        deadline = time.time() + timeout_s
        while "ground.station_temp" not in client.components():
            if time.time() > deadline:
                raise SystemExit("the write back never arrived")
            time.sleep(0.05)
        out["written"] = client.latest("ground.station_temp").values
        print("wrote ground.station_temp:", out["written"])

        # editor-grade downsample query: LTTB sparkline (a scalar series —
        # sparkline plots element 0, and world_pos element 0 is the
        # constant quaternion-x, a degenerate demo)
        ts_s, vals_s = client.sparkline("ground.station_temp", 32)
        print(f"sparkline: {len(ts_s)} points, last value {vals_s[-1]:.3f}")

        # downsampled element window (plot panel initial load)
        ts_p, vz = client.plot_overview("ball.world_pos", max_points=64,
                                        element_index=6)
        print(f"plot overview: {len(ts_p)} points, z range "
              f"[{vz.min():.2f}, {vz.max():.2f}]")
        client.close()
    finally:
        running.stop()
    return out


def _connect_with_retry(addr: str, timeout_s: float, running=None) -> edb.Client:
    deadline = time.time() + timeout_s
    while True:
        try:
            return edb.Client.connect(addr)
        except OSError:
            if running is not None and running.poll() is not None:
                raise SystemExit(f"the sim exited with {running.poll()}")
            if time.time() > deadline:
                raise
            time.sleep(0.25)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--addr", default=ADDR)
    ap.add_argument("--device", default=None,
                    help="the sim's device (default: the card)")
    args = ap.parse_args(argv)
    run(args.addr, device=args.device)


if __name__ == "__main__":
    main()
