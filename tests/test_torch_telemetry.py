"""The port's telemetry pump and tick metrics, on the CPU.

* The pump against the synchronous path: the cube-sat, 60 ticks with
  history at a telemetry stride of 1 and 4 ticks, with a history small
  enough to spill: every series, every time, the spill count and the
  history after ``StepContext.truncate`` bitwise equal to the same run with
  each commit copied on the step loop (``Exec._sync_history``).  No tensor
  handed to the pump is written in place afterwards.
* A writer's error is raised again at the next ``flush_telemetry`` (and
  at the next submit); with ``ELODIN_COMMIT_QUEUE=1`` and a slow writer the
  stalls are counted.
* ``history_frame``, ``state_at`` and ``StepContext.truncate`` flush
  first: each reads right after ``run(30)``, with a writer slowed so that
  a read that did not wait would miss rows.
* The database's tap takes one stacked batch a ``run`` (at most
  ``_MAX_BATCHES`` commits) and one a lockstep exchange, its rows and
  timestamps those of the history, with one ``commit_hist`` sample a batch.
* ``Log2Histogram`` / ``TickMetrics`` / ``ELODIN_SIM_SUMMARY_JSON`` as in
  ``tests/test_core.py``, the port's summaries equal to the JAX
  package's for the same observations.
"""

import gc
import json
import threading
import time

import numpy as np
import pytest

import elodin_tpu_torch as tel
from elodin_tpu.tick_metrics import Log2Histogram as JHistogram
from elodin_tpu_torch.examples.cube_sat import main as tc
from elodin_tpu_torch.examples.three_body import main as ttb
from elodin_tpu_torch.execimpl import History
from elodin_tpu_torch.tick_metrics import Log2Histogram, TickMetrics
from torch_port_util import float_policy

CUBE_SAT_TICKS = 60
SPILL_BYTES = 8 << 10  # a cube-sat row is 1544 bytes


@pytest.fixture(autouse=True)
def _f64():
    with float_policy("f64"):
        yield


def _cube_sat(stride, sync, spool):
    ex = tc.build_world().build(tc.build_system(), simulation_rate=1.0 / tc.SIM_TIME_STEP,
                                telemetry_rate=120.0 / stride, device="cpu")
    ex._sync_history = sync
    ex._history._spool_dir = str(spool)
    return ex


def _watch_submits(ex):
    """Record every tensor handed to the pump with its in-place version."""
    seen = []
    pump = ex._ensure_pump()
    submit = pump.submit

    def watched(ts, stacked):
        seen.extend((t, t._version) for t in stacked.values())
        submit(ts, stacked)

    pump.submit = watched
    return seen


def _history(ex):
    h = ex._history
    return (list(h.times), {k: h.series(k) for k in ex.meta.components},
            {k: len(v) for k, v in h._spills.items()})


@pytest.mark.parametrize("stride", [1, 4])
def test_pump_history_equals_the_synchronous_path_bitwise(stride, tmp_path, monkeypatch):
    monkeypatch.setenv("ELODIN_HISTORY_MAX_BYTES", str(SPILL_BYTES))
    runs = {}
    for sync in (False, True):
        ex = _cube_sat(stride, sync, tmp_path / f"spool{sync}")
        seen = [] if sync else _watch_submits(ex)
        ex.run(CUBE_SAT_TICKS)
        ex.flush_telemetry()
        assert all(t._version == v for t, v in seen), "a submitted tensor was written in place"
        assert len(seen) == (0 if sync else CUBE_SAT_TICKS // stride * len(ex.meta.components))
        before = _history(ex)
        tel.StepContext(ex).truncate()
        ex.run(2 * stride)
        ex.flush_telemetry()
        runs[sync] = before, _history(ex)
    for (times_p, series_p, spills_p), (times_s, series_s, spills_s) in zip(runs[False], runs[True]):
        assert times_p == times_s
        assert spills_p == spills_s
        for k in series_s:
            assert series_p[k].dtype == series_s[k].dtype, k
            np.testing.assert_array_equal(series_p[k], series_s[k], err_msg=k)
    times, _, spills = runs[False][0]
    assert len(times) == CUBE_SAT_TICKS // stride + 1 and max(spills.values()) >= 2
    assert runs[False][1][0] == [(i + 1) * stride * ex.sim_time_step for i in range(2)]


def _slow_writer(ex, seconds):
    pump = ex._ensure_pump()
    append = pump.history.append_batch

    def slow(ts, stacked):
        time.sleep(seconds)
        append(ts, stacked)

    pump.history.append_batch = slow
    return pump


def test_a_writer_error_is_raised_at_the_next_flush_and_submit():
    ex = ttb.build_world().build(ttb.build_system(), device="cpu")
    pump = ex._ensure_pump()

    def boom(ts, stacked):
        raise OSError("disk full")

    pump.history.append_batch = boom
    ex.run(1)
    with pytest.raises(OSError, match="disk full"):
        ex.flush_telemetry()
    ex.flush_telemetry()  # raised once
    ex.run(1)
    pump.q.join()
    with pytest.raises(OSError, match="disk full"):
        ex.run(1)  # the next submit raises it


def test_a_full_queue_blocks_the_producer_and_counts_a_stall(monkeypatch):
    monkeypatch.setenv("ELODIN_COMMIT_QUEUE", "1")
    ex = ttb.build_world().build(ttb.build_system(), device="cpu")
    pump = ex._ensure_pump()
    assert pump.q.maxsize == 1
    append, gate = pump.history.append_batch, threading.Event()

    def held(ts, stacked):
        gate.wait(timeout=60)
        append(ts, stacked)

    # the writer holds the first batch and the queue the second until the
    # gate opens: the third submit finds the queue full and waits
    pump.history.append_batch = held
    timer = threading.Timer(2.0, gate.set)
    timer.start()
    try:
        ex.run(4)
    finally:
        gate.set()
        timer.cancel()
    assert pump.stalls >= 1
    ex.flush_telemetry()
    assert len(ex._history.times) == 5  # nothing lost


def test_reads_flush_the_pump_first():
    ex = ttb.build_world().build(ttb.build_system(), device="cpu")
    _slow_writer(ex, 0.005)
    ex.run(30)
    frame = ex.history_frame(["a.world_pos"])
    assert len(frame["a.world_pos"]) == 31
    np.testing.assert_array_equal(frame["a.world_pos"][-1], ex.column_array("world_pos")[0])
    ex.run(30)
    np.testing.assert_array_equal(ex.state_at(60)["world_pos"], ex.column_array("world_pos"))
    ex.run(30)
    tel.StepContext(ex).truncate()  # flushes: no row of the 30 ticks lands after it
    assert ex.tick() == 0 and ex._history.times == []
    ex.run(3)
    assert len(ex.history_frame("a.world_pos")["a.world_pos"]) == 3


def test_the_writer_thread_ends_with_its_exec():
    ex = ttb.build_world().build(ttb.build_system(), device="cpu")
    ex.run(2)
    thread = ex._pump._thread
    del ex
    gc.collect()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_append_batch_equals_append_state_rows():
    meta, cols = ttb.build_world().snapshot()
    one, batch = History(meta), History(meta)
    rows = [{k: v + i for k, v in cols.items()} for i in range(3)]
    for i, row in enumerate(rows):
        one.append_state(float(i), row)
    batch.append_batch(np.arange(3.0), {k: np.stack([r[k] for r in rows]) for k in cols})
    assert one.times == batch.times
    for k in cols:
        np.testing.assert_array_equal(one.series(k), batch.series(k))


OBSERVATIONS = [0.5, 1.5, 3.0, 100.0, 5000.0, 0.0, 1.0, 2.0**39 * 3]


def test_tick_metrics_histogram():
    h = Log2Histogram()
    for us in OBSERVATIONS[:5]:
        h.observe_us(us)
    s = h.summary()
    assert s["count"] == 5
    assert s["max_us"] == 5000.0
    assert s["p50_us"] <= s["p99_us"]

    m = TickMetrics()
    with m.phase("run"):
        pass
    assert m.summary()["ticks"] == 1


def test_histogram_summaries_equal_the_jax_packages():
    ours, ref = Log2Histogram(), JHistogram()
    for us in OBSERVATIONS:
        ours.observe_us(us)
        ref.observe_us(us)
        assert ours.summary() == ref.summary()
        assert ours.buckets == ref.buckets
        for p in (0.0, 0.1, 0.5, 0.99, 1.0):
            assert ours.percentile_us(p) == ref.percentile_us(p)


def test_sim_summary_json(tmp_path, monkeypatch):
    path = tmp_path / "summary.json"
    monkeypatch.setenv("ELODIN_SIM_SUMMARY_JSON", str(path))
    m = TickMetrics()
    with m.phase("run"):
        pass
    with m.phase("commit"):
        pass
    m.write_summary_json({"rtf": 100.0})
    data = json.loads(path.read_text())
    assert data["ticks"] == 1 and data["rtf"] == 100.0
    assert sorted(data["phases"]) == ["commit", "run"]


@pytest.mark.parametrize("runs, cap, calls", [
    ((30,), None, [30]),            # one run, one tap call, as the JAX package's program
    ((1, 1, 1), None, [1, 1, 1]),   # the served loop's run(1) a tick
    ((20,), 8, [8, 8, 4]),          # a run past the cap on one batch
])
def test_the_tap_takes_one_stacked_batch_a_run(runs, cap, calls, monkeypatch):
    from elodin_tpu_torch import execimpl

    if cap is not None:
        monkeypatch.setattr(execimpl, "_MAX_BATCHES", cap)
    ex = ttb.build_world().build(ttb.build_system(), device="cpu")
    ex.commit_hist = Log2Histogram()
    got = []
    ex.on_commit_batch = lambda ts_us, cols: got.append((ts_us, cols))
    _slow_writer(ex, 0.002)  # the writer wakes to several queued commits
    for n in runs:
        ex.run(n)
    ex.flush_telemetry()
    assert [len(ts) for ts, _ in got] == calls
    assert ex.commit_hist.count == len(calls)
    start = ex._history.start_timestamp.timestamp()
    times = np.asarray(ex._history.times[1:])
    np.testing.assert_array_equal(np.concatenate([ts for ts, _ in got]),
                                  ((start + times) * 1e6).astype(np.int64))
    for k in ex.meta.components:
        np.testing.assert_array_equal(np.concatenate([cols[k] for _, cols in got]),
                                      ex._history.series(k)[1:], err_msg=k)


def test_a_lockstep_exchange_is_one_tap_batch():
    ex = ttb.build_world().build(ttb.build_system(), device="cpu")
    got = []
    ex.on_commit_batch = lambda ts_us, cols: got.append(len(ts_us))
    session = ex.lockstep_session(["a.world_pos"], ["b.world_vel"], hold_ticks=4)
    for _ in range(3):
        session.tick()
    ex.flush_telemetry()
    assert got == [4, 4, 4] and len(ex._history.times) == 13
