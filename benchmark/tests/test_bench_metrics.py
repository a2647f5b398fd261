"""Each metric's arithmetic on a synthetic trace, and the frozen counts."""

import pytest

from benchmark.harness import peaks, spec
from benchmark.harness import trace as tr
from benchmark.harness.runner import Window

MS = 1_000_000  # ns


def _trace(ops, calls, ticks=10, bodies=8192, window=(0, 100 * MS)):
    """ops: (name, start ms, dur ms); calls: (start ms, end ms)."""
    spans = [tr.Span(tr.WINDOW, *window)]
    spans += [tr.Span(tr.CALL, a * MS, b * MS) for a, b in calls]
    spans += [tr.Span(tr.ISSUE, a * MS, (a + b) // 2 * MS) for a, b in calls]
    return tr.Trace([tr.Op(n, int(s * MS), int(d * MS), 0, int(s * MS)) for n, s, d in ops],
                    spans, ticks, bodies, "float64", 132)


def read(name, trace):
    return spec.metric_reader(name)(trace)


def test_ops_are_placed_in_the_calls_that_issued_them():
    t = _trace([("k", 1, 2), ("copy", 25, 1), ("k", 31, 2)], [(0, 20), (30, 50)])
    assert t.calls == 2 and [op.start_ns for op in t.call_ops] == [1 * MS, 31 * MS]
    assert t.ticks == 20
    # by the host's launch: an op the device starts after its call's span
    # ended still belongs to the call that launched it
    late = tr.Op("k", 21 * MS, MS, 0, 19 * MS)
    t = tr.Trace([late], [tr.Span(tr.WINDOW, 0, 100 * MS), tr.Span(tr.CALL, 0, 20 * MS)],
                 10, 8192, "float64", 132)
    assert t.call_ops == [late]


def test_busy_idle_and_breakdown():
    t = _trace([("a", 10, 20), ("b", 20, 20), ("a", 60, 10)], [(0, 50), (55, 90)])
    assert t.busy_s() == pytest.approx(0.040)  # [10, 40] and [60, 70]
    assert read("device_idle_pct", t) == pytest.approx(60.0)
    b = tr.breakdown(t)
    assert b["device_ops"] == [["a", 0.030], ["b", 0.020]]
    # [70, 100], [40, 60] and [0, 10], named by the span at each middle
    assert b["idle_gaps"] == [["call", pytest.approx(0.030)], ["call", pytest.approx(0.020)],
                              ["issue", pytest.approx(0.010)]]


def test_k1_roofline_and_wrapper():
    bound, resource = peaks.sixdof_rollout_bound_s(8192, 4000, "float64", 132)
    assert resource == "pipe" and bound == pytest.approx(8192 * 4000 * 607 / 34e12)
    ms = bound * 1e3 * 2  # each launch at half its bound
    t = _trace([("void sixdof_rk4_kernel<double>", 1, ms), ("cat", 0.5, 0.25),
                ("void sixdof_rk4_kernel<double>", 11, ms), ("copy", 12 + ms, 0.25)],
               [(0, 10), (10.5, 20)], ticks=4000)
    assert read("k1_roofline", t) == pytest.approx(50.0)
    assert read("wrapper_device_ms_per_call", t) == pytest.approx(0.25)


def test_ecs_ops_and_time():
    # two calls of two ticks; a K2 launch, were one there, is no ECS time
    ops = [("add", 1 + 10 * k, 0.5) for k in range(4)]
    ops += [("mul", 2 + 10 * k, 0.25) for k in range(4)]
    ops += [("pairwise_gravity_kernel<double>", 3, 1.0)]
    t = _trace(ops, [(0, 20), (20, 40)], ticks=2)
    assert read("device_ops_per_tick", t) == 2.25
    assert read("ecs_device_ms_per_tick", t) == pytest.approx(0.75)
    assert read("k1_roofline", t) is None and read("wrapper_device_ms_per_call", t) is None


def test_an_empty_trace_reads_nothing():
    t = _trace([], [(0, 20)])
    for m in spec.load_benchmark()["per_layer"]:
        assert read(m["name"], t) is None


def test_end_to_end_metrics():
    w = Window(calls=4, call_ms=[1.0, 2.0, 3.0, 4.0], wall_s=2.0, entity_steps=4000,
               setup_s=12.5)
    assert read("entity_steps_per_s", w) == 2000.0
    assert read("call_ms_p95", w) == pytest.approx(3.85)
    assert read("setup_s", w) == 12.5


def test_exec_call_ms_p95_reads_the_traced_calls():
    t = _trace([("add", 1, 0.5)], [(0, 20)])
    t.call_ms = [1.0, 2.0, 3.0, 4.0]
    assert read("exec_call_ms_p95", t) == pytest.approx(3.85)


def test_frozen_counts_follow_their_algebra():
    # K1: four stages of 65, three steps of 69 (the last RK4 sums halved),
    # the tick's end 56; in f64 6 a reciprocal and 8 a reciprocal root
    assert peaks.SIXDOF_TICK_OPS["float32"] == 4 * 65 + 3 * (27 + 18 + 24) - 12 + (27 + 11 + 18)
    assert peaks.SIXDOF_TICK_OPS == {"float32": 511, "float64": 607}
    assert peaks.SIXDOF_TICK_SFU == 13
    bound, resource = peaks.sixdof_rollout_bound_s(8192, 4000, "float32", 132)
    assert resource == "pipe" and bound == pytest.approx(8192 * 4000 * 511 / 67e12)
    # the SFU sets the bound where the pipe is wide: one result a pair
    bound, resource = peaks.bound_s(1.0, 1e12, 0.0, "float64", 132)
    assert resource == "sfu" and bound == pytest.approx(1e12 / (16 * 132 * 1.98e9))
