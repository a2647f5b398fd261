"""The readers of the program's spans (``wrapper_host_ms_per_call``,
``ecs_host_ms_per_tick``, ``idle_in_program_pct``) on traces built from known
intervals, and in a traced run on the CPU with the port's own recorder."""

from dataclasses import dataclass

import pytest

from benchmark.harness import runner, spec
from benchmark.harness import trace as tr

MS = 1_000_000  # ns


@dataclass
class P:
    """A program span as the port's recorder keeps one."""

    name: str
    start_ns: int
    end_ns: int
    index: int
    parent: int = -1
    child_ns: int = 0


def _spans(rows):
    """(name, start ms, end ms, parent's position in ``rows`` or -1)."""
    out = [P(n, int(a * MS), int(b * MS), k, p) for k, (n, a, b, p) in enumerate(rows)]
    for s in out:
        if s.parent >= 0:
            out[s.parent].child_ns += s.end_ns - s.start_ns
    return out


def _trace(ops, calls, ticks_per_call=1):
    """ops: (name, start ms, dur ms, host ms); calls: (start ms, end ms);
    the window is [0, 100] ms."""
    bench = [tr.Span(tr.WINDOW, 0, 100 * MS)]
    bench += [tr.Span(tr.CALL, a * MS, b * MS) for a, b in calls]
    return tr.Trace([tr.Op(n, int(s * MS), int(d * MS), 0, int(h * MS)) for n, s, d, h in ops],
                    bench, ticks_per_call, 8192, "float64", 132)


def read(name, trace, spans):
    return spec.metric_reader(name)(trace, spans)


def test_wrapper_host_ms_per_call(capsys):
    t = _trace([("void sixdof_rk4_kernel<double>", 12, 5, 11.5),
                ("void sixdof_rk4_kernel<double>", 44, 5, 42), ("cat", 10, 0.1, 10.5)],
               [(10, 30), (40, 60)])
    spans = _spans([
        ("rollout", -8, -2, -1),  # the runner's call before the window
        ("rollout", 10, 14, -1), ("rollout.pack", 10, 11, 1), ("rollout.launch", 11, 12, 1),
        ("rollout.unpack", 12, 13, 1),
        ("rollout", 40, 46, -1), ("rollout.pack", 40, 41, 5), ("rollout.launch", 41, 44, 5),
        ("rollout.unpack", 44, 45, 5)])
    assert read("wrapper_host_ms_per_call", t, spans) == pytest.approx(5.0)
    err = capsys.readouterr().err
    assert "2 rollout spans in 2 calls" in err and "rollout.launch 2," in err
    assert "1 of 1 of the wrapper's ops inside a rollout span (100.000 %)" in err
    assert "2 of 2 sixdof_rk4 ops (by device start) inside rollout.launch (100.000 %)" in err
    # one launch outside its span shows
    spans[3].end_ns = int(11.2 * MS)
    read("wrapper_host_ms_per_call", t, spans)
    assert "1 of 2 sixdof_rk4" in capsys.readouterr().err


def test_ecs_host_ms_per_tick(capsys):
    ops = [("add", 3, 1, 3), ("mul", 6, 1, 6), ("add", 13, 1, 10), ("add", 25, 1, 20.5)]
    t = _trace(ops, [(0, 20), (20, 40)], ticks_per_call=2)
    spans = _spans([
        ("tick", -5, -1, -1),  # before the window
        ("exec.run", 1, 39, -1), ("tick", 2, 8, 1), ("system.a", 2, 4, 2),
        ("fold.dense", 2.5, 3.5, 3), ("tick", 8, 12, 1), ("system.a", 9, 10, 5),
        ("exec.sync", 12, 19, 1), ("tick", 21, 23, 1), ("tick", 23, 29, 1),
        ("fold.probe", 24, 25, 9), ("exec.sync", 29, 38, 1)])
    assert read("ecs_host_ms_per_tick", t, spans) == pytest.approx((6 + 4 + 2 + 6) / 4)
    err = capsys.readouterr().err
    assert "4 tick spans, 4 ticks in the window's calls" in err
    assert "system.a 0.75," in err and "fold.dense 0.25," in err
    assert "the tick's own 3.5;" in err and "fold.probe 0.25 a tick" in err
    # the op launched at 20.5 ms lies between two ticks
    assert "3 of 4 of the calls' device ops inside a tick span (75.000 %)" in err


def _idle_case():
    # busy [5, 20], [30, 50], [70, 80]: idle [0, 5], [20, 30], [50, 70], [80, 100]
    t = _trace([("a", 5, 15, 4), ("b", 30, 20, 28), ("c", 70, 10, 69)], [(1, 90)])
    spans = _spans([
        ("exec.run", -20, -10, -1),  # before the window
        ("exec.run", 2, 60, -1), ("tick", 2, 18, 1), ("system.x", 3, 10, 2),
        ("exec.sync", 20, 28, 1), ("tick", 30, 50, 1), ("exec.sync", 50, 58, 1)])
    return t, spans


def test_idle_in_program_pct(capsys):
    t, spans = _idle_case()
    by = spec.load_module(spec.BENCH_DIR / "metrics" / "idle_in_program_pct.py")
    rows = by.idle_by_span(t, spans)
    # the gap in exec.sync is waiting; [0, 2], [60, 70] and [80, 100] are
    # outside every span; [2, 3] the tick's own, [3, 5] system.x's
    assert {k: v / MS for k, v in rows.items()} == pytest.approx(
        {"outside the program": 32, "exec.sync": 16, "exec.run": 4, "system.x": 2, "tick": 1})
    assert sum(rows.values()) == 55 * MS == pytest.approx((t.window_s() - t.busy_s()) * 1e9)
    assert read("idle_in_program_pct", t, spans) == pytest.approx(100 * 7 / 55)
    line = capsys.readouterr().err.strip()
    total, rest = line.split(" ms idle in the window: ")
    assert float(total.rsplit(" ", 1)[1]) == pytest.approx(55)
    assert sum(float(row.rsplit(" ", 2)[1]) for row in rest.split(", ")) == pytest.approx(55)


def test_without_the_programs_spans_nothing_is_read(monkeypatch):
    """The parent's program records no span: each reader returns nothing
    and raises nothing."""
    from elodin_tpu_torch import tick_metrics

    t, spans = _idle_case()
    names = ("wrapper_host_ms_per_call", "ecs_host_ms_per_tick", "idle_in_program_pct")
    for name in names:
        assert read(name, t, [s for s in spans if s.start_ns < 0]) is None
    monkeypatch.delattr(tick_metrics, "spans")
    for name in names:
        assert spec.metric_reader(name)(t) is None


def test_a_window_whose_first_spans_were_dropped_is_not_read(monkeypatch, capsys):
    from torch.profiler import ProfilerActivity, profile

    from elodin_tpu_torch import tick_metrics

    monkeypatch.setattr(tick_metrics, "_BUFFER", tick_metrics._SpanBuffer(cap=2))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with tick_metrics.span("tick"):
                pass
    t = _trace([("a", 5, 15, 4)], [(1, 90)])
    t.spans[0] = tr.Span(tr.WINDOW, 0, tick_metrics.spans()[-1].end_ns)
    assert spec.metric_reader("ecs_host_ms_per_tick")(t) is None
    assert "1 dropped past the recorder's cap" in capsys.readouterr().err


@pytest.mark.parametrize("name, small, metric", [
    ("leo6dof.rollout-8k", {"bodies": 48, "ticks_per_call": 40}, "wrapper_host_ms_per_call"),
    ("nbody.fold-8k", {"bodies": 64}, "ecs_host_ms_per_tick")])
def test_a_traced_run_reads_the_programs_spans(name, small, metric, capsys):
    """On the CPU the profiler records no device op, so the whole window
    is idle; the spans the port recorded in it are read all the same."""
    r = runner.run(name, 2147483647 + 33, 0.3, True, device="cpu", overrides=small)
    assert r["correct"]
    assert r["metrics"][metric]["value"] > 0
    assert 0 < r["metrics"]["idle_in_program_pct"]["value"] <= 100
    if metric == "ecs_host_ms_per_tick":
        err = capsys.readouterr().err
        spans, ticks = err.split("ecs_host_ms_per_tick: ")[-1].split(" ticks in")[0].split(
            " tick spans, ")
        assert int(spans) == int(ticks) > 0
