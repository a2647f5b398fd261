"""BENCHMARK.json and the files it names: each parses, and keeps the form
the harness and the check read."""

import json
import re

import pytest

from benchmark.harness import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]
RUNNER_KEYS = ("entry", "bodies", "ticks_per_call", "compared_calls", "limits", "why", "chips",
               "cpu_test")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1] == "benchmark/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.fullmatch(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_files_parse(name):
    conf = {c["name"]: c for c in BENCH["configs"]}[name]
    data = json.loads((spec.ROOT / conf["file"]).read_text())
    assert data["name"] == name and data["dtype"] in ("float64", "float32")
    assert conf["reduced"] == [] or all(NAME.fullmatch(k) for k in conf["reduced"])
    assert (spec.BENCH_DIR / "configs" / f"{name}.py").is_file()


def test_four_chips_only_for_a_quarter_of_the_cells():
    """A cell asks for 1 chip or 4; at most a quarter of the cells, rounded
    down, ask for 4, and one always may."""
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_parse(name):
    cell = spec.cell(name)
    t = cell.traffic
    # the runner's own keys; cpu_test holds the overrides a CPU test run uses
    for key in RUNNER_KEYS:
        assert key in t, key
    assert cell.chips == t["chips"] and t["chips"] in (1, 4)
    assert t["why"] == {w["name"]: w for w in BENCH["workloads"]}[name]["why"]
    assert isinstance(t["cpu_test"], dict)
    # calls sent ahead of the host's wait; 0, a closed loop, where it is left out
    ahead = t.get("ahead_calls", 0)
    assert isinstance(ahead, int) and ahead >= 0
    entry = cell.entry()
    assert hasattr(entry, "Driver")
    for key in entry.KEYS:  # what the cell's entry reads
        assert key in t, f"entries/{t['entry']}.py reads {key!r}, which the cell lacks"
    reference = cell.reference()
    for function in entry.REFERENCE:
        assert callable(getattr(reference, function, None)), \
            f"configs/{cell.config_name}.py has no {function}, which entries/{t['entry']}.py calls"
    faults = spec.BENCH_DIR / "tests" / "faults" / f"{t['entry']}.py"
    assert faults.is_file(), f"no {faults.relative_to(spec.BENCH_DIR)}: the faults of entry " \
        f"{t['entry']!r}, which the CPU tests plant under its timed path"
    assert callable(spec.load_module(faults).broken)
    assert set(t["limits"]) >= {"state_gap"}
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_its_reader(metric):
    assert callable(spec.metric_reader(metric["name"]))
    for cell in metric.get("workloads", []):
        assert cell in CELLS
