"""Whole runs on the CPU: the command finds no card and gives no result;
past that look, a run whose timed path is broken underneath comes out
not correct."""

import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import runner, spec
from benchmark.harness.spec import ROOT

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def small(name):
    """The cell's overrides for a test run (its ``cpu_test``): each cell
    shrunk to what a test run holds, the rest of its traffic as it is."""
    return spec.cell(name).traffic["cpu_test"]


def fault_file(name):
    """``tests/faults/<entry>.py``, the faults of the cell's entry."""
    return spec.BENCH_DIR / "tests" / "faults" / f"{spec.cell(name).traffic['entry']}.py"


def faults(name):
    return spec.load_module(fault_file(name))


@pytest.mark.parametrize("name", CELLS)
def test_the_command_without_a_card_fails_and_prints_no_result(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          "2147483659", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout and "no result" in out.stderr


def test_alone_in_a_directory_it_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                          "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    r = runner.run(name, 2147483647 + 12, 0.4, False, device="cpu", overrides=small(name))
    assert r["correct"] and r["failed"] == 0, r["compared"]
    assert list(r)[-1] == "compared" and r["attempted"] >= 1


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, kind, monkeypatch):
    monkeypatch.setattr(*faults(name).broken(kind))
    r = runner.run(name, 2147483647 + 21, 0.4, False, device="cpu", overrides=small(name))
    assert not r["correct"] and r["failed"] >= 1, r["compared"]


# a cell without its fault file fails test_bench_spec.py::test_cell_files_parse
@pytest.mark.parametrize("name", [c for c in CELLS
                                  if fault_file(c).is_file() and hasattr(faults(c), "left_out")])
def test_a_call_left_out_between_the_compared_ones_is_not_correct(name, monkeypatch):
    """A cell that continues one state across calls: the window's first
    call, never compared, leaves the state as it was.  The calls compared
    from the program's own state read sound, and the number the entry's
    fault file names (``LEFT_OUT_SEEN_BY``: the last state against the
    reference's every tick from the start) does not."""
    fault = faults(name)
    monkeypatch.setattr(*fault.left_out())
    r = runner.run(name, 2147483647 + 45, 0.4, False, device="cpu", overrides=small(name))
    compared, seen_by = r["compared"], fault.LEFT_OUT_SEEN_BY
    assert compared["state_gap"]["value"] <= compared["state_gap"]["limit"], compared
    assert compared[seen_by]["value"] > compared[seen_by]["limit"], compared
    assert not r["correct"] and r["failed"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference computed one precision lower, judged in the program's
    place, fails the cell's limit (at a size a test run holds)."""
    r = runner.run(name, 2147483647 + 33, 0.4, False, device="cpu", overrides=small(name),
                   control=True)
    assert not r["correct"], r["compared"]
