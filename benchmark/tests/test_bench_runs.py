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
# each cell shrunk to what a test run holds; the rest of the traffic as it is
SMALL = {"leo6dof.rollout-8k": {"bodies": 48, "ticks_per_call": 40},
         "nbody.fold-8k": {"bodies": 64}}
STATE = ("world_pos", "world_vel")


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
    r = runner.run(name, 2147483647 + 12, 0.4, False, device="cpu", overrides=SMALL[name])
    assert r["correct"] and r["failed"] == 0, r["compared"]
    assert list(r)[-1] == "compared" and r["attempted"] >= 1


def _rollout_fault(kind):
    from elodin_tpu_torch.ops import sixdof_kernel

    real = sixdof_kernel.sixdof_rollout

    def broken(pos, vel, inertia, dt, ticks, **kw):
        if kind == "unchanged":  # the state returned as it came
            return pos.clone(), vel.clone()
        p, v = real(pos, vel, inertia, dt, ticks, **kw)
        if kind == "half":  # half of the bodies left out
            n = pos.shape[0] // 2
            p[n:], v[n:] = pos[n:], vel[n:]
        else:  # one answer altered where it is produced
            p[0, 4] *= 1 + 1e-6
        return p, v

    return sixdof_kernel, "sixdof_rollout", broken


def _exec_fault(kind):
    from elodin_tpu_torch import execimpl

    real = execimpl.Exec.run

    def broken(self, ticks=1, **kw):
        if kind == "unchanged":  # the state left as it was
            return None
        before = dict(self.cols)
        real(self, ticks, **kw)
        if kind == "half":  # half of the bodies left out
            n = before["world_pos"].shape[0] // 2
            for c in STATE:
                self.cols[c] = torch.cat([self.cols[c][:n], before[c][n:]])
        else:  # one answer altered where it is produced
            vel = self.cols["world_vel"].clone()
            vel[1, 3] *= 1 + 1e-6
            self.cols["world_vel"] = vel

    return execimpl.Exec, "run", broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, kind, monkeypatch):
    entry = spec.cell(name).traffic["entry"]
    monkeypatch.setattr(*(_rollout_fault if entry == "rollout" else _exec_fault)(kind))
    r = runner.run(name, 2147483647 + 21, 0.4, False, device="cpu", overrides=SMALL[name])
    assert not r["correct"] and r["failed"] >= 1, r["compared"]


@pytest.mark.parametrize("name", [c for c in CELLS if spec.cell(c).traffic["entry"] == "exec"])
def test_a_call_left_out_between_the_compared_ones_is_not_correct(name, monkeypatch):
    """The window's first call, never compared (the first point lies 5 % into
    the window), leaves the state as it was: the calls compared from the
    program's own state read sound, and the last state against the
    reference's every tick from the start does not."""
    from elodin_tpu_torch import execimpl

    real, runs = execimpl.Exec.run, []

    def broken(self, ticks=1, **kw):
        runs.append(ticks)
        if len(runs) == 3:  # set-up's two calls, then the window's first
            return None
        return real(self, ticks, **kw)

    monkeypatch.setattr(execimpl.Exec, "run", broken)
    r = runner.run(name, 2147483647 + 45, 0.4, False, device="cpu", overrides=SMALL[name])
    compared = r["compared"]
    assert compared["state_gap"]["value"] <= compared["state_gap"]["limit"], compared
    assert compared["late_gap"]["value"] > compared["late_gap"]["limit"], compared
    assert not r["correct"] and r["failed"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference computed one precision lower, judged in the program's
    place, fails the cell's limit (at a size a test run holds)."""
    r = runner.run(name, 2147483647 + 33, 0.4, False, device="cpu", overrides=SMALL[name],
                   control=True)
    assert not r["correct"], r["compared"]
