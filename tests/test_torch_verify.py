"""The port's ``verify``, ``Exec.save_archive`` and telemetry regression
gate (``elodin_tpu_torch.regress``), on the CPU, with three-body.

Stated tolerances:

* Three-body, 240 ticks of ``Exec`` against the JAX example: ≤ 1e-10 per
  channel group (max |Δ| / max |ref|).
* The regression gate: every column of ``scripts/baseline/three-body``,
  vector columns included, within abs or rel 1e-4
  (``scripts/baseline/tolerances.json``), 241 rows.  The drone's and the
  cube-sat's re-exported baselines (``regress.REEXPORTED``) hold the JAX
  examples' exports of today with no failure (largest share ≤ 1e-6),
  where ``scripts/baseline`` fails them.
* ``save_archive``: the CSV read back equals the history bitwise (a float
  is written as its shortest round-trip repr); so do Parquet and Arrow.
* ``verify_trajectory(devices=("cpu", "cpu"))``: the same program twice on
  one device, bitwise; the port's ``_diff`` equals the JAX package's on
  the same columns exactly.
"""

import importlib.util
import math
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

import elodin_tpu_torch as el
from elodin_tpu import verify as jverify
from elodin_tpu_torch import regress, verify
from elodin_tpu_torch.examples.three_body import main as ttb
from torch_port_util import float_policy, jax_example, rel_err, rel_errs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TICKS = regress.TICKS


@pytest.fixture(autouse=True)
def _f64():
    with float_policy("f64"):
        yield


def jthree_body():
    return jax_example("three-body", "main")


@pytest.fixture(scope="module")
def three_body(tmp_path_factory):
    """(Exec after 240 ticks on the CPU, its CSV archive directory)."""
    out = tmp_path_factory.mktemp("three-body")
    with float_policy("f64"):
        exec_, _ = regress.export("three-body", out, device="cpu")
    return exec_, out


def test_three_body_240_ticks(three_body):
    ours, _ = three_body
    jb = jthree_body()
    ref = jb.w.build(jb.sys, simulation_rate=1.0 / jb.SIM_TIME_STEP)
    ref.run(TICKS)
    assert ours.tick() == TICKS
    for k in ("world_pos", "world_vel", "world_accel", "force"):
        r = np.asarray(ref.column_array(k))
        assert rel_err(ours.column_array(k), r) <= 1e-10, (k, rel_errs(ours.column_array(k), r))
    np.testing.assert_array_equal(ours.column_array("gravity_edge"),
                                  np.asarray(ref.column_array("gravity_edge")))
    assert ours._history.column_names() == ref._history.column_names()


# ---------------------------------------------------------------------------
# save_archive and the gate
# ---------------------------------------------------------------------------


def test_three_body_passes_the_csv_gate(three_body):
    _, out = three_body
    base = os.path.join(regress.BASELINE_ROOT, "three-body")
    n, failures, worst = regress.compare(base, out, regress.load_tolerances(
        os.path.join(regress.BASELINE_ROOT, "tolerances.json")))
    assert n == 23 and failures == [] and worst <= 1e-6
    assert len(regress.load_csv(os.path.join(out, "a.world_pos.csv"))["a.world_pos"]) == TICKS + 1


def test_check_runs_the_gate_in_a_directory_it_removes(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    exec_, wall, n, worst = regress.check("three-body", device="cpu")
    assert exec_.tick() == TICKS and wall > 0.0
    assert n == 23 and worst <= 1e-6
    assert os.listdir(tmp_path) == []


def test_save_archive_reads_back_as_the_history(three_body):
    exec_, out = three_body
    names = exec_._history.column_names()
    assert sorted(f[:-4] for f in os.listdir(out)) == sorted(names)
    for name in names:
        frame = exec_.history_frame([name])
        cols = regress.load_csv(os.path.join(out, f"{name}.csv"))
        assert list(cols) == ["time", name]
        hist = frame[name].to_numpy()
        back = np.stack([np.asarray(v) for v in cols[name]]).reshape(hist.shape)
        np.testing.assert_array_equal(back, hist.astype(np.float64), err_msg=name)
    with open(os.path.join(out, "a.world_pos.csv")) as f:
        f.readline()
        time, cell = f.readline().rstrip("\n").split(",", 1)
    assert time == str(exec_.history_frame(["a.world_pos"])["time"][0])
    assert cell == '"[0.0, 0.0, 0.0, 1.0, 0.8920281421, 0.0, 0.0]"'


def test_save_archive_refuses_parquet_and_arrow(three_body, tmp_path):
    """Parquet and Arrow IPC, which the archive once refused, are written
    (Parquet by default, as in the JAX package) and read back as the
    history; an unknown format is still refused."""
    import pyarrow.ipc as ipc
    import pyarrow.parquet as pq

    exec_, _ = three_body
    names = exec_._history.column_names()
    exec_.save_archive(tmp_path / "pq")
    exec_.save_archive(tmp_path / "arrow", "arrow")
    assert sorted(os.listdir(tmp_path / "pq")) == sorted(f"{n}.parquet" for n in names)
    assert sorted(os.listdir(tmp_path / "arrow")) == sorted(f"{n}.arrow" for n in names)
    for name in names:
        hist = exec_.history_frame([name])
        for table in (pq.read_table(tmp_path / "pq" / f"{name}.parquet"),
                      ipc.open_file(str(tmp_path / "arrow" / f"{name}.arrow")).read_all()):
            assert table.column_names == ["time", name]
            back = np.asarray(table.column(name).to_pylist())
            np.testing.assert_array_equal(back.reshape(hist[name].to_numpy().shape),
                                          hist[name].to_numpy(), err_msg=name)
            np.testing.assert_array_equal(table.column("time").to_numpy(),
                                          hist["time"].to_numpy())
    with pytest.raises(ValueError):
        exec_.save_archive(tmp_path, "xml")


def _rewrite(path, row, fn):
    with open(path) as f:
        lines = f.readlines()
    lines[row] = fn(lines[row])
    with open(path, "w") as f:
        f.writelines(lines)


def test_the_gate_holds_vector_cells(three_body, tmp_path):
    """A vector cell that moved beyond the tolerance fails the port's gate;
    the JAX package's reader turns every vector cell into NaN on both
    sides and so passes it (``scripts/compare_baseline_csv.py:13-24,74-75``)."""
    _, out = three_body
    base = os.path.join(regress.BASELINE_ROOT, "three-body")
    bad = tmp_path / "bad"
    shutil.copytree(out, bad)
    _rewrite(bad / "a.world_pos.csv", 101, lambda s: s.replace(", 0.0]", ", 0.001]"))
    _rewrite(bad / "b.world_vel.csv", 7, lambda s: s.replace("[0.0,", "[nan,", 1))
    os.remove(bad / "c.force.csv")
    _rewrite(bad / "a.force.csv", -1, lambda s: "")
    _, failures, _ = regress.compare(base, bad)
    assert any(f.startswith("a.world_pos.csv:a.world_pos[100]: ") for f in failures), failures
    assert any(f.startswith("b.world_vel.csv:b.world_vel[6]: ") and "NaN" in f
               for f in failures), failures
    assert "c.force.csv: missing from actual export" in failures
    assert "a.force.csv:a.force: row count 240 vs 241" in failures
    assert len(failures) == 4

    spec = importlib.util.spec_from_file_location(
        "ref_compare_baseline_csv", os.path.join(REPO, "scripts", "compare_baseline_csv.py"))
    ref_reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_reader)
    cells = ref_reader.load_csv(str(bad / "a.world_pos.csv"))["a.world_pos"]
    assert all(math.isnan(c) for c in cells)


@pytest.mark.parametrize("example", regress.REEXPORTED)
def test_reexported_baselines_are_the_jax_examples_exports(example, tmp_path):
    """What ``scripts/export_example.py EXAMPLE 240 DIR`` writes today
    passes the gate against the stored re-export with no failure, and fails
    it against ``scripts/baseline``, which predates the JAX example."""
    mod = jax_example(example, "main")
    rate = 1.0 / getattr(mod, "SIM_TIME_STEP", regress.DEFAULT_TIME_STEP)
    ex = mod.build_world().build(mod.build_system(), simulation_rate=rate)
    ex.run(regress.TICKS)
    ex.save_archive(str(tmp_path), "csv")
    tol = regress.load_tolerances(os.path.join(regress.BASELINE_ROOT, "tolerances.json"))
    n, failures, worst = regress.compare(regress.baseline_dir(example), tmp_path, tol)
    assert failures == [] and worst <= 1e-6 and n == len(os.listdir(tmp_path))
    _, stale, _ = regress.compare(os.path.join(regress.BASELINE_ROOT, example), tmp_path, tol)
    assert stale


# ---------------------------------------------------------------------------
# verify
# ---------------------------------------------------------------------------


def test_verify_trajectory_cpu_twice_is_bitwise():
    report = verify.verify_trajectory(ttb.build_world(), ttb.build_system(), ticks=100,
                                      simulation_rate=120.0, devices=("cpu", "cpu"))
    summary = report["_summary"]
    assert summary["ticks"] == 100 and summary["devices"] == ["cpu", "cpu"]
    assert summary["max_abs"] == 0.0 and summary["max_excess"] <= 0.0
    assert set(report) == {"_summary", "tick", "simulation_time_step", "world_pos",
                           "world_vel", "inertia", "force", "world_accel", "gravity_edge"}


def test_verify_step_cpu_twice():
    report = verify.verify_step(ttb.build_world(), ttb.build_system(), devices=("cpu", "cpu"))
    assert all(v["max_abs"] == 0.0 for v in report.values())


def _drifting_world(offset):
    """One body whose position moves by ``offset`` a tick on every run of
    the program after the first ``ticks`` calls: the two devices' runs
    differ by ``ticks * offset``."""
    calls = [0]

    def drift(builder):
        calls[0] += 1
        pos = builder.column("world_pos")
        builder.cols["world_pos"] = pos + (offset if calls[0] > 10 else 0.0)

    w = el.World()
    w.spawn(el.Body(world_pos=el.SpatialTransform(linear=np.array([1.0, 2.0, 3.0]))),
            name="body")
    return w, el.LambdaSystem(drift, "drift")


@pytest.mark.parametrize("offset,fails", [(4e-8, False), (1e-3, True), (math.nan, True)])
def test_verify_trajectory_holds_allclose(offset, fails):
    w, sys_ = _drifting_world(offset)
    if fails:
        with pytest.raises(AssertionError, match="world_pos"):
            verify.verify_trajectory(w, sys_, ticks=10, devices=("cpu", "cpu"))
    else:
        report = verify.verify_trajectory(w, sys_, ticks=10, devices=("cpu", "cpu"))
        assert 0.0 < report["world_pos"]["max_abs"] <= 1e-6


def test_verify_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (verify.verify_trajectory, verify.verify_step):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(ttb.build_world(), ttb.build_system())


def test_diff_is_the_jax_package_s():
    rng = np.random.default_rng(2)
    a = {"x": rng.standard_normal((5, 7)), "tick": np.arange(5, dtype=np.uint64),
         "z": np.zeros((0, 3))}
    b = {"x": a["x"] + rng.standard_normal((5, 7)) * 1e-7, "tick": a["tick"], "z": a["z"]}
    b["x"][2, 3] = np.nan
    ours, ref = verify._diff(a, b), jverify._diff(a, b)
    for k in ref:
        for m in ("max_abs", "max_rel", "metric_rel", "max_excess"):
            assert ours[k][m] == ref[k][m] or (math.isnan(ours[k][m]) and math.isnan(ref[k][m]))
    for fn in (verify._assert_tol, jverify._assert_tol):
        with pytest.raises(AssertionError):
            fn(ours, 1e-6, 1e-6)
        fn({k: v for k, v in ours.items() if k != "x"}, 1e-6, 1e-6)
