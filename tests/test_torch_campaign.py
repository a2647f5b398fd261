"""The port's process-per-sample Monte Carlo campaign
(``monte_carlo.run_campaign``) on its landing entry,
``elodin_tpu_torch/examples/monte_carlo/main.py``, every sample a child
process on the CPU (``device="cpu"``).

* ``tests/test_examples.py``'s three campaign tests: two samples x 50
  ticks on two workers; the quality gate (degraded, not invalid),
  retention, ``perf.csv``, ``resources.csv`` and the out-dir lock; resume
  keeps the whole campaign.
* The whole slice against the JAX package: one sample at the full 2400
  ticks through the port's campaign; its ``result.json`` ``touchdown_vz``
  and ``landing_offset`` within 1e-9 of the JAX package's in-process run of
  the same ``plan.csv`` row (``Exec.run(2400)``, then
  ``read_component``): the landing tolerance of
  ``tests/test_torch_examples.py``.
* ``compact_run_db`` rewrites a run's ``db/`` directory with its rows
  unchanged; ``--device`` reaches each child.
"""

import csv
import json
from pathlib import Path

import numpy as np
import pytest

from elodin_tpu_torch.examples.monte_carlo import main as tlanding
from elodin_tpu_torch.monte_carlo import campaign as tcampaign
from elodin_tpu_torch.monte_carlo import run_campaign
from torch_port_util import float_policy, jax_example

SIM = tlanding.__file__
LANDING_TOL = 1e-9
CONFIG = {
    "monte_carlo": {
        "n_samples": 2,
        "seed": 1,
        "variables": {
            "start_altitude": {"dist": "uniform", "min": 1800, "max": 2200},
        },
    }
}


def test_process_campaign(tmp_path):
    records = run_campaign(SIM, CONFIG, tmp_path / "out", workers=2, max_ticks=50,
                           timeout=300, device="cpu")
    assert len(records) == 2
    assert all(r["valid"] for r in records), records
    assert all(r["ticks"] == 50 for r in records)
    out = tmp_path / "out"
    assert (out / "results.csv").exists() and (out / "summary.json").exists()
    for r in records:
        ctx = json.loads((out / "runs" / r["run_id"] / "context.json").read_text())
        assert ctx["params"]["start_altitude"] == r["param.start_altitude"]
        summary = json.loads((out / "runs" / r["run_id"] / "sim_summary.json").read_text())
        assert summary["ticks"] == 50


def test_campaign_quality_retention_artifacts(tmp_path):
    config = json.loads(json.dumps(CONFIG))
    config["monte_carlo"].update({
        # an impossible pacing bound: every run is degraded
        "quality": {"max_behind_deadline_frac": -1.0},
        "retention": {"keep_run_db": "always", "prune_on_fail": ["context.json"]},
    })
    out = tmp_path / "out"
    records = run_campaign(SIM, config, out, workers=2, max_ticks=50, timeout=300,
                           device="cpu")
    assert all(r["valid"] for r in records)
    assert all(r["degraded"] for r in records)
    summary = json.loads((out / "summary.json").read_text())
    assert summary["degraded"] == 2 and summary["invalid"] == 0
    assert summary["passed"] == 0
    assert (out / "perf.csv").exists()
    assert (out / "resources.csv").exists()
    with open(out / "perf.csv") as f:
        perf = list(csv.DictReader(f))
    assert sorted(r["run_id"] for r in perf) == ["000000", "000001"]
    assert all(float(r["wall_s"]) > 0 and int(r["ticks"]) == 50 for r in perf)
    for r in records:  # degraded runs count as failed: prune_on_fail applied
        assert not (out / "runs" / r["run_id"] / "context.json").exists()

    lock = tcampaign.CampaignLock(out)
    with pytest.raises(RuntimeError, match="locked by pid"):
        run_campaign(SIM, config, out, workers=1, max_ticks=10, device="cpu")
    lock.release()


def test_resume_keeps_the_whole_campaign(tmp_path):
    out = tmp_path / "out"
    first = run_campaign(SIM, CONFIG, out, workers=2, max_ticks=20, timeout=300,
                         device="cpu")
    assert len(first) == 2
    # everything already complete: the resumed run starts nothing but still
    # reports the full campaign
    again = run_campaign(SIM, CONFIG, out, workers=2, max_ticks=20, timeout=300,
                         resume=True, device="cpu")
    assert len(again) == 2
    with open(out / "results.csv") as f:
        assert len(list(csv.DictReader(f))) == 2
    summary = json.loads((out / "summary.json").read_text())
    assert summary["total"] == 2 and summary["valid"] == 2


def test_compacting_a_run_database_keeps_its_rows(tmp_path):
    """``compact_run_db`` rewrites each store of a run's database, as the
    JAX package's retention does; the rows read back unchanged."""
    from elodin_tpu_torch.db.storage import Database

    run_dir = tmp_path / "runs" / "000000"
    db = Database(str(run_dir / "db"))
    store = db.get_or_create(7, "f64", (3,), "craft.pos")
    rows = np.arange(12.0).reshape(4, 3)
    store.append_batch(np.arange(4, dtype=np.int64) * 10, rows)
    db.flush()
    del db, store
    record = {"valid": True, "degraded": False}
    tcampaign._apply_retention(run_dir, record, {"keep_run_db": "always"})
    again = Database(str(run_dir / "db")).components[7]
    assert again.name == "craft.pos" and again.len == 4
    np.testing.assert_array_equal(again.values[:4], rows)
    np.testing.assert_array_equal(again.timestamps[:4], np.arange(4) * 10)
    # dropping a database
    tcampaign._apply_retention(run_dir, record, {"keep_run_db": "never"})
    assert not (run_dir / "db").exists()


def test_the_device_reaches_each_child(tmp_path, monkeypatch):
    seen = []

    class Proc:
        pid, returncode = 0, 0

        def __init__(self, args, **kw):
            seen.append(args)

        def communicate(self, timeout=None):
            return "", ""

    monkeypatch.setattr(tcampaign.subprocess, "Popen", Proc)
    run_campaign(SIM, CONFIG, tmp_path / "a", device="cuda:1")
    run_campaign(SIM, CONFIG, tmp_path / "b")
    assert [a[-3:] for a in seen[:2]] == [["run", "--device", "cuda:1"]] * 2
    assert [a[-1] for a in seen[2:]] == ["run", "run"]
    assert all(Path(a[1]) == Path(SIM).resolve() for a in seen)


def test_a_full_sample_matches_the_jax_package(tmp_path):
    """The slice end to end: plan row -> context -> child process ->
    ``World.run`` -> ``post_step`` -> ``result.json``, against the JAX
    package's in-process run of the same row."""
    config = {"monte_carlo": {"n_samples": 1, "seed": 4,
                              "variables": {k: {"dist": "uniform", "min": p.min, "max": p.max}
                                            for k, p in tlanding.PARAMS.items()}}}
    out = tmp_path / "out"
    record, = run_campaign(SIM, config, out, workers=1, timeout=600, device="cpu")
    assert record["valid"] and record["ticks"] == 2400, record
    with open(out / "plan.csv") as f:
        row, = csv.DictReader(f)
    params = {k.removeprefix("param."): float(v) for k, v in row.items()
              if k.startswith("param.")}
    assert sorted(params) == sorted(tlanding.PARAMS)

    jsim = jax_example("monte-carlo", "sim")
    with float_policy("f64"):
        world, system = jsim.build(params)
        ex = world.build(system, simulation_rate=jsim.SIMULATION_RATE_HZ)
        ex.record_history = False
        ex.run(jsim.DEFAULT_MAX_TICKS)
        td = float(np.asarray(ex.read_component("booster.touchdown_vz"))[0])
        pos = np.asarray(ex.read_component("booster.world_pos"))
    result = json.loads((out / "runs" / row["run_id"] / "result.json").read_text())
    ref = {"touchdown_vz": td, "landing_offset": float(np.linalg.norm(pos[4:6]))}
    for key, value in ref.items():
        assert abs(result[key] - value) <= LANDING_TOL * max(1.0, abs(value)), (key, result, ref)
        assert record[f"result.{key}"] == result[key]
    assert result["soft"] == bool(-5.0 < td < 0.0)
    assert td < 0.0  # it landed
