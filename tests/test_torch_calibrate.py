"""The port's ``monte_carlo.calibrate`` against the JAX package's, on the
same run directories and specs (both are numpy, so the results are held
equal): ``load_runs``' ranks (invalid, unscored and non-finite runs
dropped), ``narrow_spec``'s narrowed variables, ``narrow_variables``'
clamp, ``main``'s ``best-json`` and ``rank`` output, and ``Calibrator``'s
rounds on a quadratic bowl, seed for seed.  The batched-rollout case
calibrates a ball's launch speed against a target apex with the port's
``BatchedCampaign`` on the CPU."""

import csv
import json
import tomllib

import numpy as np
import pytest
import torch

import elodin_tpu_torch as el
from elodin_tpu.monte_carlo import calibrate as jcal
from elodin_tpu_torch.monte_carlo import calibrate as tcal
from elodin_tpu_torch.monte_carlo.batched import BatchedCampaign
from torch_port_util import float_policy


def _fake_campaign(out_dir, rows):
    fieldnames = sorted({k for r in rows for k in r})
    with open(out_dir / "results.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(rows)


RUN_SETS = {
    "invalid and unscored": [
        {"run_id": "r0", "param.k": 1.0, "result.fit": 5.0, "valid": "True"},
        {"run_id": "r1", "param.k": 2.0, "result.fit": 1.0, "valid": "True"},
        {"run_id": "r2", "param.k": 3.0, "result.fit": 0.1, "valid": "False"},
        {"run_id": "r3", "param.k": 4.0, "result.fit": "", "valid": "True"},
    ],
    "non-finite": [
        {"run_id": "r0", "param.k": 1.0, "result.fit": "nan", "valid": "True"},
        {"run_id": "r1", "param.k": 2.0, "result.fit": 3.0, "valid": "True"},
        {"run_id": "r2", "param.k": 3.0, "result.fit": "inf", "valid": "True"},
        {"run_id": "r3", "param.k": 4.0, "result.fit": 1.0, "valid": "True"},
    ],
}
RANKS = {"invalid and unscored": ["r1", "r0"], "non-finite": ["r3", "r1"]}


@pytest.mark.parametrize("case", sorted(RUN_SETS))
def test_load_runs_ranks_as_the_jax_package(case, tmp_path):
    _fake_campaign(tmp_path, RUN_SETS[case])
    ours, ref = tcal.load_runs(tmp_path, "fit"), jcal.load_runs(tmp_path, "fit")
    assert ours == ref
    assert [r[0] for r in ours] == RANKS[case]


def test_rank_runs_prints_as_the_jax_package(tmp_path, capsys):
    _fake_campaign(tmp_path, RUN_SETS["invalid and unscored"])
    assert tcal.rank_runs(tmp_path, "fit") == jcal.rank_runs(tmp_path, "fit")
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and "best-run params" in out


def test_narrow_spec_round_trip(tmp_path):
    spec = tmp_path / "spec.toml"
    spec.write_text(
        "[monte_carlo]\nn_samples = 8\nseed = 7\nmethod = \"lhs\"\n\n"
        "[monte_carlo.variables]\n"
        "k = { dist = \"uniform\", min = 0.0, max = 10.0 }\n"
        "b = { dist = \"uniform\", min = -1.0, max = 1.0 }\n"
    )
    _fake_campaign(tmp_path, [
        {"run_id": "r0", "param.k": 9.5, "param.b": 0.0, "result.fit": 1.0, "valid": "True"},
        {"run_id": "r1", "param.k": 1.5, "param.b": 0.7, "result.fit": 2.0, "valid": "True"},
    ])
    tcal.narrow_spec(tmp_path, spec, tmp_path / "ours.toml", "fit")
    jcal.narrow_spec(tmp_path, spec, tmp_path / "ref.toml", "fit")
    ours, ref = (tomllib.loads((tmp_path / n).read_text()) for n in ("ours.toml", "ref.toml"))
    assert ours == ref
    v = ours["monte_carlo"]["variables"]
    # 40% of [0,10] centered at 9.5, clamped: [7.5, 10.0]
    assert abs(v["k"]["min"] - 7.5) < 1e-12 and abs(v["k"]["max"] - 10.0) < 1e-12
    # 40% of [-1,1] centered at 0: [-0.4, 0.4]
    assert abs(v["b"]["min"] + 0.4) < 1e-12 and abs(v["b"]["max"] - 0.4) < 1e-12
    assert ours["monte_carlo"]["n_samples"] == 8 and ours["monte_carlo"]["seed"] == 7


@pytest.mark.parametrize("best,keep", [({"k": 0.0}, 0.5), ({"k": 0.9}, 0.4), ({}, 0.25)])
def test_narrow_variables_as_the_jax_package(best, keep):
    variables = {"k": {"min": 0.0, "max": 1.0}}
    assert tcal.narrow_variables(variables, best, keep) == jcal.narrow_variables(
        variables, best, keep)
    v = tcal.narrow_variables({"k": {"min": 0.0, "max": 1.0}}, {"k": 0.0}, 0.5)
    assert v["k"]["min"] == 0.0 and abs(v["k"]["max"] - 0.25) < 1e-12


def test_cli_best_json(tmp_path, capsys):
    _fake_campaign(tmp_path, [
        {"run_id": "r0", "param.k": 2.5, "result.fit": 0.5, "valid": "True"},
        {"run_id": "r1", "param.k": 7.5, "result.fit": 0.9, "valid": "True"},
    ])
    tcal.main(["best-json", str(tmp_path), "fit"])
    ours = capsys.readouterr().out
    jcal.main(["best-json", str(tmp_path), "fit"])
    assert ours == capsys.readouterr().out
    assert json.loads(ours) == {"k": 2.5}
    with pytest.raises(SystemExit):
        tcal.main([])


def _bowl(draws):
    target = {"a": 3.3, "b": 14.2}
    return (draws["a"] - target["a"]) ** 2 + (draws["b"] - target["b"]) ** 2


def test_calibrator_converges_on_quadratic_as_the_jax_package():
    variables = {"a": {"min": -10.0, "max": 10.0}, "b": {"min": 0.0, "max": 20.0}}
    ours = tcal.Calibrator(variables, keep_fraction=0.4, seed=11).run(_bowl, rounds=4, n_samples=48)
    ref = jcal.Calibrator(variables, keep_fraction=0.4, seed=11).run(_bowl, rounds=4, n_samples=48)
    assert ours.best_params == ref.best_params and ours.best_score == ref.best_score
    for o, r in zip(ours.rounds, ref.rounds, strict=True):
        assert o.variables == r.variables and o.best_params == r.best_params
        np.testing.assert_array_equal(o.scores, r.scores)
    assert abs(ours.best_params["a"] - 3.3) < 0.25 and abs(ours.best_params["b"] - 14.2) < 0.25
    scores = [r.best_score for r in ours.rounds]
    assert all(b <= a + 1e-12 for a, b in zip(scores, scores[1:])), scores
    with pytest.raises(ValueError, match="min/max"):
        tcal.Calibrator({"a": {"max": 1.0}})
    with pytest.raises(ValueError, match="shape"):
        tcal.Calibrator(variables).run(lambda d: np.zeros(3), rounds=1, n_samples=4)


@el.map
def _gravity(inertia: el.Inertia, f: el.Force) -> el.Force:
    g = torch.tensor([0.0, 0.0, -9.81], dtype=f.force().dtype, device=f.force().device)
    return f + el.SpatialForce(linear=g * inertia.mass())


def test_calibrator_batched_campaign_rollout():
    """A ball's launch speed against a target apex, each round one
    BatchedCampaign of every draw on the CPU."""
    target_apex = 4.2  # m; v* = sqrt(2 g h) ~ 9.078 m/s

    def rollout(draws):
        v0 = draws["v0"]
        n = len(v0)
        w = el.World()
        w.spawn(el.Body(inertia=el.SpatialInertia(1.0)), name="ball")
        vel = np.zeros((n, 6))
        vel[:, 5] = v0
        camp = BatchedCampaign(w, el.six_dof(1.0 / 120.0, _gravity), n,
                               overrides={"ball.world_vel": vel}, device="cpu")
        res = camp.run(ticks=240, history_every=10)
        z = res.trajectory("ball.world_pos")[..., 6]  # (emits, n)
        return np.abs(z.max(axis=0) - target_apex)

    with float_policy("f64"):
        res = tcal.Calibrator({"v0": {"min": 1.0, "max": 20.0}}, seed=5).run(
            rollout, rounds=3, n_samples=16)
    v_star = float(np.sqrt(2 * 9.81 * target_apex))
    assert abs(res.best_params["v0"] - v_star) < 0.5, (res.best_params, v_star)
    assert res.best_score < 0.2
