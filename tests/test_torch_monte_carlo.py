"""The port's batched Monte Carlo (``elodin_tpu_torch.monte_carlo``)
against the JAX package's: plan sampling, artifacts, history emits,
segment bounds, ``until=`` early stop, and a campaign started from another
package's columns.

The JAX package caches one compiled program per (ticks, ``until``) and
keys it on the predicate's code and closure (``tests/test_monte_carlo.py``,
fresh lambdas); the port compiles nothing, so that cache has no
counterpart here.

Stated tolerances: plans and the latching counter are equal bit for bit;
the batched 6-dof rollouts (RK4, f64) agree to ≤ 1e-12 relative per
channel group, the tolerance of ``tests/test_torch_sixdof.py``.
"""

import json
import typing as ty
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elodin_tpu as jel
import elodin_tpu_torch as tel
from elodin_tpu.models import build_batched_sixdof as j_build
from elodin_tpu.monte_carlo import BatchedCampaign as JCampaign
from elodin_tpu.monte_carlo.batched import BatchedResult as JResult
from elodin_tpu.monte_carlo import sample_plan as j_sample_plan
from elodin_tpu.monte_carlo import write_artifacts as j_write_artifacts
from elodin_tpu_torch.models import build_batched_sixdof as t_build
from elodin_tpu_torch.monte_carlo import BatchedCampaign as TCampaign
from elodin_tpu_torch.monte_carlo import BatchedResult as TResult
from elodin_tpu_torch.monte_carlo import sample_plan as t_sample_plan
from elodin_tpu_torch.monte_carlo import write_artifacts as t_write_artifacts
from torch_port_util import float_policy, rel_err

VARIABLES = {
    "a": {"dist": "uniform", "min": -2.0, "max": 3.0},
    "b": {"dist": "normal", "mean": 1.0, "std": 0.5},
    "c": {"dist": "loguniform", "min": 1e-3, "max": 10.0},
    "d": {"dist": "choice", "values": [3, 5, 7]},
    "e": {"dist": "fixed", "value": 2.5},
}


@pytest.mark.parametrize("method", ["lhs", "random"])
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_plan_equals_jax_bit_for_bit(method, seed):
    ours = t_sample_plan(VARIABLES, 257, method=method, seed=seed)
    ref = j_sample_plan(VARIABLES, 257, method=method, seed=seed)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


def test_write_artifacts_match_jax(tmp_path):
    """The same result, draws and scores write the same artifact set."""
    rng = np.random.default_rng(5)
    n = 6
    hist = {"world_pos": rng.normal(size=(3, n, 2, 7))}
    times = np.array([0.1, 0.2, 0.3])
    draws = {"thrust_eff": rng.uniform(0.9, 1.1, n)}
    scores = {"miss": rng.uniform(0, 30, n), "valid": rng.uniform(size=n) > 0.3}
    out = {}
    for name, res_cls, write, build in (("jax", JResult, j_write_artifacts, j_build),
                                        ("torch", TResult, t_write_artifacts, t_build)):
        meta = build(2)[0].snapshot()[0]
        result = res_cls(meta, {}, n, 2.5, 30, history=hist, history_times=times)
        d = tmp_path / name
        summary = write(result, d, draws=draws, scores=scores,
                        quality={"min_rollouts_per_sec": 1.0})
        out[name] = (summary, {f: (d / f).read_text() for f in
                               ("plan.csv", "results.csv", "perf.csv", "summary.json")},
                     dict(np.load(d / "trajectories.npz")))
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    for k, v in out["jax"][2].items():
        np.testing.assert_array_equal(out["torch"][2][k], v)
    with pytest.raises(RuntimeError, match="degraded"):
        t_write_artifacts(TResult(t_build(2)[0].snapshot()[0], {}, n, 2.5, 30), tmp_path / "d",
                          quality={"min_rollouts_per_sec": 100.0, "fail_on_degraded": True})


def test_falcon9_history_and_artifacts(tmp_path):
    """The port's falcon9 campaign writes the artifact set, with the last
    history emit bitwise equal to the final state."""
    from elodin_tpu_torch.examples.falcon9 import batched

    campaign, draws = batched.make_campaign(4, seed=3, device="cpu")
    result = campaign.run(500, history_every=100,
                          history_components=batched.HISTORY_COMPONENTS,
                          until=batched.until_down)
    assert result.ticks == 500
    for k in ("world_pos", "world_vel", "phase", "prop_kg"):
        np.testing.assert_array_equal(result.history[k][-1], result.column(k))
    summary = tel.monte_carlo.write_artifacts(
        result, tmp_path, draws=draws, scores={"valid": np.ones(4, dtype=bool)})
    for name in ("plan.csv", "results.csv", "perf.csv", "summary.json", "trajectories.npz"):
        assert (tmp_path / name).exists(), name
    assert json.loads((tmp_path / "summary.json").read_text()) == summary
    assert summary["total"] == 4 and summary["mode"] == "batched"
    assert summary["history_components"] == ["phase", "prop_kg", "world_pos", "world_vel"]
    npz = np.load(tmp_path / "trajectories.npz")
    pos = npz["world_pos"]  # (n_emits, n_samples, n_entities, 7)
    assert pos.shape == (5, 4, 1, 7) and np.isfinite(pos).all()
    np.testing.assert_allclose(npz["times"], [1.0, 2.0, 3.0, 4.0, 5.0], rtol=1e-12)
    # every sample has lifted off and the dispersions show in position
    assert (result.component("booster.lifted") == 1.0).all()
    assert np.abs(pos[-1, :, 0, 4:] - pos[-1, :1, 0, 4:]).max() > 0.01
    rows = (tmp_path / "plan.csv").read_text().splitlines()
    assert len(rows) == 5 and "param.thrust_eff" in rows[0]


def _sixdof_runs(seg, monkeypatch, ticks=70, every=10):
    """The batched 6-dof model, 3 bodies x 4 samples, in both packages with
    the same segment bound; the port starts from the JAX campaign's own
    initial columns."""
    monkeypatch.setenv("ELODIN_MC_SEGMENT_TICKS", str(seg))
    with float_policy("f64"):
        jc = JCampaign(*j_build(3), n_samples=4)
        tw, ts = t_build(3)
        tc = TCampaign.from_columns(tw, ts, {k: np.asarray(v) for k, v in jc.cols.items()},
                                    device="cpu")
        j = jc.run(ticks=ticks, history_every=every, history_components=["world_pos"])
        t = tc.run(ticks=ticks, history_every=every, history_components=["world_pos"])
    return j, t


def test_history_path_honors_segment_ticks(monkeypatch):
    """Segmented and one-segment runs record the same history and final
    state, in the port and against the JAX package."""
    ja, ta = _sixdof_runs(25, monkeypatch)  # 2 emits per segment: 20/20/20 + 10 ticks
    jb, tb = _sixdof_runs(100_000, monkeypatch)
    assert ta.history["world_pos"].shape == tb.history["world_pos"].shape == (7, 4, 3, 7)
    np.testing.assert_array_equal(ta.history["world_pos"], tb.history["world_pos"])
    np.testing.assert_array_equal(ta.column("world_pos"), tb.column("world_pos"))
    np.testing.assert_allclose(ta.history_times, tb.history_times)
    np.testing.assert_allclose(ta.history_times, ja.history_times, rtol=1e-15)
    assert ta.ticks == ja.ticks == 70
    assert rel_err(ta.history["world_pos"], ja.history["world_pos"]) <= 1e-12
    assert rel_err(ta.column("world_pos"), np.asarray(ja.final["world_pos"])) <= 1e-12
    assert rel_err(ta.column("world_vel"), np.asarray(ja.final["world_vel"])) <= 1e-12


def test_history_every_exceeding_ticks_rejected():
    world, system = t_build(2)
    c = TCampaign(world, system, n_samples=2, device="cpu")
    with pytest.raises(ValueError, match="history_every"):
        c.run(ticks=5, history_every=10)


def _counter_campaign(el, arr):
    Count = ty.Annotated[arr, el.Component("count", el.ComponentType.F64)]

    @dataclass
    class A(el.Archetype):
        count: Count = field(default_factory=lambda: np.float64(0.0))

    if el is jel:
        def inc(c: Count) -> Count:
            return jnp.minimum(c + 1.0, 5.0)
    else:
        def inc(c: Count) -> Count:
            return torch.clamp(c + 1.0, max=5.0)

    def mk():
        w = el.World()
        w.spawn(A(), name="e")
        if el is jel:
            return JCampaign(w, el.map(inc), 4, {"e.count": np.zeros(4)}, simulation_rate=10.0)
        return TCampaign(w, el.map(inc), 4, {"e.count": np.zeros(4)}, simulation_rate=10.0,
                         device="cpu")

    return mk


@pytest.mark.parametrize("history", [False, True])
def test_until_early_stop_matches_jax(monkeypatch, history):
    """Once every sample satisfies ``until`` at a segment boundary the rest
    is skipped; the sim latches, so the result equals the full run, and
    ``result.ticks`` counts as the JAX package counts."""
    monkeypatch.setenv("ELODIN_MC_SEGMENT_TICKS", "3")
    out = {}
    with float_policy("f64"):
        for name, (el, arr) in {"jax": (jel, jax.Array), "torch": (tel, torch.Tensor)}.items():
            mk = _counter_campaign(el, arr)
            kw = dict(history_every=2, history_components=["e.count"]) if history else {}
            r = mk().run(20, until=lambda cols: cols["count"] >= 5.0, **kw)
            full = mk().run(20)
            out[name] = (r.ticks, r.component("e.count"), full.ticks, full.component("e.count"),
                         None if not history else (r.history["count"], r.history_times))
    ticks, count, full_ticks, full_count, hist = out["torch"]
    assert ticks == out["jax"][0] == 6  # latched at tick 5; first all-done boundary at 6
    assert full_ticks == out["jax"][2] == 20
    np.testing.assert_array_equal(count, np.full(4, 5.0))
    np.testing.assert_array_equal(count, full_count)
    np.testing.assert_array_equal(count, out["jax"][1])
    if history:
        np.testing.assert_array_equal(hist[0], out["jax"][4][0])
        np.testing.assert_allclose(hist[1], [0.2, 0.4, 0.6])


def test_until_is_read_per_segment_only(monkeypatch):
    """Without a segment boundary after the latch, the whole run goes on."""
    monkeypatch.setenv("ELODIN_MC_SEGMENT_TICKS", "20000")
    with float_policy("f64"):
        r = _counter_campaign(tel, torch.Tensor)().run(20, until=lambda c: c["count"] >= 5.0)
    assert r.ticks == 20


def test_from_columns_checks_the_columns():
    world, system = t_build(2)
    _, cols = world.snapshot()
    batched = {k: np.broadcast_to(v, (3,) + v.shape).copy() for k, v in cols.items()}
    c = TCampaign.from_columns(world, system, batched, device="cpu")
    assert c.n == 3 and c.tick == 0
    bad = dict(batched, world_pos=batched["world_pos"][:2])
    with pytest.raises(ValueError, match="sample count"):
        TCampaign.from_columns(world, system, bad, device="cpu")
    bad = dict(batched, world_pos=batched["world_pos"].astype(np.float32))
    with pytest.raises(ValueError, match="dtype"):
        TCampaign.from_columns(world, system, bad, device="cpu")
    missing = {k: v for k, v in batched.items() if k != "force"}
    with pytest.raises(ValueError, match="missing"):
        TCampaign.from_columns(world, system, missing, device="cpu")


def test_campaign_result_accessors():
    world, system = t_build(2)
    c = TCampaign(world, system, 3, {"world_pos": np.zeros((3, 2, 7)) + [0, 0, 0, 1, 7e6, 0, 0]},
                  device="cpu")
    r = c.run(4)
    assert r.ticks == 4 and r.n_samples == 3
    assert r.column("tick").dtype == np.uint64 and (r.column("tick") == 4).all()
    assert r.rollouts_per_second > 0 and r.entity_steps_per_second > 0
    with pytest.raises(ValueError, match="no trajectories"):
        r.trajectory("Globals.tick")
    r2 = c.run(4, history_every=2, history_components=["tick"])
    np.testing.assert_array_equal(r2.history["tick"][:, :, 0], [[6, 6, 6], [8, 8, 8]])
    with pytest.raises(KeyError):
        r2.trajectory("Globals.simulation_time_step")
