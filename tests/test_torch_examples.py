"""The port's rocket, three-body and landing Monte Carlo examples against
the JAX package's, on the CPU in f64.

Stated tolerances (max |Δ| / max |ref| per channel group, ``rel_errs``):

* ``lerp_nd`` on seeded coordinates inside and outside the grid, under
  ``vmap``; ``quat_from_euler``; ``quat_from_vecs`` on random pairs and on
  exactly anti-parallel ones; ``Quaternion`` normalize / inverse / rotate
  under ``vmap``: ≤ 1e-12 (the same algebra; libm and reductions may
  round the last bit differently).
* The aero table and the Butterworth weights: bitwise (the same numpy).
* Every example's ``build_world().snapshot()``: bitwise (names, dtypes,
  values), and a run started from the JAX snapshot through the port's
  numpy interop equals the port's own run bitwise.
* Rocket, the first 240 ticks of a 600-tick ``Exec`` run, every
  component: ≤ 1e-10 (the fin PID feeds the round-off of the table
  lookups back into the trajectory); an 8-sample ``BatchedCampaign``,
  240 ticks: ≤ 1e-10.
* Landing Monte Carlo, 32 samples × 2400 ticks, LHS seed 7: every
  sample's ``touchdown_vz`` and final state ≤ 1e-9, the landed and soft
  flags identical, and the JAX test's envelope.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

import elodin_tpu_torch as tel
from elodin_tpu import spatial as jspatial
from elodin_tpu.monte_carlo import BatchedCampaign as JCampaign
from elodin_tpu.ops import interp as jinterp
from elodin_tpu_torch import spatial as tspatial
from elodin_tpu_torch.examples.monte_carlo import batched as tmc
from elodin_tpu_torch.examples.monte_carlo import sim as tmc_sim
from elodin_tpu_torch.examples.rocket import batched as trk_batched
from elodin_tpu_torch.examples.rocket import main as trk
from elodin_tpu_torch.examples.three_body import main as ttb
from elodin_tpu_torch.execimpl import Exec
from elodin_tpu_torch.ops import interp as tinterp
from torch_port_util import float_policy, jax_example, rel_err, rel_errs

ROCKET_TICKS, ROCKET_LONG_TICKS = 240, 600
MC_SAMPLES, MC_TICKS, MC_SEED = 32, 2400, 7


def jrocket():
    return jax_example("rocket", "main")


def jthree_body():
    return jax_example("three-body", "main")


def jmc_sim():
    return jax_example("monte-carlo", "sim")


def jmc_batched():
    return jax_example("monte-carlo", "batched", modules={"sim": jmc_sim()})


@pytest.fixture(autouse=True)
def _f64():
    with float_policy("f64"):
        yield


def _port(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


def test_lerp_nd_inside_and_outside_the_grid_under_vmap():
    rng = np.random.default_rng(11)
    table = rng.standard_normal((3, 5, 4))
    # fractional indices from a unit below the grid to a unit above it
    coords = rng.uniform(-1.0, np.array(table.shape, dtype=float), (256, 3))
    coords[:4] = [[0.0, 0.0, 0.0], [2.0, 4.0, 3.0], [-3.0, 9.0, 1.5], [1.0, 2.0, 3.0]]
    ref = jax.vmap(lambda c: jinterp.lerp_nd(jnp.asarray(table), [c[0], c[1], c[2]]))(
        jnp.asarray(coords))
    ours = vmap(lambda c: tinterp.lerp_nd(_port(table), [c[0], c[1], c[2]]))(_port(coords))
    assert ours.shape == (256,) and rel_err(ours, ref) <= 1e-12
    one = tinterp.lerp_nd(_port(table), [0.3, 5.0, -2.0])
    assert abs(float(one) - float(jinterp.lerp_nd(jnp.asarray(table), [0.3, 5.0, -2.0]))) <= 1e-12
    np.testing.assert_array_equal(
        tinterp._hat_weights(torch.tensor(1.25, dtype=torch.float64), 4, torch.float64).numpy(),
        np.asarray(jinterp._hat_weights(jnp.float64(1.25), 4, jnp.float64)))


def test_quat_from_euler():
    angles = np.random.default_rng(3).uniform(-np.pi, np.pi, (64, 3))
    ours = tspatial.Quaternion.from_euler(_port(angles)).inner
    ref = jspatial.Quaternion.from_euler(jnp.asarray(angles)).inner
    assert rel_err(ours, ref) <= 1e-12


def test_quaternion_methods_under_vmap():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((64, 4)) * 2.0
    v = rng.standard_normal((64, 3))

    def ours_fn(qi, vi):
        qq = tel.Quaternion.from_array(qi).normalize()
        return torch.cat([qq.inverse() @ vi, qq @ vi])

    def ref_fn(qi, vi):
        qq = jspatial.Quaternion.from_array(qi).normalize()
        return jnp.concatenate([qq.inverse() @ vi, qq @ vi])

    ours = vmap(ours_fn)(_port(q), _port(v))
    ref = jax.vmap(ref_fn)(jnp.asarray(q), jnp.asarray(v))
    assert rel_err(ours, ref) <= 1e-12
    np.testing.assert_array_equal(tel.SpatialTransform.zero().inner.numpy(),
                                  np.asarray(jspatial.SpatialTransform.zero().inner))


def test_rocket_tables_are_the_jax_example_s():
    jr = jrocket()
    np.testing.assert_array_equal(trk.AERO_TABLE, np.asarray(jr.AERO_TABLE))
    np.testing.assert_array_equal(trk._BUTTER_LAST_W, jr._BUTTER_LAST_W)
    for name in ("THRUST_TIME", "THRUST_N"):
        np.testing.assert_array_equal(getattr(trk, name), np.asarray(getattr(jr, name)))


def test_quat_from_vecs_random_and_anti_parallel():
    jr = jrocket()
    rng = np.random.default_rng(9)
    v1, v2 = rng.standard_normal((64, 3)), rng.standard_normal((64, 3)) * 3.0
    # exactly anti-parallel pairs: the degenerate branch, along x and off it
    v1[:3] = [[-1.0, 0.0, 0.0], [0.0, 0.0, 2.0], [1.0, 2.0, -3.0]]
    v2[:3] = [[1.0, 0.0, 0.0], [0.0, 0.0, -3.0], [-2.0, -4.0, 6.0]]
    ours = vmap(lambda a, b: trk.quat_from_vecs(a, b).inner)(_port(v1), _port(v2))
    ref = jax.vmap(lambda a, b: jr.quat_from_vecs(a, b).inner)(jnp.asarray(v1),
                                                                jnp.asarray(v2))
    assert torch.isfinite(ours).all()
    assert rel_err(ours, ref) <= 1e-12
    # the anti-parallel fallback is a half turn
    np.testing.assert_allclose(ours[:3, 3].numpy(), 0.0, atol=1e-15)


# ---------------------------------------------------------------------------
# state carried across: snapshots and a run from the JAX snapshot
# ---------------------------------------------------------------------------


def _worlds():
    return {
        "three-body": (jthree_body().w, ttb.build_world(), ttb.build_system()),
        "rocket": (jrocket().build_world(), trk.build_world(), trk.build_system()),
        "monte-carlo": (jmc_sim().build(None)[0], tmc_sim.build(None)[0], tmc_sim.build(None)[1]),
    }


@pytest.mark.parametrize("example", ["three-body", "rocket", "monte-carlo"])
def test_snapshot_is_the_jax_example_s_and_runs_from_it(example):
    jw, tw, tsys = _worlds()[example]
    jmeta, jcols = jw.snapshot()
    tmeta, tcols = tw.snapshot()
    assert list(tcols) == list(jcols)
    assert tmeta.entity_names == jmeta.entity_names
    assert tmeta.comp_entities == jmeta.comp_entities
    for k, ref in jcols.items():
        ref = np.asarray(ref)
        assert tcols[k].dtype == ref.dtype, k
        np.testing.assert_array_equal(tcols[k], ref, err_msg=k)
    dt = 1.0 / 120.0
    from_jax = Exec(tmeta, {k: np.asarray(v) for k, v in jcols.items()}, tsys, dt,
                    device="cpu")
    own = Exec(tmeta, tcols, tsys, dt, device="cpu")
    from_jax.run(5)
    own.run(5)
    for k in tcols:
        np.testing.assert_array_equal(from_jax.column_array(k), own.column_array(k), err_msg=k)


# ---------------------------------------------------------------------------
# rocket
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rocket_runs():
    """(JAX Exec, port Exec), each run 600 ticks with its history."""
    with float_policy("f64"):
        jr = jrocket()
        ref = jr.build_world().build(jr.build_system(), simulation_rate=1.0 / jr.SIM_TIME_STEP)
        ref.run(ROCKET_LONG_TICKS)
        ours = trk.build_world().build(trk.build_system(),
                                       simulation_rate=1.0 / trk.SIM_TIME_STEP, device="cpu")
        ours.run(ROCKET_LONG_TICKS)
    return ref, ours


def test_rocket_240_ticks_every_component(rocket_runs):
    ref, ours = rocket_runs
    assert ours.tick() == ROCKET_LONG_TICKS
    names = ours.meta.components
    for k in names:
        o = ours._history.series(k)[ROCKET_TICKS]
        r = np.asarray(ref._history.series(k)[ROCKET_TICKS])
        if r.dtype.kind != "f":
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            assert rel_err(o, r) <= 1e-10, (k, rel_errs(o, r))


def test_rocket_ascends_under_thrust(rocket_runs):
    _, exec_ = rocket_runs
    df = exec_.history(["rocket.world_pos", "rocket.mach", "rocket.thrust"])
    z = df["rocket.world_pos"][-1].to_numpy()[6]
    assert z > 50.0, f"rocket failed to climb: z={z}"
    assert float(df["rocket.mach"][-1]) > 0.1
    assert float(df["rocket.thrust"][1]) > 100.0  # boost phase thrust
    fins = np.array([float(v) for v in exec_.history("rocket.fin_deflect")["rocket.fin_deflect"]])
    assert (np.abs(fins) <= 40.0).all()


def test_rocket_external_fin_trim():
    exec_ = trk.build_world().build(trk.build_system(),
                                    simulation_rate=1.0 / trk.SIM_TIME_STEP, device="cpu")
    exec_.run(10)
    exec_.write_component("rocket.fin_control_trim", 5.0)
    exec_.run(10)
    np.testing.assert_allclose(np.asarray(exec_.read_component("rocket.fin_control_trim")), 5.0)
    # the trim reached the aero model: Cl = 0.1 * trim
    np.testing.assert_allclose(exec_.read_component("rocket.aero_coefs")[0], 0.5)


def test_rocket_batched_campaign_8_samples():
    jr = jrocket()
    ref = JCampaign(jr.build_world(), jr.build_system(), 8, {},
                    simulation_rate=1.0 / jr.SIM_TIME_STEP).run(ROCKET_TICKS)
    campaign = trk_batched.make_campaign(8, device="cpu")
    ours = campaign.run(ROCKET_TICKS)
    assert ours.ticks == ROCKET_TICKS
    for k, r in ref.final.items():
        r, o = np.asarray(r), ours.column(k)
        if r.dtype.kind != "f":
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            assert rel_err(o, r) <= 1e-10, (k, rel_errs(o, r))
    pos = ours.component("rocket.world_pos")
    np.testing.assert_array_equal(pos, np.broadcast_to(pos[:1], pos.shape))


# ---------------------------------------------------------------------------
# the landing Monte Carlo
# ---------------------------------------------------------------------------


def test_landing_campaign_32_samples_2400_ticks(monkeypatch):
    jb = jmc_batched()
    results = []

    class Recorded(JCampaign):
        def run(self, *args, **kwargs):
            results.append(super().run(*args, **kwargs))
            return results[-1]

    monkeypatch.setattr(jb, "BatchedCampaign", Recorded)
    ref_out = jb.run_campaign(MC_SAMPLES, MC_TICKS, seed=MC_SEED)
    ref = results[0]
    campaign, draws = tmc.make_campaign(MC_SAMPLES, MC_SEED, device="cpu")
    result = campaign.run(MC_TICKS)
    out = tmc.outcome(result)

    ours_s, ref_td = tmc.scores(result), ref.component("booster.touchdown_vz")
    np.testing.assert_array_equal(ours_s["landed"], ref_td < 0.0)
    np.testing.assert_array_equal(ours_s["soft"], (ref_td < 0.0) & (ref_td > -5.0))
    assert rel_err(ours_s["touchdown_vz"], ref_td) <= 1e-9
    for k, r in ref.final.items():
        r, o = np.asarray(r), result.column(k)
        if r.dtype.kind != "f":
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            assert rel_err(o, r) <= 1e-9, (k, rel_errs(o, r))
    for k in ("n_samples", "ticks", "landed_frac", "soft_landing_frac"):
        assert out[k] == ref_out[k], k
    for k in ("mean_touchdown_vz", "mean_landing_offset_m"):
        assert abs(out[k] - ref_out[k]) <= 1e-9 * abs(ref_out[k]), k
    # the JAX test's envelope (tests/test_examples.py)
    assert out["landed_frac"] > 0.9
    assert out["soft_landing_frac"] > 0.8
    assert -6.0 < out["mean_touchdown_vz"] < 0.0
