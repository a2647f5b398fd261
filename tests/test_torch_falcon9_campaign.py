"""The port's falcon9 campaign against the JAX package's.

A module-scoped JAX campaign flies 4 dispersed samples through the whole
580 s mission (58000 ticks, every column recorded every 500 ticks); the
port starts from its recorded states (``BatchedCampaign.from_columns``).

* One tick of each falcon9 system, and of the whole pipe, from the first
  recorded state of every phase 0-7: ≤ 1e-12 per channel group (the same
  arithmetic in IEEE f64; reductions and transcendentals may round
  differently in the last bit).
* 300 ticks of the campaign from ``build()``: ≤ 1e-10 per channel group.

Both compare with ``batched.state_errors``, which holds the channels that
can carry only round-off (the attitude loop's before the pitch kick, an
actuator decaying through the subnormal range after touchdown, which
XLA's CPU backend flushes to zero) against their physical scale
(``SCALE_FLOORS``).
* From the recorded state 5-10 s before the first touchdown, both packages
  run until a sample latches DOWN: phase and landed agree exactly, the
  touchdown scores to ≤ 1e-6 relative.  Guidance branches on thresholds,
  so a long run is compared only on what it scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from elodin_tpu.monte_carlo import BatchedCampaign as JCampaign
from elodin_tpu.system import SystemBuilder as JBuilder
from elodin_tpu.system import as_system as j_as_system
from elodin_tpu_torch.examples.falcon9 import batched as tbatched
from elodin_tpu_torch.examples.falcon9 import sim as tsim
from elodin_tpu_torch.interop import columns_from_numpy, columns_to_numpy
from elodin_tpu_torch.monte_carlo import BatchedCampaign as TCampaign
from elodin_tpu_torch.system import SystemBuilder as TBuilder
from torch_port_util import float_policy, jax_falcon9

N_SAMPLES, SEED = 4, 0
SYSTEMS = ["guidance", "engine_dynamics", "tank_dynamics", "mass_props", "airdata",
           "attitude_control", "actuators", "effectors", "contact"]
SCORES = ("touchdown_vz", "touchdown_vlat", "miss_distance")

jsim = jax_falcon9("sim")


@pytest.fixture(autouse=True)
def _f64():
    with float_policy("f64"):
        yield


def _jax_campaign(cols=None):
    draws = tbatched.dispersions(N_SAMPLES, SEED)
    w, s = jsim.build(None, sensors=False)
    c = JCampaign(w, s, N_SAMPLES, tbatched.overrides_of(draws), simulation_rate=jsim.SIM_RATE_HZ)
    if cols is not None:
        c.cols = {k: jnp.asarray(v) for k, v in cols.items()}
    return c


def _port_campaign(cols):
    w, s = tsim.build(sensors=False)
    return TCampaign.from_columns(w, s, cols, simulation_rate=tsim.SIM_RATE_HZ, device="cpu")


@pytest.fixture(scope="module")
def mission():
    """The JAX mission: {column: (n_emits, n_samples, n_entities, ...)}."""
    with float_policy("f64"):
        r = _jax_campaign().run(tsim.DEFAULT_MAX_TICKS, history_every=500)
    return r.history


def _state(mission, emit, sample=None):
    """The recorded columns at one emit: every sample's, or one sample's
    (then without the sample axis)."""
    return {k: (v[emit] if sample is None else v[emit, sample]) for k, v in mission.items()}


def _first_of_phase(mission, phase):
    emits, samples = np.nonzero(mission["phase"][:, :, 0] == phase)
    return int(emits[0]), int(samples[0])


@pytest.fixture(scope="module")
def jax_steps():
    """Each falcon9 system, and the whole pipe, as a jitted JAX function of
    one sample's columns (compiled once for the module)."""
    meta = _jax_campaign().meta
    systems = {n: j_as_system(getattr(jsim, n)) for n in SYSTEMS}
    systems["pipe"] = j_as_system(jsim.build(None, sensors=False)[1])

    def make(sys_):
        def step(cols):
            b = JBuilder(meta, dict(cols))
            sys_.call(b)
            return b.cols
        return jax.jit(step)

    return {n: make(s) for n, s in systems.items()}


def test_mission_visits_every_phase_and_lands(mission):
    seen = set(np.unique(mission["phase"]).tolist())
    assert seen == set(range(8))
    assert (mission["miss_distance"][-1, :, 0] >= 0.0).all()


@pytest.mark.parametrize("name", SYSTEMS + ["pipe"])
@pytest.mark.parametrize("phase", range(8))
def test_one_tick_from_every_phase(mission, jax_steps, phase, name):
    emit, sample = _first_of_phase(mission, phase)
    state = _state(mission, emit, sample)
    ref = jax_steps[name]({k: jnp.asarray(v) for k, v in state.items()})
    w, pipe = tsim.build(sensors=False)
    w.set_sim_time_step(tsim.SIM_TIME_STEP)
    meta, _ = w.snapshot()
    b = TBuilder(meta, columns_from_numpy(state, meta, "cpu"))
    (pipe if name == "pipe" else getattr(tsim, name)).call(b)
    ours = columns_to_numpy(b.cols, meta)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    for k, r in ref.items():
        if r.dtype.kind != "f":
            np.testing.assert_array_equal(ours[k], r)
    errs = tbatched.state_errors(ours, ref)
    assert max(errs.values()) <= 1e-12, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def test_300_ticks_from_build():
    jc = _jax_campaign()
    tc, _ = tbatched.make_campaign(N_SAMPLES, SEED, device="cpu")
    start = columns_to_numpy(tc.cols, tc.meta)
    for k, v in jc.cols.items():
        np.testing.assert_array_equal(start[k], np.asarray(v))
    ref = jc.run(300)
    ours = tc.run(300)
    assert ours.ticks == ref.ticks == 300 and tc.gated_runs == 60
    final = {k: ours.column(k) for k in ref.final}
    for k in ("tick", "phase", "lifted"):
        np.testing.assert_array_equal(final[k], np.asarray(ref.final[k]))
    assert (final["lifted"] == 1.0).all()
    errs = tbatched.state_errors(final, {k: np.asarray(v) for k, v in ref.final.items()})
    assert max(errs.values()) <= 1e-10, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def test_touchdown_from_the_recorded_descent(mission):
    """Start 5-10 s before the first touchdown (the emit 1000 ticks before
    the first DOWN emit) and run both packages 50 ticks at a time until the
    JAX package latches a sample DOWN."""
    down_emits = np.nonzero((mission["phase"][:, :, 0] == tsim.DOWN).any(axis=1))[0]
    start = int(down_emits[0]) - 2
    cols = _state(mission, start)
    assert not (cols["phase"] == tsim.DOWN).any()
    jc, tc = _jax_campaign(cols), _port_campaign(cols)
    for _ in range(40):
        ref, ours = jc.run(50), tc.run(50)
        if (np.asarray(ref.final["phase"]) == tsim.DOWN).any():
            break
    else:
        pytest.fail("no sample landed within 2000 ticks")
    phase = ours.component("booster.phase")
    np.testing.assert_array_equal(phase, np.asarray(ref.final["phase"])[:, 0])
    landed = ours.component("booster.miss_distance") >= 0.0
    np.testing.assert_array_equal(landed, np.asarray(ref.final["miss_distance"])[:, 0] >= 0.0)
    assert landed.any() and (phase[landed] == tsim.DOWN).all()
    for score in SCORES:
        r = np.asarray(ref.final[score])[:, 0]
        o = ours.component(f"booster.{score}")
        np.testing.assert_array_equal(o[~landed], r[~landed])
        np.testing.assert_allclose(o[landed], r[landed], rtol=1e-6, atol=0.0)
