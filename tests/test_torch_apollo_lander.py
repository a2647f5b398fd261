"""apollo-lander on the port against the JAX package's
(``elodin_tpu_torch/examples/apollo_lander/main.py`` against
``examples/apollo-lander/main.py``), on the CPU in f64:

* the guided descent: ``build_world()``'s snapshot bit for bit, then 1500
  of its 9000 ticks in both packages, every float column within max |Δ| /
  max |ref| ≤ 1e-10;
* the dispersed campaign at 16 samples of the full 9000 ticks, from the
  same draws: each sample's touchdown speeds, fuel and final state within
  1e-9, the landed and soft flags identical, and the JAX test's gates
  (``tests/test_examples.py:311-316``) on those samples.
"""

import numpy as np
import pytest

from test_torch_core_examples import _run_both
from torch_port_util import float_policy, jax_example, rel_err


def test_apollo_descent_matches_jax():
    """1500 of the 9000 ticks (the approach and the ZEM/ZEV burn down to
    ~400 m) in both packages."""
    from elodin_tpu_torch.examples.apollo_lander import main as sim

    jsim = jax_example("apollo-lander", "main")
    _run_both(sim.build_world(), sim.build_system(), jsim.build_world(),
              jsim.build_system(), sim.SIM_RATE, 1500)


@pytest.fixture(scope="module")
def dispersed():
    """16 dispersed descents of the full 9000 ticks in both packages, from
    the same draws."""
    from elodin_tpu.monte_carlo import BatchedCampaign as JCampaign

    from elodin_tpu_torch.examples.apollo_lander import main as sim

    jsim = jax_example("apollo-lander", "main")
    n, seed, ticks = 16, 5, int(180 * sim.SIM_RATE)
    with float_policy("f64"):
        ours = sim.make_campaign(n, seed, device="cpu").run(ticks)
        ref = JCampaign(jsim.build_world(), jsim.build_system(), n,
                        overrides=sim.dispersions(n, seed),
                        simulation_rate=jsim.SIM_RATE).run(ticks)
    return sim, ours, ref


def test_apollo_dispersed_campaign_matches_jax(dispersed):
    sim, ours, ref = dispersed
    s, r = sim.scores(ours), sim.scores(ref)
    for key in ("landed", "soft"):
        np.testing.assert_array_equal(s[key], r[key], err_msg=key)
    for key in ("landed_vz", "landed_vlat", "fuel", "final"):
        assert rel_err(s[key], r[key]) <= 1e-9, key
    for name in ("eagle.world_pos", "eagle.world_vel", "eagle.inertia"):
        assert rel_err(ours.component(name), ref.component(name)) <= 1e-9, name
    # tests/test_examples.py:311-316's gates, on these 16 samples
    assert s["landed"].mean() > 0.95
    assert s["soft"].mean() > 0.7
    assert s["fuel"].min() > 1000.0


def test_apollo_dispersed_draws_are_jax_s():
    """``dispersions`` draws what the JAX example's ``run_dispersed`` draws:
    the same numpy generator and order."""
    from elodin_tpu_torch.examples.apollo_lander import main as sim

    rng = np.random.default_rng(0)
    offsets = rng.uniform([-700, -300], [-200, 300], (8, 2))
    alts = rng.uniform(1700, 2300, 8)
    vels = rng.uniform([40, -25, -45], [80, -5, -25], (8, 3))
    d = sim.dispersions(8, 0)
    np.testing.assert_array_equal(d["eagle.world_pos"][:, 4:6], offsets)
    np.testing.assert_array_equal(d["eagle.world_pos"][:, 6], alts)
    np.testing.assert_array_equal(d["eagle.world_vel"][:, 3:], vels)
    np.testing.assert_array_equal(d["eagle.world_pos"][:, :4], np.tile([0, 0, 0, 1.0], (8, 1)))
