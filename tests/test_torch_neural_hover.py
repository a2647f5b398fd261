"""The port's neural-hover example (``examples.neural_hover``: a policy
network whose weights are world components, trained through
``el.rollout`` under ``torch.func.vmap``) against the JAX package's, on
the CPU in f64.

Stated tolerances:

* at full width (32 hidden, 9 in, 3 out) cut to 2 starts x 24 ticks: the
  loss and each weight's gradient from JAX's initial weights (carried
  across by ``params_from_numpy``), rtol 1e-10 (atol 1e-14 for a
  gradient entry near 0); 3 Adam steps of the port's ``train`` against
  the JAX example's (optax), each from its own threefry initialisation,
  rtol 1e-10.
* the threefry initialisation: each weight within 4 ulps of sqrt(2) times
  scipy's erfinv of its uniform (scaled), and within 4 ulps plus JAX's own
  ``erf_inv`` error of JAX's draw (``tests/test_torch_threefry.py``'s
  rule; ``ROADMAP.md`` §3); the biases bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.special
import torch

from elodin_tpu_torch.examples.neural_hover import main as th
from elodin_tpu_torch.ops import threefry
from torch_port_util import jax_example

jax.config.update("jax_enable_x64", True)


def jh():
    return jax_example("neural-hover", "main")


HOVER_BATCH, HOVER_TICKS = 2, 24


def _jax_hover_init(seed=0):
    """The JAX example's initial weights (``train``'s)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {
        "w1": jax.random.normal(k1, (th.HID, th.N_IN)) * 0.3,
        "b1": jnp.zeros(th.HID),
        "w2": jax.random.normal(k2, (th.N_OUT, th.HID)) * 0.1,
        "b2": jnp.array([0.0, 0.0, jnp.arctanh(2.0 / 4.0 - 1.0)]),
    }


def _jax_hover_loss(ticks, batch, seed=0):
    """The JAX example's ``train`` loss, over ``ticks`` ticks and ``batch``
    starts."""
    import elodin as jel
    from elodin_tpu.diff import entity_row

    m = jh()
    roll = jel.rollout(m.build_world(), m.build_system(), ticks,
                       outputs=("world_pos", "world_vel"), record=True,
                       simulation_rate=m.SIM_RATE_HZ)
    row = entity_row(roll.meta, "world_pos", "drone")
    pos_col0 = roll.initial_state["world_pos"]
    rng = np.random.default_rng(seed)
    starts = jnp.asarray(rng.uniform(-1.0, 1.0, size=(batch, 3)) * jnp.array([2.0, 2.0, 1.0])
                         + jnp.array([0.0, 0.0, 1.0]))

    def loss_one(params, start):
        traj = roll({"world_pos": pos_col0.at[row, 4:].set(start), **params})
        pos = traj["world_pos"][:, row, 4:]
        vel = traj["world_vel"][:, row, 3:]
        t_w = jnp.linspace(0.2, 1.0, ticks)[:, None]
        return (jnp.mean(t_w * (pos - m.TARGET) ** 2) + 0.05 * jnp.mean(t_w * vel**2)
                + 2.0 * jnp.mean((pos[-1] - m.TARGET) ** 2) + 0.5 * jnp.mean(vel[-1] ** 2))

    return lambda params: jnp.mean(jax.vmap(lambda s: loss_one(params, s))(starts))


def test_neural_hover_loss_and_grads_match_jax():
    jparams = _jax_hover_init()
    jval, jgrads = jax.value_and_grad(_jax_hover_loss(HOVER_TICKS, HOVER_BATCH))(jparams)
    params = th.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "w1": (32, 9), "b1": (32,), "w2": (3, 32), "b2": (3,)}
    params = {k: v.requires_grad_() for k, v in params.items()}
    val = th.make_loss(th.starts(HOVER_BATCH), HOVER_TICKS, "cpu")(params)
    grads = torch.autograd.grad(val, list(params.values()))
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-10)
    for k, g in zip(params, grads):
        assert np.abs(np.asarray(jgrads[k])).max() > 0.0, k
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]), rtol=1e-10, atol=1e-14,
                                   err_msg=k)


def test_neural_hover_adam_iterates_match_optax(monkeypatch):
    """Both examples' ``train`` from their own threefry initialisation
    (within a few ulps of each other), 3 steps at the cut depth."""
    monkeypatch.setattr(jh(), "TICKS", HOVER_TICKS)
    monkeypatch.setattr(th, "TICKS", HOVER_TICKS)
    jparams, jloss = jh().train(iters=3, batch=HOVER_BATCH, verbose=False)
    init = th.init_params(0, "cpu")
    params, loss = th.train(iters=3, batch=HOVER_BATCH, verbose=False, device="cpu")
    np.testing.assert_allclose(loss, jloss, rtol=1e-10)
    for k in th.PARAMS:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]), rtol=1e-10,
                                   atol=1e-14, err_msg=k)
        assert not torch.equal(params[k], init[k]), k
    miss, speed = th.evaluate(params)
    assert np.isfinite(miss) and np.isfinite(speed)


def test_neural_hover_threefry_initialisation_matches_jax():
    ours = th.init_params(0, "cpu")
    ref = _jax_hover_init(0)
    k1, k2 = threefry.split(threefry.key(0))
    for name, key, shape, scale in (("w1", k1, (32, 9), 0.3), ("w2", k2, (3, 32), 0.1)):
        u = threefry.uniform(key, shape, torch.float64, threefry._lowest(torch.float64), 1.0)
        exact = np.sqrt(2.0) * scipy.special.erfinv(u.numpy()) * scale
        o, r = ours[name].numpy(), np.asarray(ref[name])
        assert (np.abs(o - exact) <= 4 * np.spacing(np.abs(exact))).all(), name
        allowed = 4 * np.spacing(np.abs(r)) + np.abs(r - exact)
        assert (np.abs(o - r) <= allowed).all(), name
    for name in ("b1", "b2"):
        np.testing.assert_array_equal(ours[name].numpy(), np.asarray(ref[name]))
