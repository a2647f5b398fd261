"""The port's differentiable rollouts (``elodin_tpu_torch.diff``) and the
orbit-retarget example (``examples.orbit_retarget``) against the JAX
package's ``el.rollout`` and example, on the CPU in f64
(``tests/test_torch_neural_hover.py`` holds the other example that trains
through a rollout).

Stated tolerances:

* orbit-retarget, 60 ticks: the port's value and gradient against JAX's,
  rtol 1e-10 (~1e-15 seen: the same algebra through autograd and
  ``jax.grad``); the gradient against the central finite difference
  (eps 1e-6), rtol 1e-5, atol 1e-8, as ``tests/test_diff.py``.
* remat (6 segments) against plain: value rtol 1e-12 and gradient rtol
  1e-9 (``tests/test_diff.py``'s); the port's recompute reproduces the
  forward, so both are also bitwise equal.
* the recorded trajectory's last row and remat's record: bitwise.
* ``torch.func.vmap`` over three candidates: bitwise the single calls,
  rtol 1e-12 against JAX's vmap.
* ``solve``'s first 5 Adam iterates against ``optax.adam`` (60 ticks),
  and 5 Adam iterates of the system identification (the centre's mass,
  120 ticks recorded): rtol 1e-10; the mass gradient rtol 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import vmap

import elodin_tpu_torch as el
from elodin_tpu_torch import diff
from elodin_tpu_torch.examples.orbit_retarget import main as to
from elodin_tpu_torch.models.nbody import build_nbody
from elodin_tpu_torch.system import TOTAL_FOLDS
from torch_port_util import jax_example

jax.config.update("jax_enable_x64", True)

V0 = np.array([0.1, 1.0, 0.05])


def jo():
    return jax_example("orbit-retarget", "main")


def _jax_roll(ticks, **kw):
    import elodin as jel

    m = jo()
    return jel.rollout(m.build_world(), jel.six_dof(sys=m.gravity), ticks,
                       simulation_rate=1.0 / m.SIM_TIME_STEP, **kw)


def _port_roll(ticks, **kw):
    return el.rollout(to.build_world(), to.build_system(), ticks,
                      simulation_rate=1.0 / to.SIM_TIME_STEP, device="cpu", **kw)


def _port_final_pos_loss(roll):
    """``tests/test_diff.py``'s loss: the craft's squared final radius as a
    function of its initial linear velocity."""
    row = diff.entity_row(roll.meta, "world_pos", "craft")
    v_col0 = roll.initial_state["world_vel"]

    def loss(v0):
        col = diff.set_entity(v_col0, roll.meta, "world_vel", "craft",
                              torch.cat([v_col0[row, :3], v0]))
        return torch.sum(roll({"world_vel": col})["world_pos"][row, 4:] ** 2)

    return loss


def _jax_final_pos_loss(roll):
    from elodin_tpu.diff import entity_row

    row = entity_row(roll.meta, "world_pos", "craft")
    v_col0 = roll.initial_state["world_vel"]

    def loss(v0):
        final = roll({"world_vel": v_col0.at[row, 3:].set(v0)})
        return jnp.sum(final["world_pos"][row, 4:] ** 2)

    return loss


def _value_and_grad(loss, v0):
    v = torch.tensor(v0, dtype=torch.float64, requires_grad=True)
    val = loss(v)
    (g,) = torch.autograd.grad(val, v)
    return float(val.detach()), g.numpy()


@pytest.fixture(scope="module")
def orbit60():
    """(port value, port gradient) at 60 ticks, plain."""
    return _value_and_grad(_port_final_pos_loss(_port_roll(60, outputs=("world_pos",))), V0)


def test_orbit_value_and_grad_match_jax(orbit60):
    val, g = orbit60
    jval, jg = jax.value_and_grad(_jax_final_pos_loss(_jax_roll(60, outputs=("world_pos",))))(
        jnp.asarray(V0))
    np.testing.assert_allclose(val, float(jval), rtol=1e-10)
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-10)


def test_grad_matches_finite_difference(orbit60):
    _, g = orbit60
    loss = _port_final_pos_loss(_port_roll(60, outputs=("world_pos",)))
    eps = 1e-6
    with torch.no_grad():
        for i in range(3):
            e = np.zeros(3)
            e[i] = eps
            fd = (float(loss(torch.tensor(V0 + e))) - float(loss(torch.tensor(V0 - e)))) / (2 * eps)
            np.testing.assert_allclose(g[i], fd, rtol=1e-5, atol=1e-8)


def test_remat_matches_plain_value_and_grad(orbit60):
    val, g = orbit60
    rval, rg = _value_and_grad(
        _port_final_pos_loss(_port_roll(60, outputs=("world_pos",), remat_segments=6)), V0)
    np.testing.assert_allclose(rval, val, rtol=1e-12)
    np.testing.assert_allclose(rg, g, rtol=1e-9)
    # the recompute runs the forward's ops on the forward's inputs
    assert rval == val and np.array_equal(rg, g)


def _probed_nbody_system():
    """n-body gravity as ``examples/n-body/main.py`` writes its fold (no
    additive hint: the probe decides), a new system each call."""
    from elodin_tpu_torch.models.nbody import G

    @el.system
    def gravity(graph: el.GraphQuery[el.TotalEdge],
                query: el.Query[el.WorldPos, el.Inertia]) -> el.Query[el.Force]:
        def gravity_fn(force, a_pos, a_inertia, b_pos, b_inertia):
            r = a_pos.linear() - b_pos.linear()
            norm = torch.linalg.norm(r)
            f = (G * a_inertia.mass()) * ((b_inertia.mass() / norm**3) * r)
            return el.Force(linear=force.force() - f)

        return graph.edge_fold(query, query, el.Force, el.Force(), gravity_fn)

    return el.six_dof(time_step=60.0, sys=gravity, integrator=el.Integrator.SemiImplicit)


def test_remat_recompute_keeps_the_host_side_state():
    """A probed TotalEdge fold under remat: the recompute takes the path
    the forward took (the probe's verdict is cached per system and runs
    once), every fold is counted again by the recompute, and the gradient
    equals the plain rollout's bitwise."""

    def grad(remat):
        roll = el.rollout(build_nbody(6, seed=2), _probed_nbody_system(), 8,
                          outputs=("world_pos",), remat_segments=remat,
                          simulation_rate=1.0 / 60.0, device="cpu")
        pos0 = roll.initial_state["world_pos"].clone().requires_grad_()
        for k in TOTAL_FOLDS:
            TOTAL_FOLDS[k] = 0
        out = roll({"world_pos": pos0})["world_pos"]
        forward = dict(TOTAL_FOLDS)
        (g,) = torch.autograd.grad(torch.sum(out[:, 4:] ** 2), pos0)
        return out.detach(), g, forward, dict(TOTAL_FOLDS)

    out, g, fwd, after = grad(None)
    rout, rg, rfwd, rafter = grad(4)
    assert torch.equal(rout, out) and torch.equal(rg, g)
    assert fwd == rfwd and fwd["probes"] == 1 and fwd["dense"] + fwd["sequential"] == 8
    assert after == fwd  # plain: the backward runs no step
    # remat: the recompute folds every tick again, by the same path, no probe
    assert rafter == {**fwd, "dense": 2 * fwd["dense"], "sequential": 2 * fwd["sequential"]}


def test_recorded_trajectory_matches_final_state_and_remat_order():
    rec = _port_roll(48, outputs=("world_pos",), record=True)
    traj = rec(None)["world_pos"]
    assert traj.shape[0] == 48
    final = _port_roll(48, outputs=("world_pos",))(None)["world_pos"]
    assert torch.equal(traj[-1], final)
    traj2 = _port_roll(48, outputs=("world_pos",), record=True, remat_segments=4)(None)["world_pos"]
    assert torch.equal(traj2, traj)
    jtraj = _jax_roll(48, outputs=("world_pos",), record=True)(None)["world_pos"]
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=1e-12, atol=1e-15)


def test_vmap_over_candidate_batch():
    roll = _port_roll(30, outputs=("world_pos",))
    row = diff.entity_row(roll.meta, "world_pos", "craft")
    v_col0 = roll.initial_state["world_vel"]

    def final_pos(v0):
        col = diff.set_entity(v_col0, roll.meta, "world_vel", "craft",
                              torch.cat([v_col0[row, :3], v0]))
        return roll({"world_vel": col})["world_pos"][row, 4:]

    v0s = np.array([[0.0, 1.0, 0.0], [0.1, 0.9, 0.0], [0.3, 1.1, 0.0]])
    batched = vmap(final_pos)(torch.tensor(v0s))
    assert batched.shape == (3, 3)
    for i in range(3):
        assert torch.equal(batched[i], final_pos(torch.tensor(v0s[i])))

    from elodin_tpu.diff import entity_row

    jroll = _jax_roll(30, outputs=("world_pos",))
    jrow = entity_row(jroll.meta, "world_pos", "craft")
    jcol = jroll.initial_state["world_vel"]
    ref = jax.vmap(lambda v: jroll({"world_vel": jcol.at[jrow, 3:].set(v)})["world_pos"][jrow, 4:])(
        jnp.asarray(v0s))
    np.testing.assert_allclose(batched.numpy(), np.asarray(ref), rtol=1e-12)


def test_rollout_argument_errors():
    w, sys_ = to.build_world(), to.build_system()
    with pytest.raises(ValueError):
        el.rollout(w, sys_, 50, remat_segments=7, device="cpu")  # 50 % 7 != 0
    with pytest.raises(ValueError):
        el.rollout(w, sys_, 50, remat_segments=0, device="cpu")
    with pytest.raises(ValueError):
        el.rollout(w, sys_, 50, record=True, device="cpu")  # record needs outputs
    with pytest.raises(KeyError):
        el.rollout(w, sys_, 50, outputs=("nope",), device="cpu")
    roll = el.rollout(w, sys_, 10, device="cpu")
    with pytest.raises(KeyError):
        roll({"nope": torch.zeros(3)})
    with pytest.raises(KeyError):
        diff.entity_row(roll.meta, "world_pos", "nobody")
    with pytest.raises(KeyError):
        diff.entity_row(roll.meta, "gravity_edge", "craft")


def test_remat_inside_torch_func_raises_clearly():
    remat = _port_roll(4, outputs=("world_pos",), remat_segments=2)
    loss = _port_final_pos_loss(remat)
    with pytest.raises(NotImplementedError, match="vmap"):
        vmap(loss)(torch.tensor(np.stack([V0, V0])))
    with pytest.raises(NotImplementedError, match="torch.func"):
        torch.func.grad(loss)(torch.tensor(V0))
    # without remat both transforms run, and torch.func.grad is autograd's
    plain = _port_final_pos_loss(_port_roll(4, outputs=("world_pos",)))
    _, g = _value_and_grad(plain, V0)
    assert np.array_equal(torch.func.grad(plain)(torch.tensor(V0)).numpy(), g)


def test_rollout_never_mutates_the_world_or_its_initial_state():
    roll = _port_roll(5)
    before = {k: v.clone() for k, v in roll.initial_state.items()}
    v = torch.tensor([0.0, 0.0, 0.0, 0.2, 0.8, 0.1], dtype=torch.float64)
    out = roll({"world_vel": diff.set_entity(roll.initial_state["world_vel"], roll.meta,
                                             "world_vel", "craft", v)})
    assert int(out["tick"][0]) == 5
    for k, t in roll.initial_state.items():
        assert torch.equal(t, before[k]), k
    assert int(roll(None)["tick"][0]) == 5


def test_set_entity_is_functional_under_autograd_and_vmap():
    col = torch.arange(12, dtype=torch.float64).reshape(2, 6)
    col_before = col.clone()
    meta = _port_roll(1).meta
    v = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], dtype=torch.float64, requires_grad=True)
    out = diff.set_entity(col, meta, "world_vel", "craft", v)
    row = diff.entity_row(meta, "world_vel", "craft")
    assert torch.equal(col, col_before) and torch.equal(out[row], v.detach())
    assert torch.equal(out[1 - row], col[1 - row])
    (g,) = torch.autograd.grad(torch.sum(out * 2.0), v)
    assert torch.equal(g, torch.full((6,), 2.0, dtype=torch.float64))
    # unbatched column, batched value
    vs = torch.arange(18, dtype=torch.float64).reshape(3, 6)
    outs = vmap(lambda x: diff.set_entity(col, meta, "world_vel", "craft", x))(vs)
    assert outs.shape == (3, 2, 6) and torch.equal(col, col_before)
    for i in range(3):
        assert torch.equal(outs[i][row], vs[i]) and torch.equal(outs[i][1 - row], col[1 - row])
    with pytest.raises(RuntimeError):
        diff.set_entity(col, meta, "world_vel", "craft", torch.zeros(3))


def test_solve_first_adam_iterates_match_optax(monkeypatch):
    monkeypatch.setattr(to, "TICKS", 60)
    monkeypatch.setattr(jo(), "TICKS", 60)
    v0, miss = to.solve(iters=5, verbose=False, device="cpu")
    jv0, jmiss = jo().solve(iters=5, verbose=False)
    np.testing.assert_allclose(v0.numpy(), np.asarray(jv0), rtol=1e-10)
    np.testing.assert_allclose(miss, jmiss, rtol=1e-10)
    assert not np.array_equal(v0.numpy(), [0.0, 1.0, 0.0])


def test_system_identification_mass_gradient_and_adam():
    """The centre's mass (the gravitational parameter) from an observed
    trajectory, as ``tests/test_diff.py``: the gradient and 5 Adam steps
    (lr 2e-2) against JAX's and optax's."""
    from elodin_tpu.diff import entity_row

    roll = _port_roll(120, outputs=("world_pos",), record=True)
    crow = diff.entity_row(roll.meta, "inertia", "center")
    prow = diff.entity_row(roll.meta, "world_pos", "craft")
    inertia0 = roll.initial_state["inertia"]

    def traj(mu):
        row = torch.cat([inertia0[crow, :6], mu.reshape(1)])
        return roll({"inertia": diff.set_row(inertia0, crow, row)})["world_pos"][:, prow, 4:]

    with torch.no_grad():
        observed = traj(torch.tensor(1.0, dtype=torch.float64))

    def loss(mu):
        return torch.mean((traj(mu) - observed) ** 2)

    jroll = _jax_roll(120, outputs=("world_pos",), record=True)
    jcrow = entity_row(jroll.meta, "inertia", "center")
    jprow = entity_row(jroll.meta, "world_pos", "craft")
    jin0 = jroll.initial_state["inertia"]

    def jtraj(mu):
        return jroll({"inertia": jin0.at[jcrow, 6].set(mu)})["world_pos"][:, jprow, 4:]

    jobserved = jtraj(jnp.float64(1.0))
    jvg = jax.jit(jax.value_and_grad(lambda mu: jnp.mean((jtraj(mu) - jobserved) ** 2)))

    mu = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([mu], lr=2e-2)
    jmu = jnp.float64(0.7)
    jopt = optax.adam(2e-2)
    jstate = jopt.init(jmu)
    for step in range(5):
        opt.zero_grad()
        val = loss(mu)
        val.backward()
        jval, jg = jvg(jmu)
        np.testing.assert_allclose(val.item(), float(jval), rtol=1e-10)
        np.testing.assert_allclose(float(mu.grad), float(jg), rtol=1e-10)
        if step == 0:
            assert float(mu.grad) != 0.0
        opt.step()
        updates, jstate = jopt.update(jg, jstate)
        jmu = optax.apply_updates(jmu, updates)
        np.testing.assert_allclose(mu.item(), float(jmu), rtol=1e-10)
