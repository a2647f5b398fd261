"""``World.to_torch`` / ``World.to_jax`` and ``TorchSim`` (counterparts of
``tests/test_jaxsim.py``'s tests of ``World.to_jax`` / ``JaxSim``), and the
cube-sat stepped through them (``examples.cube_sat_pysim``) against the JAX
package's ``JaxSim``, on the CPU in f64.

Stated tolerances: the toy sims exactly (doublings of small integers); the
six-dof body through ``to_jax`` against ``Exec``'s history, rtol 1e-12 (as
the JAX test); the cube-sat's state after 2 chunks of 20 ticks, port
against JAX, ≤ 1e-12 in max |Δ| / (1 + |x|) (``tests/test_torch_cube_sat.py``
holds the same world through ``Exec`` to the same bound).
"""

import typing as ty
from dataclasses import dataclass

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.func import vmap

import elodin_tpu_torch as el
from elodin_tpu_torch.examples.cube_sat import main as tc
from elodin_tpu_torch.examples.cube_sat_pysim import main as pysim
from torch_port_util import float_policy, jax_example, mixed_errs

X = ty.Annotated[torch.Tensor, el.Component("x", el.ComponentType.F64)]


@dataclass
class T(el.Archetype):
    x: X


@el.map
def double(x: X) -> X:
    return x * 2


def _world(x0=1.0):
    w = el.World()
    w.spawn(T(np.float64(x0)), "e1")
    return w


def test_to_jax_step():
    sim = _world().to_jax(double, device="cpu")
    assert isinstance(sim, el.TorchSim) and el.JaxSim is el.TorchSim
    sim.step(3)
    assert float(sim.get_state("x", "e1")) == 8.0
    assert sim.get_tick_count() == 3
    # the tick is incremented here, before each step (as in the JAX package)
    assert int(sim.get_state("tick", "Globals")) == 3
    assert sim.get_state("x").shape == (1,) and set(sim.get_state()) >= {"x", "tick"}


def test_to_torch_is_to_jax_and_takes_the_jax_parameters_in_order():
    sim = _world().to_torch(double, 60.0, 1.0, None, "cpu")
    sim.step(1)
    assert float(sim.get_state("simulation_time_step", "Globals")) == 1.0 / 60.0
    assert el.World.to_jax is el.World.to_torch


def test_set_state_applies():
    sim = _world().to_jax(double, device="cpu")
    x_before = sim.state["x"]
    sim.set_state("x", "e1", torch.tensor(10.0))
    assert float(x_before[0]) == 1.0  # the column is not written in place
    sim.step(1)
    assert float(sim.get_state("x", "e1")) == 20.0
    sim.set_state("x", "e1", 3.0)
    sim.step(1)
    assert float(sim.get_state("x", "e1")) == 6.0
    with pytest.raises(Exception, match="does not match"):
        sim.set_state("x", "e1", torch.zeros(2))
    with pytest.raises(Exception, match="not found"):
        sim.set_state("x", "nobody", 1.0)
    with pytest.raises(Exception, match="not found"):
        sim.get_state("nothing", "e1")


def test_torchsim_vmap_over_sims():
    """vmap over the state dict batches whole simulations."""
    sim = _world().to_jax(double, device="cpu")
    xs = torch.tensor([[1.0], [2.0], [4.0]], dtype=torch.float64)

    def run(x_col):
        state = dict(sim.state)
        state["x"] = x_col
        return sim.py_sim(state)["x"]

    np.testing.assert_array_equal(vmap(run)(xs)[:, 0].numpy(), [2.0, 4.0, 8.0])


def test_six_dof_to_jax_matches_build():
    def world():
        w = el.World()
        w.spawn(el.Body(world_vel=el.SpatialMotion(
            linear=torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64))), "b")
        return w

    exec_ = world().build(el.six_dof(1.0 / 60.0), simulation_rate=60.0, device="cpu")
    exec_.run(10)
    pos_build = exec_.history("b.world_pos")["b.world_pos"][-1].to_numpy()
    sim = world().to_jax(el.six_dof(1.0 / 60.0), simulation_rate=60.0, device="cpu")
    sim.step(10)
    np.testing.assert_allclose(sim.get_state("world_pos", "b").numpy(), pos_build, rtol=1e-12)


def test_c_helper_bundle_with_a_tensor_value():
    Y = ty.Annotated[torch.Tensor, el.Component("cy", el.ComponentType.F64)]
    w = el.World()
    w.spawn(el.C(Y, torch.tensor(7.0)), "e1")

    @el.map
    def inc(y: Y) -> Y:
        return y + 1

    exec_ = w.build(inc, device="cpu")
    exec_.run(2)
    assert float(exec_.history("e1.cy")["e1.cy"][-1]) == 9.0


def test_tick_count_survives_a_pytree_round_trip():
    sim = _world().to_jax(double, device="cpu")
    sim.step(5)
    leaves, spec = pytree.tree_flatten(sim)
    assert all(isinstance(x, torch.Tensor) for x in leaves)
    sim2 = pytree.tree_unflatten(leaves, spec)
    assert isinstance(sim2, el.TorchSim) and sim2.get_tick_count() == 5
    assert float(sim2.get_state("x", "e1")) == 32.0
    sim2.step(1)
    assert sim2.get_tick_count() == 6 and sim.get_tick_count() == 5
    # two sims at different ticks have one spec (the count is a leaf)
    assert pytree.tree_flatten(sim2)[1] == spec


def test_print_dictionary(capsys):
    _world().to_jax(double, device="cpu").print_dictionary()
    out = capsys.readouterr().out
    assert "x: e1 (shape: ())" in out and "tick: Globals (shape: ())" in out


def test_cube_sat_pysim_matches_jax_jaxsim():
    chunk, chunks = 20, 2
    with float_policy("f64"):
        omegas = pysim.run(chunk, chunks, device="cpu")
        j = jax_example("cube-sat", "main")
        jsim = j.build_world().to_jax(j.build_system())
        jomegas = []
        for _ in range(chunks):
            jsim.step(chunk)
            jomegas.append(float(np.linalg.norm(np.asarray(jsim.get_state("world_vel", "ore_sat"))[:3])))
        sim = tc.build_world().to_jax(tc.build_system(), device="cpu")
        sim.step(chunk * chunks)
    np.testing.assert_allclose(omegas, jomegas, rtol=1e-12)
    assert sim.get_tick_count() == jsim.get_tick_count() == chunk * chunks
    ours = {k: v.numpy() for k, v in sim.state.items()}
    errs = mixed_errs(ours, {k: np.asarray(v) for k, v in jsim.state.items()})
    assert max(errs.values()) <= 1e-12, sorted(errs.items(), key=lambda kv: -kv[1])[:4]
