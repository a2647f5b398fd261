"""The ``TotalEdge`` fold's set-up (``system._FoldSetup``): its ids and
stand-in flags on the device, and its staged initial carry, built once per
system and query shape and reused on every later tick.

A fold with its set-up kept must give the bits of the same fold with the
set-up built anew before every tick, on both paths (the dense sum of
``models/nbody.py`` and the sequential fold of ``examples/n_body``), and
the JAX package's values within ``tests/test_torch_nbody.py``'s f64
tolerance (1e-12 relative per channel group).  ``FOLD_SETUPS`` counts one
build per system and query shape; a spawn that changes the ids builds anew.
The row window's case is ``tests/test_torch_multihost.py``'s
``test_ep_fold_reuses_its_setup_per_rank``.
"""

from dataclasses import dataclass
from typing import Annotated

import numpy as np
import pytest
import torch

import elodin_tpu_torch as tel
from elodin_tpu.models import nbody as jnb
from elodin_tpu_torch import interop
from elodin_tpu_torch.examples.n_body import main as port_n_body
from elodin_tpu_torch.models import nbody as tnb
from elodin_tpu_torch.system import FOLD_SETUP_CAP, FOLD_SETUPS, TOTAL_FOLDS, build_step
from torch_port_util import float_policy, jax_example, rel_err

N, TICKS, DT = 48, 6, 60.0
COMPARED = ("world_pos", "world_vel", "world_accel", "force")
# the FnSystem holding each path's fold, and the path it takes
PATHS = {"dense": (lambda: tnb._gravity, "dense"),
         "sequential": (lambda: port_n_body.gravity, "sequential")}


def _since(before: dict, counts: dict) -> dict:
    return {k: counts[k] - before[k] for k in before}


def _port_exec(path: str, world=None):
    if path == "dense":
        world = world or tnb.build_nbody(N, seed=3)
        return world.build(tnb.build_system(DT, use_kernel=False),
                           simulation_rate=1.0 / DT, device="cpu")
    world = world or port_n_body.build_world(N - 2, 3)
    return world.build(port_n_body.build_system(), simulation_rate=1.0 / DT, device="cpu")


def _jax_exec(path: str):
    if path == "dense":
        return jnb.build_nbody(N, seed=3).build(jnb.build_system(DT, use_kernel=False),
                                                simulation_rate=1.0 / DT)
    mod = jax_example("n-body", "main")
    return mod.build_world(n_asteroids=N - 2, seed=3).build(
        mod.build_system(), simulation_rate=1.0 / mod.SIM_TIME_STEP)


def _run(path: str, cleared: bool):
    """The port's columns after TICKS ticks, and the set-ups and folds
    counted, with the set-up kept or built anew before each tick."""
    fn_system = PATHS[path][0]()
    fn_system.fold_setups.clear()
    ex = _port_exec(path)
    setups, folds = dict(FOLD_SETUPS), dict(TOTAL_FOLDS)
    for _ in range(TICKS):
        if cleared:
            fn_system.fold_setups.clear()
        ex.run(1)
    return (interop.columns_to_numpy(ex.cols, ex.meta), _since(setups, FOLD_SETUPS),
            _since(folds, TOTAL_FOLDS))


@pytest.mark.parametrize("path", list(PATHS))
def test_kept_setup_matches_a_fresh_one_and_jax(path):
    with float_policy("f64"):
        kept, setups, folds = _run(path, cleared=False)
        fresh, fresh_setups, _ = _run(path, cleared=True)
        jexec = _jax_exec(path)
        jexec.run(TICKS)
    assert setups == {"built": 1, "reused": TICKS - 1}
    assert fresh_setups == {"built": TICKS, "reused": 0}
    assert folds[PATHS[path][1]] == TICKS
    for name in COMPARED:
        np.testing.assert_array_equal(kept[name], fresh[name], err_msg=name)
        assert rel_err(kept[name], jexec.column_array(name)) <= 1e-12, name


@pytest.mark.parametrize("path", list(PATHS))
def test_a_spawn_builds_anew(path):
    """The same system on a world that gained a body between two
    ``Exec.run``s: one more build, and the bits of a world built afresh with
    a new set-up."""
    with float_policy("f64"):
        fn_system = PATHS[path][0]()
        fn_system.fold_setups.clear()
        world = tnb.build_nbody(N, seed=3) if path == "dense" else port_n_body.build_world(
            N - 2, 3)
        setups = dict(FOLD_SETUPS)
        _port_exec(path, world).run(2)
        world.spawn(tel.Body(world_pos=tel.WorldPos(linear=np.array([4.0e11, 1.0e10, 0.0])),
                             inertia=tel.Inertia(1.0e18)), name="late")
        grown = _port_exec(path, world)
        grown.run(3)
        assert _since(setups, FOLD_SETUPS) == {"built": 2, "reused": 3}
        assert len(fn_system.fold_setups) == 2
        fn_system.fold_setups.clear()
        fresh = _port_exec(path, world)
        fresh.run(3)
    for name in COMPARED:
        np.testing.assert_array_equal(grown.column_array(name), fresh.column_array(name),
                                      err_msg=name)


X = Annotated[torch.Tensor, tel.Component("fold_setup_x", tel.ComponentType.F64)]


@dataclass
class XBody(tel.Archetype):
    fold_setup_x: X


def _x_step(system, values):
    """One tick of ``system`` on a world of X values: (step, state)."""
    w = tel.World()
    for i, v in enumerate(values):
        w.spawn(XBody(np.array(v)), f"x{i}")
    meta, cols = w.snapshot()
    return build_step(meta, system), interop.columns_from_numpy(cols, meta, "cpu")


def test_setups_are_capped():
    """A system keeps at most ``FOLD_SETUP_CAP`` set-ups, the newest."""
    @tel.system
    def fold(g: tel.GraphQuery[tel.TotalEdge], q: tel.Query[X]) -> tel.Query[X]:
        return g.edge_fold(q, q, X, np.array(0.0), lambda c, a, b: c + b, additive=True)

    setups = dict(FOLD_SETUPS)
    with float_policy("f64"):
        for n in range(2, FOLD_SETUP_CAP + 4):
            x = np.arange(n, dtype=np.float64)
            step, state = _x_step(fold, x)
            for _ in range(2):
                np.testing.assert_array_equal(step(state)["fold_setup_x"].numpy(), x.sum() - x)
    assert _since(setups, FOLD_SETUPS) == {"built": FOLD_SETUP_CAP + 2,
                                           "reused": FOLD_SETUP_CAP + 2}
    assert len(fold.fold_setups) == FOLD_SETUP_CAP
    assert [len(k[0]) for k in fold.fold_setups] == list(range(4, FOLD_SETUP_CAP + 4))


@pytest.mark.parametrize("init", [np.array(0.5), 0.5], ids=["array", "float"])
def test_a_host_initial_value_is_staged_by_value(init):
    """The initial carry is staged once while its values hold, and anew
    when they change; the fold reads the values it was given."""
    start = {"value": init}

    @tel.system
    def fold(g: tel.GraphQuery[tel.TotalEdge], q: tel.Query[X]) -> tel.Query[X]:
        return g.edge_fold(q, q, X, start["value"], lambda c, a, b: c + b, additive=True)

    step, state = _x_step(fold, [1.0, 2.0, 4.0])
    with float_policy("f64"):
        step(state)
        (setup,) = fold.fold_setups.values()
        staged = setup.init[0]
        out = step(state)["fold_setup_x"]
        assert setup.init[0] is staged
        np.testing.assert_array_equal(out.numpy(), [6.5, 5.5, 3.5])
        start["value"] = np.array(1.5)
        out = step(state)["fold_setup_x"]
    assert setup.init[0] is not staged
    np.testing.assert_array_equal(out.numpy(), [7.5, 6.5, 4.5])


@pytest.mark.parametrize("cleared", [False, True], ids=["kept", "fresh"])
@pytest.mark.parametrize("additive", [True, False], ids=["dense", "sequential"])
def test_an_initial_value_with_a_gradient_passes_through(additive, cleared):
    """``c0`` requires grad: the fold takes it as it is, and the gradient of
    the sum of ``c0 + sum_{j != i} x_i x_j`` after one tick is N for ``c0``
    and 2 (S - x_k) for ``x_k``, whether the set-up was kept or not."""
    x = torch.tensor([1.0, 2.0, 4.0, 8.0], dtype=torch.float64)
    c0 = torch.tensor(0.25, dtype=torch.float64, requires_grad=True)

    @tel.system
    def fold(g: tel.GraphQuery[tel.TotalEdge], q: tel.Query[X]) -> tel.Query[X]:
        return g.edge_fold(q, q, X, c0, lambda c, a, b: c + a * b, additive=additive)

    step, state = _x_step(fold, x.numpy())
    with float_policy("f64"):
        step(state)  # builds the set-up
        if cleared:
            fold.fold_setups.clear()
        xs = x.clone().requires_grad_()
        out = step({**state, "fold_setup_x": xs})["fold_setup_x"]
        gc, gx = torch.autograd.grad(out.sum(), (c0, xs))
    (setup,) = fold.fold_setups.values()
    assert setup.init == [None]  # passed through, never staged
    assert gc.item() == len(x)
    np.testing.assert_array_equal(gx.numpy(), 2 * (x.sum() - x).numpy())
    np.testing.assert_array_equal(out.detach().numpy(), (0.25 + x * (x.sum() - x)).numpy())
