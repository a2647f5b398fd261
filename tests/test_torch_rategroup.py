"""The port's ``Query.map_seq`` / ``join``, the ``map`` / ``map_seq``
decorators and ``every`` (``RateGroup``) against the JAX package's.

Each case builds the same small world and system in both packages (the
system written once per package, with that package's array module) and
runs it through ``World.build`` -> ``Exec.run`` or
``monte_carlo.BatchedCampaign``.  The results must be equal: these systems
add, multiply and compare a few f64 values in the same order in both
packages, so no tolerance is needed.  Where the JAX package branches with
``lax.cond``, the port's scenario branches in Python (``map_seq``) or with
``torch.where`` (``map``, under ``torch.func.vmap``).
"""

import typing as ty
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elodin_tpu as jel
import elodin_tpu_torch as tel
from elodin_tpu.monte_carlo import BatchedCampaign as JCampaign
from elodin_tpu_torch.monte_carlo import BatchedCampaign as TCampaign
from torch_port_util import float_policy

PACKAGES = {"jax": (jel, jax.Array), "torch": (tel, torch.Tensor)}


def _both(run):
    """``run(el, array_type)`` in each package under the f64 policy."""
    with float_policy("f64"):
        return {name: run(*pkg) for name, pkg in PACKAGES.items()}


def _assert_same(out, expected=None):
    np.testing.assert_array_equal(np.asarray(out["torch"]), np.asarray(out["jax"]))
    if expected is not None:
        np.testing.assert_array_equal(np.asarray(out["torch"]), expected)


def _comp(el, arr, name):
    return ty.Annotated[arr, el.Component(name, el.ComponentType.F64)]


def _build(el, world, system, **kw):
    if el is tel:
        kw["device"] = "cpu"
    return world.build(system, **kw)


def _campaign(el, world, system, n, overrides, **kw):
    if el is tel:
        return TCampaign(world, system, n, overrides, device="cpu", **kw)
    return JCampaign(world, system, n, overrides, **kw)


def _history(ex, names):
    df = ex.history(names)
    return np.stack([np.asarray(df[n], dtype=np.float64) for n in names])


def _xy_world(el, arr, values):
    X, Y = _comp(el, arr, "x"), _comp(el, arr, "y")

    @dataclass
    class T(el.Archetype):
        x: X
        y: Y

    w = el.World()
    for i, (x, y) in enumerate(values):
        w.spawn(T(np.array(x), np.array(y)), f"e{i + 1}")
    return w, X, Y


# -- map_seq ------------------------------------------------------------------


@pytest.mark.parametrize("n_entities", [1, 3])
def test_map_seq_doubles(n_entities):
    def run(el, arr):
        w, X, _ = _xy_world(el, arr, [(1.0 + i, 0.0) for i in range(n_entities)])

        @el.system
        def double_x_seq(q: el.Query[X]) -> el.Query[X]:
            return q.map_seq(X, lambda x: x * 2)

        ex = _build(el, w, double_x_seq)
        ex.run()
        ex.run()
        return _history(ex, [f"e{i + 1}.x" for i in range(n_entities)])

    expected = [[1.0 + i, 2.0 * (1 + i), 4.0 * (1 + i)] for i in range(n_entities)]
    _assert_same(_both(run), expected)


def test_map_seq_multiple_outputs():
    def run(el, arr):
        w, X, Y = _xy_world(el, arr, [(1.0, 10.0), (2.0, 20.0)])

        @el.system
        def swap_xy_seq(q: el.Query[X, Y]) -> el.Query[X, Y]:
            return q.map_seq((X, Y), lambda x, y: (y, x))

        ex = _build(el, w, swap_xy_seq)
        ex.run()
        return _history(ex, ["e1.x", "e1.y", "e2.x", "e2.y"])

    _assert_same(_both(run), [[1.0, 10.0], [10.0, 1.0], [2.0, 20.0], [20.0, 2.0]])


@pytest.mark.parametrize("n_entities", [1, 2])
def test_map_vs_map_seq_match(n_entities):
    def run(el, arr):
        out = []
        for seq in (False, True):
            w, X, Y = _xy_world(el, arr, [(2.0, 3.0), (4.0, 5.0)][:n_entities])

            @el.system
            def sys_(q: el.Query[X, Y]) -> el.Query[X]:
                f = q.map_seq if seq else q.map
                return f(X, lambda x, y: x * y + 1.0)

            ex = _build(el, w, sys_)
            ex.run()
            out.append(_history(ex, [f"e{i + 1}.x" for i in range(n_entities)]))
        np.testing.assert_array_equal(out[0], out[1])
        return out[1]

    _assert_same(_both(run), [[2.0, 7.0], [4.0, 21.0]][:n_entities])


def test_query_no_entities_raises():
    def run(el, arr):
        w, X, _ = _xy_world(el, arr, [(1.0, 0.0)])
        Z = _comp(el, arr, "z_unused")

        @el.system
        def with_map(q: el.Query[Z]) -> el.Query[Z]:
            return q.map(Z, lambda z: z * 2.0)

        with pytest.raises(Exception):
            ex = _build(el, w, with_map)
            ex.run()
        return 0

    _both(run)


def test_map_seq_takes_one_branch_per_entity():
    """map_seq keeps a branch's short circuit: in the JAX package through
    ``lax.cond`` inside ``lax.scan``, in the port through a Python ``if``
    entity by entity, where the branch not taken does not run."""
    taken = []

    def run(el, arr):
        X = _comp(el, arr, "x")
        B = _comp(el, arr, "branch_taken")

        @dataclass
        class T(el.Archetype):
            x: X
            branch_taken: B

        def compute(x):
            if el is jel:
                return (jax.lax.cond(x > 5.0, lambda _: x * 2.0, lambda _: x * 10.0, None),
                        jax.lax.cond(x > 5.0, lambda _: 1.0, lambda _: 0.0, None))
            if x > 5.0:
                taken.append("double")
                return x * 2.0, torch.ones_like(x)
            taken.append("tenfold")
            return x * 10.0, torch.zeros_like(x)

        @el.system
        def cond_sys(q: el.Query[X]) -> el.Query[X, B]:
            return q.map_seq((X, B), compute)

        w = el.World()
        w.spawn(T(np.array(3.0), np.array(0.0)), "e1")
        w.spawn(T(np.array(10.0), np.array(0.0)), "e2")
        ex = _build(el, w, cond_sys)
        ex.run()
        return _history(ex, ["e1.x", "e2.x", "e1.branch_taken", "e2.branch_taken"])[:, -1]

    _assert_same(_both(run), [30.0, 20.0, 0.0, 1.0])
    assert taken == ["tenfold", "double"]


def test_map_with_a_branch_selects():
    def run(el, arr):
        X = _comp(el, arr, "x")

        @dataclass
        class T(el.Archetype):
            x: X

        if el is jel:
            def f(x):
                return jax.lax.cond(x > 5.0, lambda _: x * 2.0, lambda _: x * 10.0, None)
        else:
            def f(x):
                return torch.where(x > 5.0, x * 2.0, x * 10.0)
        f.__annotations__ = {"x": X, "return": X}
        conditional = el.map(f)

        w = el.World()
        for i, v in enumerate((3.0, 10.0, 1.0)):
            w.spawn(T(np.array(v)), f"e{i + 1}")
        ex = _build(el, w, conditional)
        ex.run()
        return _history(ex, ["e1.x", "e2.x", "e3.x"])[:, -1]

    _assert_same(_both(run), [30.0, 20.0, 10.0])


# -- the decorators -----------------------------------------------------------


@pytest.mark.parametrize("seq", [False, True])
def test_map_decorators_one_in_one_out(seq):
    def run(el, arr):
        w, X, _ = _xy_world(el, arr, [(5.0, 0.0), (7.0, 0.0)])

        def double_x(x: X) -> X:
            return x * 2

        ex = _build(el, w, (el.map_seq if seq else el.map)(double_x))
        ex.run()
        ex.run()
        return _history(ex, ["e1.x", "e2.x"])

    _assert_same(_both(run), [[5.0, 10.0, 20.0], [7.0, 14.0, 28.0]])


@pytest.mark.parametrize("seq", [False, True])
def test_map_decorators_tuple_outputs(seq):
    def run(el, arr):
        w, X, Y = _xy_world(el, arr, [(2.0, 3.0), (4.0, 5.0)])

        def compute_xy(x: X, y: Y) -> tuple[X, Y]:
            return x + y, x * y

        sys_ = (el.map_seq if seq else el.map)(compute_xy)
        assert sys_.name == "compute_xy"
        ex = _build(el, w, sys_)
        ex.run()
        return _history(ex, ["e1.x", "e1.y", "e2.x", "e2.y"])

    _assert_same(_both(run), [[2.0, 5.0], [3.0, 6.0], [4.0, 9.0], [5.0, 20.0]])


# -- join -----------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["interleaved", "single"])
def test_join(layout):
    """Query.join keeps the left query's entity order and gathers both
    queries' rows for the shared entities."""

    def run(el, arr):
        X, Y, Z = (_comp(el, arr, n) for n in ("x", "y", "z"))

        @dataclass
        class XY(el.Archetype):
            x: X
            y: Y

        @dataclass
        class YZ(el.Archetype):
            y: Y
            z: Z

        @dataclass
        class XYZ(el.Archetype):
            x: X
            y: Y
            z: Z

        @el.system
        def joined(a: el.Query[X, Y], b: el.Query[Z]) -> el.Query[Y]:
            q = a.join(b)
            return q.map(Y, lambda x, y, z: x * 100.0 + y * 10.0 + z)

        w = el.World()
        if layout == "interleaved":
            w.spawn(XY(np.array(1.0), np.array(2.0)), "a")
            w.spawn(XYZ(np.array(3.0), np.array(4.0), np.array(5.0)), "b")
            w.spawn(YZ(np.array(6.0), np.array(7.0)), "c")
            w.spawn(XYZ(np.array(8.0), np.array(9.0), np.array(1.5)), "d")
            names = ["a.y", "b.y", "c.y", "d.y"]
        else:
            w.spawn(XY(np.array(1.0), np.array(2.0)), "a")
            w.spawn(XYZ(np.array(3.0), np.array(4.0), np.array(5.0)), "b")
            names = ["a.y", "b.y"]
        ex = _build(el, w, joined)
        ex.run()
        return _history(ex, names)[:, -1]

    expected = {"interleaved": [2.0, 345.0, 6.0, 891.5], "single": [2.0, 345.0]}[layout]
    _assert_same(_both(run), expected)


def test_join_without_shared_entities_raises():
    for el, arr in PACKAGES.values():
        X, Z = _comp(el, arr, "x"), _comp(el, arr, "z")

        @dataclass
        class OnlyX(el.Archetype):
            x: X

        @dataclass
        class OnlyZ(el.Archetype):
            z: Z

        @el.system
        def joined(a: el.Query[X], b: el.Query[Z]) -> el.Query[X]:
            return a.join(b).map(X, lambda x, z: x + z)

        w = el.World()
        w.spawn(OnlyX(np.array(1.0)), "a")
        w.spawn(OnlyZ(np.array(2.0)), "b")
        with float_policy("f64"), pytest.raises(RuntimeError, match="matched no entities"):
            _build(el, w, joined).run()


# -- every: schedule, hold and escalation ------------------------------------------


def _runs_world(el, arr, names):
    comps = {n: _comp(el, arr, n) for n in names}

    A = dataclass(type("A", (el.Archetype,), {
        "__annotations__": dict(comps),
        **{n: field(default_factory=lambda: np.float64(0.0)) for n in names},
    }))

    def mk():
        w = el.World()
        w.spawn(A(), name="e")
        return w

    return mk, comps


def _counter(el, C):
    def inc(r: C) -> C:
        return r + 1.0

    return el.map(inc)


def test_every_schedules_and_holds_in_exec():
    """Active ticks are 1, 1+K, 1+2K: 9 ticks of every(3) run the system
    3 times; the fast system runs every tick."""

    def run(el, arr):
        mk, c = _runs_world(el, arr, ["gnc_runs", "fast_runs"])
        ex = _build(el, mk(), el.every(3, _counter(el, c["gnc_runs"]))
                    | _counter(el, c["fast_runs"]), simulation_rate=10.0)
        out = []
        for _ in range(9):
            ex.run(1)
            out.append([ex.read_component("e.gnc_runs")[0],
                        ex.read_component("e.fast_runs")[0]])
        return np.array(out)

    out = _both(run)
    _assert_same(out)
    np.testing.assert_array_equal(out["torch"][:, 0], [1, 1, 1, 2, 2, 2, 3, 3, 3])
    np.testing.assert_array_equal(out["torch"][:, 1], np.arange(1, 10))


@pytest.mark.parametrize("every_n,expected", [(3, 3.0), (1, 9.0), (4, 3.0)])
def test_every_in_the_campaign(every_n, expected):
    """The campaign lifts the gate outside the sample vmap: the same
    schedule for every sample; every(1) is the identity schedule."""

    def run(el, arr):
        mk, c = _runs_world(el, arr, ["gnc_runs", "fast_runs"])
        camp = _campaign(el, mk(), el.every(every_n, _counter(el, c["gnc_runs"]))
                         | _counter(el, c["fast_runs"]), 4,
                         {"e.gnc_runs": np.zeros(4)}, simulation_rate=10.0)
        r = camp.run(9)
        if el is tel:
            assert camp.gated_runs == (expected if every_n > 1 else 0)
        return np.stack([r.component("e.gnc_runs"), r.component("e.fast_runs")])

    _assert_same(_both(run), [np.full(4, expected), np.full(4, 9.0)])


def test_every_full_rate_escalation_in_exec_and_campaign():
    """Escalate once the count reaches 2: ticks 1 and 4 run on schedule,
    then every tick from 5 to 9, so 7 runs in 9 ticks."""

    def run(el, arr):
        mk, c = _runs_world(el, arr, ["esc_runs"])
        sched = el.every(3, _counter(el, c["esc_runs"]),
                         full_rate_when=lambda cols: cols["esc_runs"] >= 2.0)
        ex = _build(el, mk(), sched, simulation_rate=10.0)
        ex.run(9)
        camp = _campaign(el, mk(), sched, 3, {"e.esc_runs": np.zeros(3)},
                         simulation_rate=10.0)
        return np.concatenate([ex.read_component("e.esc_runs"),
                               camp.run(9).component("e.esc_runs")])

    _assert_same(_both(run), np.full(4, 7.0))


def test_every_escalation_is_any_over_samples():
    """One sample that satisfies the predicate escalates every sample (the
    schedule stays sample-uniform)."""

    def run(el, arr):
        mk, c = _runs_world(el, arr, ["esc_runs"])
        sched = el.every(3, _counter(el, c["esc_runs"]),
                         full_rate_when=lambda cols: cols["esc_runs"] >= 2.0)
        camp = _campaign(el, mk(), sched, 3, {"e.esc_runs": np.array([0.0, 0.0, 1.5])},
                         simulation_rate=10.0)
        return camp.run(9).component("e.esc_runs")

    # sample 2 reaches 2.5 at tick 1, so every sample runs on all 9 ticks
    _assert_same(_both(run), [9.0, 9.0, 10.5])


def test_every_nested_inside_the_sample_vmap():
    """A RateGroup the campaign cannot lift (here inside an every(1)) runs
    in the sample vmap: both branches and a select, as ``lax.cond`` does
    under ``jax.vmap``; the schedule is the same."""

    def run(el, arr):
        mk, c = _runs_world(el, arr, ["gnc_runs"])
        nested = el.every(1, el.every(3, _counter(el, c["gnc_runs"])))
        camp = _campaign(el, mk(), nested, 2, {}, simulation_rate=10.0)
        ex = _build(el, mk(), nested, simulation_rate=10.0)
        ex.run(9)
        return np.concatenate([camp.run(9).component("e.gnc_runs"),
                               ex.read_component("e.gnc_runs")])

    _assert_same(_both(run), np.full(3, 3.0))


def test_every_rejects_a_rate_below_one():
    for el in (jel, tel):
        with pytest.raises(ValueError, match="every must be >= 1"):
            el.every(0, lambda: None)


def test_exec_write_then_read_component():
    def run(el, arr):
        mk, c = _runs_world(el, arr, ["gnc_runs"])
        ex = _build(el, mk(), _counter(el, c["gnc_runs"]), simulation_rate=10.0)
        ex.run(2)
        ex.write_component("e.gnc_runs", 40.0)
        written = ex.read_component("e.gnc_runs")[0]
        ex.run(1)
        return [written, ex.read_component("e.gnc_runs")[0], ex.read_component("Globals.tick")[0]]

    _assert_same(_both(run), [40.0, 41.0, 3.0])
