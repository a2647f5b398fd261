"""The port's ``@system``, ``Query`` and ``GraphQuery`` against the JAX
package's.

Each case builds the same small world and system in both packages, the
system written once per package with that package's array module, and
runs ``World.build`` → ``Exec.run``.  The results must be equal: these
folds and maps add, multiply and compare a few f64 values, in the same
order in both packages, so no tolerance is needed.
"""

from dataclasses import dataclass
from typing import Annotated

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elodin_tpu as jel
import elodin_tpu_torch as tel
from elodin_tpu.system import GraphQuery as JGraphQuery
from elodin_tpu_torch.system import TOTAL_FOLDS
from elodin_tpu_torch.system import GraphQuery as TGraphQuery
from torch_port_util import float_policy

PACKAGES = {"jax": (jel, jax.Array, jnp), "torch": (tel, torch.Tensor, torch)}


def _build(el, world, system, **kw):
    """``world.build``; the port's on the CPU."""
    if el is tel:
        kw["device"] = "cpu"
    return world.build(system, **kw)


def _comp(el, array_type, name):
    return Annotated[array_type, el.Component(name, el.ComponentType.F64)]


def _both(run):
    """``run(el, array_type, xp)`` in each package under the f64 policy;
    returns {package: result}."""
    out = {}
    with float_policy("f64"):
        for name, pkg in PACKAGES.items():
            out[name] = run(*pkg)
    return out


def _assert_same(results):
    np.testing.assert_array_equal(np.asarray(results["torch"]),
                                  np.asarray(results["jax"]))


def _folds_since(before):
    return {k: TOTAL_FOLDS[k] - before[k] for k in before}


def test_query_map_and_pipe():
    def run(el, arr, xp):
        X, Y = _comp(el, arr, "x"), _comp(el, arr, "y")

        @el.system
        def double(x: el.Query[X]) -> el.Query[X]:
            return x.map(X, lambda x: x * 2)

        @el.system
        def mul(q: el.Query[X, Y]) -> el.Query[X]:
            return q.map(X, lambda x, y: x * y)

        @dataclass
        class T(el.Archetype):
            x: X
            y: Y

        @dataclass
        class OnlyX(el.Archetype):
            x: X

        w = el.World()
        w.spawn(T(np.array(1.0), np.array(500.0)), "e1")
        w.spawn(T(np.array(15.0), np.array(3.0)), "e2")
        w.spawn(OnlyX(np.array(7.0)), "e3")  # not in the X, Y query
        ex = _build(el, w, double.pipe(mul))
        ex.run(2)
        return ex.column_array("x")

    out = _both(run)
    _assert_same(out)
    np.testing.assert_array_equal(out["torch"], [1.0 * 2 * 500 * 2 * 500, 15.0 * 2 * 3 * 2 * 3, 28.0])


def test_query_map_single_entity_and_indexing():
    def run(el, arr, xp):
        X = _comp(el, arr, "x")
        seen = {}

        @el.system
        def shift(x: el.Query[X]) -> el.Query[X]:
            seen["len"] = len(x)
            return x.map(X, lambda v: v + x[0] + 1.5)

        @dataclass
        class T(el.Archetype):
            x: X

        w = el.World()
        w.spawn(T(np.array(2.0)), "only")
        ex = _build(el, w, shift)
        ex.run(1)
        return [*ex.column_array("x"), seen["len"]]

    out = _both(run)
    _assert_same(out)
    assert out["torch"] == [5.5, 1]


def test_explicit_edge_fold():
    def run(el, arr, xp):
        X = _comp(el, arr, "x")
        E = Annotated[el.Edge, el.Component("test_edge")]

        @dataclass
        class T(el.Archetype):
            x: X

        @dataclass
        class Link(el.Archetype):
            edge: E

        @el.system
        def fold(graph: el.GraphQuery[E], x: el.Query[X]) -> el.Query[X]:
            return graph.edge_fold(x, x, X, np.array(5.0), lambda c, a, b: c + a + b)

        w = el.World()
        a = w.spawn(T(np.array([1.0])), "e1")
        b = w.spawn(T(np.array([2.0])), "e2")
        c = w.spawn(T(np.array([2.0])), "e3")
        for f, t in ((a, b), (a, c), (b, c)):
            w.spawn(Link(el.Edge(f, t)))
        ex = _build(el, w, fold)
        ex.run()
        return ex.column_array("x")

    out = _both(run)
    _assert_same(out)
    np.testing.assert_array_equal(out["torch"], [11.0, 9.0, 2.0])


@pytest.mark.parametrize("rev_first", [True, False])
def test_rev_edge_in_any_metadata_position(rev_first):
    def run(el, arr, xp):
        X = _comp(el, arr, "revx")
        meta = ((el.RevEdge, el.Component("rev")) if rev_first
                else (el.Component("rev"), el.RevEdge))
        R = Annotated[(el.Edge, *meta)]

        @dataclass
        class Node(el.Archetype):
            revx: X

        @dataclass
        class Link(el.Archetype):
            e: R

        @el.system
        def fold(g: el.GraphQuery[R], q: el.Query[X]) -> el.Query[X]:
            return g.edge_fold(q, q, X, np.array(0.0), lambda acc, lx, rx: acc + rx)

        w = el.World()
        a = w.spawn(Node(np.array(1.0)), "a")
        b = w.spawn(Node(np.array(10.0)), "b")
        w.spawn(Link(el.Edge(a, b)), "a->b")
        ex = _build(el, w, fold)
        ex.run(1)
        return ex.column_array("revx")

    out = _both(run)
    _assert_same(out)
    # reversed: b folds a's value; a has no edge and keeps its own
    np.testing.assert_array_equal(out["torch"], [1.0, 1.0])


def test_total_edge_max_gap_fold_is_exact():
    """A max-style fold is not additive: the probe sends it to the exact
    sequential fold."""
    vals = [1.0, 4.0, -2.0, 7.5]

    def run(el, arr, xp):
        X = _comp(el, arr, "gx")

        @dataclass
        class T(el.Archetype):
            gx: X

        @el.system
        def max_gap(graph: el.GraphQuery[el.TotalEdge], q: el.Query[X]) -> el.Query[X]:
            return graph.edge_fold(q, q, X, np.array(0.0),
                                   lambda acc, a, b: xp.maximum(acc, xp.abs(a - b)))

        w = el.World()
        for i, v in enumerate(vals):
            w.spawn(T(np.array(v)), f"e{i}")
        ex = _build(el, w, max_gap)
        ex.run()
        return ex.column_array("gx")

    before = dict(TOTAL_FOLDS)
    out = _both(run)
    _assert_same(out)
    assert _folds_since(before) == {"dense": 0, "sequential": 1, "probes": 1}
    expect = [max(abs(v - u) for j, u in enumerate(vals) if j != i)
              for i, v in enumerate(vals)]
    np.testing.assert_array_equal(out["torch"], expect)


@pytest.mark.parametrize("closure,probes", [("constant", 1), ("tensor", 3)])
def test_probe_runs_once_per_system(closure, probes):
    """One system keeps the probe's verdict across ticks for the same fold
    and shapes, as the JAX package keeps it for one trace; a fold that
    closes over a tensor is probed on every tick."""
    def run(el, arr, xp):
        X = _comp(el, arr, "px")

        @dataclass
        class T(el.Archetype):
            px: X

        @el.system
        def max_gap(graph: el.GraphQuery[el.TotalEdge], q: el.Query[X]) -> el.Query[X]:
            half = 0.5 if closure == "constant" else xp.asarray(0.5, dtype=xp.float64)
            return graph.edge_fold(q, q, X, np.array(0.0),
                                   lambda acc, a, b: xp.maximum(acc, half * xp.abs(a - b)))

        w = el.World()
        for i, v in enumerate([1.0, 4.0, -2.0, 7.5]):
            w.spawn(T(np.array(v)), f"e{i}")
        ex = _build(el, w, max_gap)
        ex.run(3)
        return ex.column_array("px")

    before = dict(TOTAL_FOLDS)
    out = _both(run)
    _assert_same(out)
    assert _folds_since(before) == {"dense": 0, "sequential": 3, "probes": probes}


@pytest.mark.parametrize("additive", [True, False])
def test_total_edge_with_one_right_entity(additive):
    """The only right-hand entity has no edge to itself: it is not written,
    and the others fold it."""
    def run(el, arr, xp):
        X, Y = _comp(el, arr, "ox"), _comp(el, arr, "oy")

        @dataclass
        class T(el.Archetype):
            ox: X

        @dataclass
        class U(el.Archetype):
            ox: X
            oy: Y

        @el.system
        def fold(g: el.GraphQuery[el.TotalEdge], left: el.Query[X],
                 right: el.Query[Y]) -> el.Query[X]:
            return g.edge_fold(left, right, X, np.array(0.5),
                               lambda c, lx, ry: c + lx * ry, additive=additive)

        w = el.World()
        w.spawn(T(np.array(1.0)), "a")
        w.spawn(U(np.array(2.0), np.array(10.0)), "b")
        w.spawn(T(np.array(3.0)), "c")
        ex = _build(el, w, fold)
        ex.run(1)
        return ex.column_array("ox")

    out = _both(run)
    _assert_same(out)
    np.testing.assert_array_equal(out["torch"], [10.5, 2.0, 30.5])


def _trap_world(el, arr, xp, additive):
    """A fold additive at the probe's magnitudes and saturating above
    3.5e4, which the entities' pair sums cross."""
    Val, Acc = _comp(el, arr, "trap_val"), _comp(el, arr, "trap_acc")

    @dataclass
    class T(el.Archetype):
        trap_val: Val
        trap_acc: Acc

    @el.system
    def fold(g: el.GraphQuery[el.TotalEdge], q: el.Query[Val]) -> el.Query[Acc]:
        def trap(carry, _lv, rv):
            return xp.where(carry > 3.5e4, carry, carry + rv)

        return g.edge_fold(q, q, Acc, np.array(0.0), trap, additive=additive)

    w = el.World()
    for i, v in enumerate([3.0e4, 4.0e4, 5.0e4]):
        w.spawn(T(np.array(v), np.array(0.0)), f"e{i}")
    ex = _build(el, w, fold, simulation_rate=100.0)
    ex.run(1)
    return ex.column_array("trap_acc")


EXACT = [4.0e4, 3.0e4 + 5.0e4, 3.0e4 + 4.0e4]  # e0 saturates after 4e4
DENSE = [9.0e4, 8.0e4, 7.0e4]


@pytest.mark.parametrize("additive,path", [(False, "sequential"), (True, "dense")])
def test_additive_override_contract(additive, path):
    """False keeps the exact fold, True sums densely without probing."""
    before = dict(TOTAL_FOLDS)
    out = _both(lambda el, arr, xp: _trap_world(el, arr, xp, additive))
    assert _folds_since(before) == {"dense": 0, "sequential": 0, "probes": 0, path: 1}
    _assert_same(out)
    np.testing.assert_array_equal(out["torch"], EXACT if path == "sequential" else DENSE)


def test_probe_decides_when_additive_is_none():
    """The trap is additive at the probe's three magnitudes, so the probe
    accepts it (here and in the JAX package when called outside a trace).
    Inside the JAX package's jitted tick the probe's draws become tracers
    it cannot read, so there every probed fold takes the exact path; the
    port runs eagerly and takes the dense path the probe chose."""
    before = dict(TOTAL_FOLDS)
    out = _both(lambda el, arr, xp: _trap_world(el, arr, xp, None))
    assert _folds_since(before) == {"dense": 1, "sequential": 0, "probes": 1}
    np.testing.assert_array_equal(out["torch"], DENSE)
    np.testing.assert_array_equal(out["jax"], EXACT)


@pytest.mark.parametrize("additive", [None, True])
def test_kill_switch_forces_the_exact_fold(monkeypatch, additive):
    monkeypatch.setenv("ELODIN_EDGE_FOLD_DENSE", "0")
    before = dict(TOTAL_FOLDS)
    out = _both(lambda el, arr, xp: _trap_world(el, arr, xp, additive))
    assert _folds_since(before) == {"dense": 0, "sequential": 1, "probes": 0}
    _assert_same(out)
    np.testing.assert_array_equal(out["torch"], EXACT)


def test_nan_producing_fold_is_not_additive():
    class FakeQuery:
        batch1 = False
        component_classes: list = []
        bufs: list = []

    for gq, xp, init in ((JGraphQuery, jnp, jnp.float64(0.0)),
                         (TGraphQuery, torch, torch.tensor(0.0, dtype=torch.float64))):
        probe = gq.__new__(gq)._fold_is_additive
        assert probe(FakeQuery(), FakeQuery(), init, lambda c: xp.log(c - 100.0)) is False
        assert probe(FakeQuery(), FakeQuery(), init, lambda c: c + 1.0) is True


def _raises_in_both(build, match):
    """``build(el, arr, xp)`` returns an exec; running it raises
    RuntimeError matching ``match`` in both packages."""
    for el, arr, xp in PACKAGES.values():
        with float_policy("f64"), pytest.raises(RuntimeError, match=match):
            build(el, arr, xp).run(1)


def test_errors_match_jax():
    def single_entity_total(el, arr, xp):
        X = _comp(el, arr, "ex")

        @dataclass
        class T(el.Archetype):
            ex: X

        @el.system
        def fold(g: el.GraphQuery[el.TotalEdge], q: el.Query[X]) -> el.Query[X]:
            return g.edge_fold(q, q, X, np.array(0.0), lambda c, a, b: c + b)

        w = el.World()
        w.spawn(T(np.array(1.0)), "alone")
        return _build(el, w, fold)

    def no_matching_edges(el, arr, xp):
        X, Y = _comp(el, arr, "ex"), _comp(el, arr, "ey")
        E = Annotated[el.Edge, el.Component("dangling")]

        @dataclass
        class T(el.Archetype):
            ex: X

        @dataclass
        class U(el.Archetype):
            ey: Y

        @dataclass
        class Link(el.Archetype):
            edge: E

        @el.system
        def fold(g: el.GraphQuery[E], q: el.Query[X]) -> el.Query[X]:
            return g.edge_fold(q, q, X, np.array(0.0), lambda c, a, b: c + b)

        w = el.World()
        a = w.spawn(T(np.array(1.0)), "a")
        u = w.spawn(U(np.array(2.0)), "u")
        w.spawn(Link(el.Edge(a, u)))  # u is not in the X query
        return _build(el, w, fold)

    def empty_query(el, arr, xp):
        X, Z = _comp(el, arr, "ex"), _comp(el, arr, "ez")

        @dataclass
        class T(el.Archetype):
            ex: X

        @dataclass
        class U(el.Archetype):
            ez: Z

        @el.system
        def both(q: el.Query[X, Z]) -> el.Query[X]:
            return q.map(X, lambda x, z: x + z)

        w = el.World()
        w.spawn(T(np.array(1.0)), "a")
        w.spawn(U(np.array(1.0)), "b")
        return _build(el, w, both)

    def wrong_outputs(el, arr, xp):
        X = _comp(el, arr, "ex")

        @dataclass
        class T(el.Archetype):
            ex: X

        @el.system
        def two(q: el.Query[X]) -> el.Query[X]:
            return q.map(X, lambda x: (x, x))

        w = el.World()
        w.spawn(T(np.array(1.0)), "a")
        w.spawn(T(np.array(2.0)), "b")
        return _build(el, w, two)

    _raises_in_both(single_entity_total, "matched no edges")
    _raises_in_both(no_matching_edges, "matched no edges")
    _raises_in_both(empty_query, "matched no entities")
    _raises_in_both(wrong_outputs, "2 component values for 1 declared")


def test_system_needs_annotations():
    for el in (jel, tel):
        with pytest.raises(TypeError, match="needs a Query annotation"):
            el.system(lambda q: q)
