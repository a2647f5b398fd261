"""The port's public surface takes the JAX package's calls: the
signatures of ``Exec.run`` and ``World.build``, the default archive
format, and the small methods of systems, edges and archetypes, each
held against the JAX package's on the CPU."""

import inspect
import os
from dataclasses import dataclass

import numpy as np
import pytest
import torch

import elodin_tpu as jel
import elodin_tpu_torch as tel
from elodin_tpu.execimpl import Exec as JExec
from elodin_tpu_torch.examples.three_body import main as ttb
from torch_port_util import float_policy

X = tel.Annotated[torch.Tensor, tel.Component("x", tel.ComponentType.F64)]
JX = jel.Annotated[np.ndarray, jel.Component("x", jel.ComponentType.F64)]


@pytest.fixture(autouse=True)
def _f64():
    with float_policy("f64"):
        yield


def _exec(**kw):
    return ttb.build_world().build(ttb.build_system(), device="cpu", **kw)


def test_run_takes_show_progress_in_the_jax_order():
    assert (list(inspect.signature(tel.Exec.run).parameters)
            == list(inspect.signature(JExec.run).parameters))
    ex = _exec()
    ex.run(5, show_progress=False)
    # a second positional argument is show_progress, not is_canceled
    ex.run(3, False)
    assert ex.tick() == 8
    calls = []
    ex2 = _exec(telemetry_rate=60.0)  # 2 ticks a batch
    ex2.run(6, False, lambda: calls.append(1) or True)
    assert ex2.tick() == 6 and calls == [1]


def test_build_takes_the_jax_parameters_in_their_order():
    ours = list(inspect.signature(tel.World.build).parameters)
    ref = list(inspect.signature(jel.World.build).parameters)
    assert ours == ref + ["device"]
    ex = ttb.build_world().build(ttb.build_system(), 120.0, False, 60.0, device="cpu")
    assert ex.ticks_per_telemetry == 2 and ex.max_ticks is None
    ex.run(4)
    assert ex.tick() == 4 and len(ex._history.times) == 3
    ex = ttb.build_world().build(ttb.build_system(), 120.0, True, None, 2.0, 3, True,
                                 None, "tpu", "cpu")
    ex.run(10)
    assert ex.tick() == 3 and ex.cols["world_pos"].device.type == "cpu"
    with pytest.raises(NotImplementedError, match="database"):
        ttb.build_world().build(ttb.build_system(), db_path="x.db", device="cpu")


def test_save_archive_defaults_to_parquet(tmp_path):
    import pyarrow.parquet as pq

    ex = _exec()
    ex.run(2)
    ex.save_archive(tmp_path)
    names = ex._history.column_names()
    assert sorted(os.listdir(tmp_path)) == sorted(f"{n}.parquet" for n in names)
    table = pq.read_table(tmp_path / "a.world_pos.parquet")
    np.testing.assert_array_equal(np.asarray(table.column("a.world_pos").to_pylist()),
                                  ex._history.series("world_pos")[:, 0])


def test_matrix_cells_nest_in_arrow(tmp_path):
    import pyarrow.parquet as pq

    from elodin_tpu_torch.dataframe import DataFrame

    m = np.arange(24.0).reshape(2, 3, 4)
    DataFrame({"m": m}).write_parquet(tmp_path / "m.parquet")
    np.testing.assert_array_equal(
        np.asarray(pq.read_table(tmp_path / "m.parquet").column("m").to_pylist()), m)


def test_plain_function_on_the_left_of_a_pipe():
    """``f | system`` with a plain ``@system``-able function on the left,
    and ``System.system()``, as in the JAX package."""
    def make(el, x_ty, lib):
        @el.map
        def double(x: x_ty) -> x_ty:
            return x * 2.0

        def plus_one(q: el.Query[x_ty]) -> el.Query[x_ty]:
            return q.map(x_ty, lambda x: x + 1.0)

        w = el.World()
        w.spawn(el.C(x_ty, lib.asarray(3.0)), name="e")
        sys_ = plus_one | double
        assert isinstance(sys_, el.System) and sys_.system() is sys_
        return w, sys_

    jw, jsys = make(jel, JX, np)
    tw, tsys = make(tel, X, np)
    jex = jw.build(jsys)
    jex.run(2)
    tex = tw.build(tsys, device="cpu")
    tex.run(2)
    np.testing.assert_array_equal(tex.column_array("x"), np.asarray(jex.column_array("x")))
    assert float(tex.column_array("x")[0]) == ((3.0 + 1) * 2 + 1) * 2


def test_write_column():
    w = tel.World()
    w.spawn([tel.C(X, np.float64(1.0))], name="a")
    w.spawn([tel.C(X, np.float64(2.0))], name="b")

    def set_x(builder):
        builder.write_column("x", [5.0, 6.0])

    ex = w.build(tel.LambdaSystem(set_x, "set_x"), device="cpu")
    ex.run(1)
    np.testing.assert_array_equal(ex.column_array("x"), [5.0, 6.0])
    assert ex.cols["x"].dtype == torch.float64


def test_edge_reverse_and_archetype_name():
    for el in (tel, jel):
        e = el.Edge(3, 7).reverse()
        assert (e.from_, e.to) == (7, 3)

    @dataclass
    class TestArchetype(tel.Archetype):
        x: X

    @dataclass
    class JTestArchetype(jel.Archetype):
        x: JX

    assert TestArchetype.archetype_name() == "test_archetype"
    assert JTestArchetype.archetype_name() == "j_test_archetype"
    assert tel.Body.archetype_name() == jel.Body.archetype_name() == "body"
    assert tel.C.archetype_name() == jel.C.archetype_name() == "c"
    assert TestArchetype(np.float64(1.0)).archetype_name() == "test_archetype"
