"""Checkpoints of the port's ``Exec`` (``state_at``, ``restore`` with
``History.truncate``, ``save_checkpoint`` / ``load_checkpoint``) and
``verify.checkpoint_first_tick``, against the JAX package's behaviour, on
the CPU; and u32 columns across the numpy boundary.

Stated tolerance: bitwise everywhere (a restored run replays the same
ops on the same state), but for ``checkpoint_first_tick``'s tick against
the JAX package's jitted one, ≤ 1e-15 relative.
"""

import json

import numpy as np
import pytest
import torch

import elodin_tpu_torch as tel
from elodin_tpu_torch import verify
from elodin_tpu_torch.examples.ball import sim as tball
from elodin_tpu_torch.examples.stablehlo import sim as tprobe
from elodin_tpu_torch.execimpl import History
from elodin_tpu_torch.interop import columns_from_numpy, columns_to_numpy
from torch_port_util import jax_example


def _ball(**kw):
    return tball.world(seed=3).build(tball.system(), device="cpu", **kw)


def _cols(exec_):
    return {k: v.clone() for k, v in exec_.cols.items()}


def _equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_restore_and_resume_replays_bitwise():
    """The JAX package's ``test_checkpoint_restore_and_resume`` on the ball
    (threefry wind, RK4): restore(10) rewinds and cuts the history, and 10
    more ticks give the first run's state at tick 20, every column."""
    exec_ = _ball()
    exec_.run(20)
    first = _cols(exec_)
    x20 = exec_.history("ball.world_pos")["ball.world_pos"][-1].copy()
    exec_.restore(10)
    assert exec_.tick() == 10 and int(exec_.column_array("tick")[0]) == 10
    assert len(exec_.history("ball.world_pos")) == 11
    exec_.run(10)
    df = exec_.history("ball.world_pos")
    assert len(df) == 21
    np.testing.assert_array_equal(df["ball.world_pos"][-1], x20)
    assert _equal(first, exec_.cols)


def test_restore_follows_the_recorded_time_with_a_telemetry_stride():
    exec_ = _ball(telemetry_rate=40.0)  # a row every 3 ticks
    exec_.run(30)
    first = _cols(exec_)
    exec_.flush_telemetry()
    assert len(exec_._history.times) == 11
    exec_.restore(4)  # row 4 is tick 12
    assert exec_.tick() == 12 and len(exec_._history.times) == 5
    exec_.run(18)
    assert _equal(first, exec_.cols)


def test_state_at():
    exec_ = tprobe.build_world().build(tprobe.build_system(), device="cpu")
    exec_.run(5)
    s0, s5 = exec_.state_at(0), exec_.state_at(5)
    assert sorted(s0) == sorted(exec_.meta.components)
    np.testing.assert_array_equal(s0["hlo_bits"], np.arange(4, dtype=np.uint32)[None])
    assert s5["hlo_bits"].dtype == np.uint32 and int(s5["tick"][0]) == 5
    for k, v in columns_to_numpy(exec_.cols, exec_.meta).items():
        np.testing.assert_array_equal(s5[k], v)
    with pytest.raises(IndexError):
        exec_.state_at(6)
    exec_.record_history = False
    with pytest.raises(RuntimeError):
        exec_.state_at(0)


def test_truncate_cuts_spilled_and_live_chunks(tmp_path):
    """Rows 0..N-1 carry their own index; after truncate(k) every
    component holds exactly rows 0..k-1, wherever the cut falls: inside a
    spilled chunk, at a chunk edge, in the live chunks, past the end."""
    exec_ = tprobe.build_world().build(tprobe.build_system(), device="cpu")
    meta = exec_.meta
    for keep in (0, 1, 5, 8, 9, 13, 20, 25):
        h = History(meta, spool_dir=str(tmp_path / f"spool{keep}"), max_bytes=1000)
        for i in range(20):
            h.append_state(float(i), {k: np.full((1,) + meta.components[k].ty.shape, i,
                                                 dtype=meta.components[k].ty.dtype)
                                      for k in meta.components})
        assert h._spills["hlo_vec"], "the history did not spill"
        h.truncate(keep)
        n = min(keep, 20)
        assert h.times == [float(i) for i in range(n)]
        for k in meta.components:
            series = h.series(k) if n else np.zeros(0)
            assert len(series) == n
            if n:
                np.testing.assert_array_equal(series.reshape(n, -1)[:, 0], np.arange(n))
        # appending after the cut continues the series
        h.append_state(99.0, {k: np.zeros((1,) + meta.components[k].ty.shape,
                                          dtype=meta.components[k].ty.dtype)
                              for k in meta.components})
        assert len(h.series("hlo_vec")) == n + 1


def test_restore_through_a_spilled_history(tmp_path):
    exec_ = _ball()
    exec_._history = History(exec_.meta, spool_dir=str(tmp_path), max_bytes=2000)
    exec_._history.append_state(0.0, columns_to_numpy(exec_.cols, exec_.meta))
    exec_.run(40)
    first = _cols(exec_)
    exec_.flush_telemetry()
    assert len(exec_._history._spills["world_pos"]) >= 2
    exec_.restore(17)
    assert len(exec_._history.series("world_pos")) == 18
    exec_.run(23)
    assert _equal(first, exec_.cols)
    exec_.flush_telemetry()
    assert len(exec_._history.series("world_pos")) == 41


def test_npz_checkpoint_round_trip(tmp_path):
    """The JAX package's ``test_npz_checkpoint``, on every column: the file
    holds each column at its host dtype (u64 and u32 unsigned)."""
    exec_ = tprobe.build_world().build(tprobe.build_system(), device="cpu")
    exec_.run(5)
    path = tmp_path / "state.npz"
    exec_.save_checkpoint(path)
    saved = _cols(exec_)
    exec_.run(5)
    assert not _equal(saved, exec_.cols)
    exec_.load_checkpoint(path)
    assert _equal(saved, exec_.cols)
    with np.load(path) as data:
        assert data["tick"].dtype == np.uint64 and data["hlo_bits"].dtype == np.uint32


def test_npz_checkpoints_cross_between_packages(tmp_path):
    """A checkpoint the JAX package writes loads into the port, and the
    port's loads into the JAX package, to the same columns."""
    jmod = jax_example("stablehlo", "sim")
    jexec = jmod.world().build(jmod.system())
    jexec.run(7)
    jexec.save_checkpoint(str(tmp_path / "jax.npz"))
    exec_ = tprobe.build_world().build(tprobe.build_system(), device="cpu")
    exec_.load_checkpoint(tmp_path / "jax.npz")
    for k, v in jexec.cols.items():
        np.testing.assert_array_equal(exec_.column_array(k), np.asarray(v), err_msg=k)
    exec_.run(3)
    exec_.save_checkpoint(tmp_path / "port.npz")
    jexec.run(3)
    ours = {k: np.asarray(v) for k, v in jexec.cols.items()}
    jexec.load_checkpoint(str(tmp_path / "port.npz"))
    for k, v in jexec.cols.items():
        assert np.asarray(v).dtype == ours[k].dtype
        np.testing.assert_array_equal(np.asarray(v), exec_.column_array(k), err_msg=k)


def test_checkpoint_first_tick(tmp_path, monkeypatch):
    """The JAX package's ``test_checkpoint_first_tick``, and its files
    against the JAX package's from the same world."""
    import elodin as el

    monkeypatch.delenv(verify.DEBUG_DIR_ENV, raising=False)
    w = tel.World()
    w.spawn(tel.Body(world_vel=tel.SpatialMotion(linear=torch.tensor([1.0, 0, 0]))), "b")
    exec_ = w.build(tel.six_dof(1.0 / 120.0), device="cpu")
    assert verify.checkpoint_first_tick(exec_) is None
    monkeypatch.setenv(verify.DEBUG_DIR_ENV, str(tmp_path / "dbg"))
    out = verify.checkpoint_first_tick(exec_)
    assert out == str(tmp_path / "dbg")
    assert exec_.tick() == 0 and int(exec_.column_array("tick")[0]) == 0
    inputs = np.load(tmp_path / "dbg" / "tick0_inputs.npz")
    outputs = np.load(tmp_path / "dbg" / "tick1_outputs.npz")
    assert "world_pos" in inputs and outputs["tick"][0] == 1
    manifest = json.loads((tmp_path / "dbg" / "manifest.json").read_text())
    assert manifest["components"] == sorted(exec_.meta.components)
    assert manifest["shapes"]["world_pos"] == [1, 7]

    from elodin_tpu.verify import checkpoint_first_tick as jax_checkpoint_first_tick

    jw = el.World()
    jw.spawn(el.Body(world_vel=el.SpatialMotion(linear=np.array([1.0, 0, 0]))), "b")
    monkeypatch.setenv(verify.DEBUG_DIR_ENV, str(tmp_path / "jax"))
    jax_checkpoint_first_tick(jw.build(el.six_dof(1.0 / 120.0)))
    ref = np.load(tmp_path / "jax" / "tick1_outputs.npz")
    assert sorted(ref.files) == sorted(outputs.files)
    for k in ref.files:
        assert outputs[k].dtype == ref[k].dtype
        scale = max(1.0, float(np.abs(ref[k]).max()))
        assert np.abs(outputs[k].astype(np.float64) - ref[k]).max() <= 1e-15 * scale, k


def test_u32_columns_round_trip_and_refuse_out_of_range():
    meta, cols = tprobe.build_world().snapshot()
    assert cols["hlo_bits"].dtype == np.uint32
    cols["hlo_bits"] = np.array([[0, 1, 2**31, 2**32 - 1]], dtype=np.uint32)
    dev = columns_from_numpy(cols, meta, "cpu")
    assert dev["hlo_bits"].dtype == torch.int64
    assert dev["hlo_bits"].tolist() == [[0, 1, 2**31, 2**32 - 1]]
    back = columns_to_numpy(dev, meta)
    assert back["hlo_bits"].dtype == np.uint32
    np.testing.assert_array_equal(back["hlo_bits"], cols["hlo_bits"])
    for bad in (2**32, 2**40, -1):
        with pytest.raises(ValueError, match="out of range"):
            columns_to_numpy({"hlo_bits": torch.tensor([[0, 1, 2, bad]])}, meta)
    wrong = dict(cols, hlo_bits=cols["hlo_bits"].astype(np.int64))
    with pytest.raises(ValueError, match="dtype"):
        columns_from_numpy(wrong, meta, "cpu")
