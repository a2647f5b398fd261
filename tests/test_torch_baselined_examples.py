"""The port's ball, linalg and stablehlo examples, ``el.linalg`` and the LU
of ``ops.smallalg`` against the JAX package's, on the CPU in f64.

Stated tolerances:

* Each example through ``Exec``, 240 ticks at 120 Hz, against the JAX
  example from the same world: every f64 column to max |Δ|/(1+|x|) ≤
  1e-10, ``hlo_bits`` (u32) and the tick exactly, ``hlo_scalar`` ≤ 1e-6
  (an f32 sum, whose reduction order may differ by an f32 ulp).
* ``regress.check(example, device="cpu")``: every column of
  ``scripts/baseline/<example>``, vector cells parsed, abs or rel 1e-4.
* ``el.linalg`` and the unrolled LU on seeded random matrices, batched
  and under ``vmap``: ≤ 1e-12 relative to the matrix's scale; a singular
  matrix's determinant exactly 0 from the LU, as in JAX.
* One call of every ball, linalg and stablehlo system from a shared
  state, against the JAX system: ≤ 1e-13 (the probe's ``convert_step``
  ≤ 1e-6, its f32 sum); the probe over 14 entities under ``vmap``, where
  the closed-form ``while_loop`` equals JAX's loop exactly, also at powers
  of two, and the bitwise step on random u32 words is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elodin_tpu_torch as tel
from elodin_tpu import linalg as jlinalg
from elodin_tpu.ops import smallalg as jsmallalg
from elodin_tpu_torch import linalg as tlinalg
from elodin_tpu_torch import regress
from elodin_tpu_torch.examples.ball import sim as tball
from elodin_tpu_torch.examples.linalg import main as tlinalg_ex
from elodin_tpu_torch.examples.stablehlo import sim as tprobe
from elodin_tpu_torch.ops import smallalg as tsmallalg
from torch_port_util import call_once, jax_example, mixed_errs

TICKS = 240
EXAMPLES = {
    "ball": (tball, ("ball", "sim")),
    "linalg": (tlinalg_ex, ("linalg", "main")),
    "stablehlo": (tprobe, ("stablehlo", "sim")),
}


def _jax_world_and_system(mod):
    world = mod.build_world() if hasattr(mod, "build_world") else mod.world()
    system = mod.build_system() if hasattr(mod, "build_system") else mod.system()
    return world, system


@pytest.fixture(scope="module")
def runs():
    """Both packages' final columns after TICKS ticks of each example."""
    out = {}
    for name, (port, (ex, sub)) in EXAMPLES.items():
        jmod = jax_example(ex, sub)
        rate = 1.0 / getattr(jmod, "SIM_TIME_STEP", 1.0 / 120.0)
        world, system = _jax_world_and_system(jmod)
        jexec = world.build(system, simulation_rate=rate)
        jexec.run(TICKS)
        texec = port.build_world().build(port.build_system(), simulation_rate=rate,
                                         device="cpu")
        texec.run(TICKS)
        out[name] = ({k: np.asarray(v) for k, v in jexec.cols.items()},
                     {k: texec.column_array(k) for k in texec.meta.components}, texec)
    return out


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_through_exec_matches_jax(runs, name):
    ref, ours, texec = runs[name]
    assert sorted(ours) == sorted(ref)
    assert texec.tick() == TICKS
    for k, r in ref.items():
        assert ours[k].dtype == r.dtype, k
    scalar = ref.pop("hlo_scalar", None)
    errs = mixed_errs(ours, ref)  # integer columns (tick, seed, hlo_bits) exactly
    assert max(errs.values()) <= 1e-10, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    if scalar is not None:
        assert np.abs(ours["hlo_scalar"] - scalar).max() / (1 + np.abs(scalar).max()) <= 1e-6


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_snapshots_equal_jax(name):
    """Names, dtypes and values of every column; bitwise, but for two
    columns the JAX examples form in XLA and the port in numpy, which differ
    by up to 2 ulps: the linalg seed ``a @ a.T`` and the probe's
    ``linspace``."""
    port, (ex, sub) = EXAMPLES[name]
    jcols = _jax_world_and_system(jax_example(ex, sub))[0].snapshot()[1]
    tcols = port.build_world().snapshot()[1]
    assert sorted(jcols) == sorted(tcols)
    for k in jcols:
        ref = np.asarray(jcols[k])
        assert tcols[k].dtype == ref.dtype
        if k in ("mat_a", "hlo_vec"):
            assert (np.abs(tcols[k] - ref) <= 2 * np.spacing(np.abs(ref))).all()
        else:
            np.testing.assert_array_equal(tcols[k], ref, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_csv_gate_against_scripts_baseline(name):
    exec_, _, n, worst = regress.check(name, device="cpu")
    assert exec_.tick() == regress.TICKS
    assert n == {"ball": 9, "linalg": 10, "stablehlo": 6}[name] and worst <= 1.0
    assert regress.baseline_dir(name).endswith(f"scripts/baseline/{name}")
    assert name not in regress.REEXPORTED


def test_regress_gates_all_seven_examples():
    assert regress.EXAMPLES == ("ball", "three-body", "stablehlo", "drone", "linalg",
                                "rocket", "cube-sat")
    assert set(regress.baselined_examples()) == set(regress.EXAMPLES)


def test_ball_systems_match_jax():
    """One call of each ball system from a shared state, with the ball
    below ground and moving down, so ``bounce`` takes its other branch."""
    jmod = jax_example("ball", "sim")
    jw, tw = jmod.world(seed=5), tball.world(seed=5)
    jmeta, cols = jw.snapshot()
    tmeta, _ = tw.snapshot()
    cols = {k: np.array(v) for k, v in cols.items()}
    cols["world_pos"][0, 6] = -0.1
    cols["world_vel"][0, 3:] = [0.3, -0.2, -2.0]
    cols["world_vel"][0, :3] = [0.1, 0.2, 0.3]
    for jsys, tsys in ((jmod.sample_wind, tball.sample_wind), (jmod.bounce, tball.bounce),
                       (jmod.gravity, tball.gravity), (jmod.apply_drag, tball.apply_drag)):
        jout, tout = call_once(jsys, tsys, jmeta, tmeta, cols)
        errs = mixed_errs(tout, jout)
        assert max(errs.values()) <= 1e-15, errs
    # the bounce kept the linear part, flipped z and dropped the angular part
    _, tout = call_once(jmod.bounce, tball.bounce, jmeta, tmeta, cols)
    np.testing.assert_allclose(tout["world_vel"][0], [0, 0, 0, 0.3 * 0.85, -0.2 * 0.85, 1.7])


def test_ball_wind_under_vmap():
    """Two balls: the seed column is mapped under vmap, one draw each."""
    w = tel.World()
    for s in (0, 2**32 + 7):
        w.spawn([tel.Body(), tball.WindData(seed=np.int64(s))], name=f"b{s}")
    exec_ = w.build(tball.system(), device="cpu")
    exec_.run(1)
    jw = jax_example("ball", "sim")
    import elodin as el

    jworld = el.World()
    for s in (0, 2**32 + 7):
        jworld.spawn([el.Body(), jw.WindData(seed=jnp.int64(s))], name=f"b{s}")
    jexec = jworld.build(jw.system())
    jexec.run(1)
    ref = np.asarray(jexec.cols["wind"])
    ours = exec_.column_array("wind")
    assert (np.abs(ours - ref) <= 4 * np.spacing(np.abs(ref))).all()


@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_linalg_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.normal(size=(5, n, n)) + 2 * np.eye(n)
    b_vec, b_mat = rng.normal(size=n), rng.normal(size=(5, n, 2))
    ta, scale = torch.tensor(a), np.abs(a).max()
    for ours, ref in (
        (tlinalg.inv(ta), jlinalg.inv(a)),
        (tlinalg.solve(ta, torch.tensor(b_vec)), jlinalg.solve(a, b_vec)),
        (tlinalg.solve(ta, torch.tensor(b_mat)), jlinalg.solve(a, b_mat)),
        (tlinalg.det(ta), jlinalg.det(a)),
    ):
        ref = np.asarray(ref)
        assert ours.shape == ref.shape
        assert np.abs(ours.numpy() - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max()) * scale


@pytest.mark.parametrize("n", [2, 4, 6])
def test_unrolled_lu_matches_jax(n):
    rng = np.random.default_rng(10 + n)
    a = rng.normal(size=(3, n, n))
    lu, perm, sign = tsmallalg.lu_factor(torch.tensor(a))
    jlu, jperm, jsign = jsmallalg.lu_factor(jnp.asarray(a))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    assert np.abs(lu.numpy() - np.asarray(jlu)).max() <= 1e-13
    b = rng.normal(size=(3, n, 2))
    x = tlinalg.lu_solve(lu, perm, torch.tensor(b)).numpy()
    assert np.abs(x - np.asarray(jsmallalg.lu_solve(jlu, jperm, b))).max() <= 1e-12
    np.testing.assert_allclose(np.einsum("...ij,...jk->...ik", a, x), b, atol=1e-10)
    det = tlinalg.lu_det(lu, sign).numpy()
    np.testing.assert_allclose(det, np.asarray(jsmallalg.lu_det(jlu, jsign)), rtol=1e-13)
    # the port's LU under vmap equals the batched call
    vlu, vperm, vsign = torch.func.vmap(tsmallalg.lu_factor)(torch.tensor(a))
    assert torch.equal(vlu, lu) and torch.equal(vperm, perm) and torch.equal(vsign, sign)


def test_lu_of_a_singular_matrix_has_zero_determinant():
    a = np.array([[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [1.0, 0.0, 1.0]])
    lu, perm, sign = tlinalg.lu_factor(torch.tensor(a))
    assert torch.isfinite(lu).all()
    assert float(tlinalg.lu_det(lu, sign)) == float(jsmallalg.lu_det(
        *[jsmallalg.lu_factor(jnp.asarray(a))[i] for i in (0, 2)])) == 0.0


def test_linalg_example_systems_match_jax():
    jmod = jax_example("linalg", "main")
    jmeta, cols = jmod.build_world().snapshot()
    tmeta, _ = tlinalg_ex.build_world().snapshot()
    cols = {k: np.asarray(v) for k, v in cols.items()}
    for jsys, tsys in ((jmod.rotate_matrix, tlinalg_ex.rotate_matrix),
                       (jmod.decompose, tlinalg_ex.decompose)):
        jout, tout = call_once(jsys, tsys, jmeta, tmeta, cols)
        errs = mixed_errs(tout, jout)
        assert max(errs.values()) <= 1e-13, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def _probes(scalars, bits):
    """A probe world of one entity per scalar (and row of bits) in each
    package: (JAX meta, port meta, the numpy columns)."""
    import elodin as el

    jmod = jax_example("stablehlo", "sim")
    jw, tw = el.World(), tel.World()
    for i, (s, b) in enumerate(zip(scalars, bits)):
        vec, mat = np.linspace(-1.0, 1.0, 8) * (i + 1) / 7, np.eye(3) + 0.1 * i
        jw.spawn(jmod.Probe(hlo_vec=jnp.asarray(vec), hlo_mat=jnp.asarray(mat),
                            hlo_bits=jnp.asarray(b, dtype=jnp.uint32),
                            hlo_scalar=jnp.float64(s)), name=f"p{i}")
        tw.spawn(tprobe.Probe(hlo_vec=vec, hlo_mat=mat, hlo_bits=np.asarray(b, dtype=np.uint32),
                              hlo_scalar=np.float64(s)), name=f"p{i}")
    jmeta, cols = jw.snapshot()
    return jmod, jmeta, tw.snapshot()[0], {k: np.asarray(v) for k, v in cols.items()}


def test_probe_systems_match_jax_under_vmap():
    """Every probe system over 14 entities (the port maps them under vmap).
    The halving while_loop from |s| + 2, in closed form, is the loop's value
    exactly, also where |s| + 2 is a power of two (the loop ends at exactly
    1); the bitwise step on random u32 words is exact."""
    scalars = [0.0, 0.5, -0.5, 1.0, 2.0, -2.0, 6.0, 14.0, 1e-300, 3.7, -123.25,
               2.0**40 - 2, 1e12, -7.999999999999999]
    bits = np.random.default_rng(0).integers(0, 2**32, size=(len(scalars), 4), dtype=np.uint64)
    jmod, jmeta, tmeta, cols = _probes(scalars, bits)
    for name in ("math_step", "sort_step", "shape_step", "control_step", "bitwise_step",
                 "linalg_step", "convert_step"):
        jout, tout = call_once(getattr(jmod, name), getattr(tprobe, name), jmeta, tmeta, cols)
        if name == "control_step":
            np.testing.assert_array_equal(tout["hlo_scalar"], jout["hlo_scalar"])
        elif name == "bitwise_step":
            assert tout["hlo_bits"].dtype == np.uint32
            np.testing.assert_array_equal(tout["hlo_bits"], jout["hlo_bits"])
        else:
            errs = mixed_errs(tout, jout)
            tol = 1e-6 if name == "convert_step" else 1e-14
            assert max(errs.values()) <= tol, (name, errs)
