"""The port's n-body model against the JAX package's.

Both packages build ``build_nbody`` from the same seed; the port starts
from the JAX package's own initial columns (``interop.columns_from_numpy``)
and both run ``World.build`` → ``Exec.run``.  The kernel path
(``use_kernel=True``: the plain version of all-pairs gravity on the CPU)
and the edge-fold path (``GraphQuery[TotalEdge]``) are each held to the
JAX package's same path.  Stated tolerances, max |Δ| / max |ref| on
world_pos, world_vel, world_accel and force, each channel group against
its own scale:

* f64   ≤ 1e-12: the same operations in IEEE f64; sums over bodies run in
  another order (and the port's edge fold is a dense sum where the JAX
  package folds sequentially);
* f32   ≤ 1e-4: f32 rounding compounds over the ticks;
* mixed ≤ 1e-6: gravity computes in f32 in both packages, the integrator
  state stays f64.
"""

import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import elodin_tpu as jel
import elodin_tpu_torch as tel
from elodin_tpu.models import nbody as jnb
from elodin_tpu.ops.pairwise import pairwise_gravity_reference as j_pairwise
from elodin_tpu.six_dof import increment_sim_tick_system as j_tick
from elodin_tpu.system import GraphQuery as JGraphQuery
from elodin_tpu.system import Pipe as JPipe
from elodin_tpu.system import SystemBuilder as JSystemBuilder
from elodin_tpu.system import as_system as j_as_system
from elodin_tpu_torch import interop
from elodin_tpu_torch.models import nbody as tnb
from elodin_tpu_torch.ops import pairwise as pw
from elodin_tpu_torch.system import TOTAL_FOLDS
from elodin_tpu_torch.system import GraphQuery as TGraphQuery
from elodin_tpu_torch.system import build_step
from torch_port_util import float_policy, rel_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, TICKS, DT = 192, 20, 60.0
TOL = {"f64": 1e-12, "f32": 1e-4, "mixed": 1e-6}
COMPARED = ("world_pos", "world_vel", "world_accel", "force")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_build_nbody_snapshot_matches_jax(dtype):
    with float_policy("f64"):
        jmeta, jcols = jnb.build_nbody(N, seed=4, dtype=dtype).snapshot()
        tmeta, tcols = tnb.build_nbody(N, seed=4, dtype=dtype).snapshot()
    assert tmeta.comp_entities == jmeta.comp_entities
    assert tmeta.entity_names == jmeta.entity_names
    assert tcols.keys() == jcols.keys()
    for name, ref in jcols.items():
        assert tcols[name].dtype == ref.dtype, name
        np.testing.assert_array_equal(tcols[name], ref)


@functools.cache
def _run_pair(policy: str, use_kernel: bool):
    """(JAX exec, port exec, port launches, port fold paths) after TICKS
    ticks of one path."""
    with float_policy(policy):
        jexec = jnb.build_nbody(N, seed=0).build(
            jnb.build_system(DT, use_kernel=use_kernel), simulation_rate=1.0 / DT)
        texec = tnb.build_nbody(N, seed=0).build(
            tnb.build_system(DT, use_kernel=use_kernel), simulation_rate=1.0 / DT,
            device="cpu")
        jinit = {k: jexec.column_array(k) for k in jexec.meta.components}
        texec.cols = interop.columns_from_numpy(jinit, texec.meta, "cpu")
        launches, folds = pw.LAUNCHES, dict(TOTAL_FOLDS)
        jexec.run(TICKS)
        texec.run(TICKS)
        folds = {k: TOTAL_FOLDS[k] - folds[k] for k in folds}
        return jexec, texec, pw.LAUNCHES - launches, folds


@pytest.mark.parametrize("path", ["kernel", "edge_fold"])
@pytest.mark.parametrize("policy", ["f64", "f32", "mixed"])
def test_exec_run_matches_jax(policy, path):
    jexec, texec, launches, folds = _run_pair(policy, path == "kernel")
    ours = interop.columns_to_numpy(texec.cols, texec.meta)
    assert texec.tick() == jexec.tick() == TICKS
    np.testing.assert_array_equal(ours["tick"], jexec.column_array("tick"))
    assert launches == 0  # CPU tensors take the plain version
    expect_dense = 0 if path == "kernel" else TICKS
    assert folds == {"dense": expect_dense, "sequential": 0, "probes": 0}
    for name in COMPARED:
        ref = jexec.column_array(name)
        assert ours[name].dtype == ref.dtype, name
        assert np.isfinite(ours[name]).all(), name
        err = rel_err(ours[name], ref)
        assert err <= TOL[policy], (name, err)


def test_edge_fold_chunks_and_padding():
    """1100 bodies: two chunks of DENSE_FOLD_CHUNK = 1024 right-hand
    entities, the second padded, in one tick, against the JAX package's
    edge-fold tick and against the JAX plain all-pairs sum (f64 ≤ 1e-12)."""
    n = 1100
    with float_policy("f64"):
        jw = jnb.build_nbody(n, seed=5)
        jw.set_sim_time_step(DT)
        jmeta, jcols = jw.snapshot()
        jfull = JPipe(j_tick, j_as_system(jnb.build_system(DT, use_kernel=False)))

        def jstep(state):
            b = JSystemBuilder(jmeta, dict(state))
            jfull.call(b)
            return b.cols

        jout = jax.jit(jstep)({k: jax.numpy.asarray(v) for k, v in jcols.items()})
        tw = tnb.build_nbody(n, seed=5)
        tw.set_sim_time_step(DT)
        tmeta, tcols = tw.snapshot()
        dense = TOTAL_FOLDS["dense"]
        tout = build_step(tmeta, tnb.build_system(DT, use_kernel=False))(
            interop.columns_from_numpy(tcols, tmeta, "cpu"))
    assert TOTAL_FOLDS["dense"] == dense + 1
    force = tout["force"].numpy()
    assert np.isfinite(force).all()
    assert rel_err(force, np.asarray(jout["force"])) <= 1e-12
    mass = jcols["inertia"][:, 6]
    expect = np.asarray(j_pairwise(jcols["world_pos"][:, 4:], mass, g=jnb.G)) * mass[:, None]
    assert rel_err(force[:, 3:], expect) <= 1e-12


def _load_example():
    path = os.path.join(REPO, "examples", "n-body", "main.py")
    spec = importlib.util.spec_from_file_location("n_body_main_for_port", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_example(el):
    """``examples/n-body/main.py``'s world and system, written in torch."""
    AU, M_SUN, M_EARTH, G = 1.496e11, 1.989e30, 5.972e24, 6.6743e-11

    def vec(*x):
        return torch.tensor(x, dtype=torch.float64)

    def build_world(n_asteroids, seed):
        w = el.World()
        rng = np.random.default_rng(seed)
        w.spawn(el.Body(inertia=el.Inertia(M_SUN)), name="sun")
        v_earth = np.sqrt(G * M_SUN / AU)
        w.spawn(el.Body(world_pos=el.WorldPos(linear=vec(AU, 0.0, 0.0)),
                        world_vel=el.WorldVel(linear=vec(0.0, v_earth, 0.0)),
                        inertia=el.Inertia(M_EARTH)), name="earth")
        for i in range(n_asteroids):
            r = rng.uniform(2.0, 3.5) * AU
            theta = rng.uniform(0, 2 * np.pi)
            v = np.sqrt(G * M_SUN / r)
            w.spawn(el.Body(
                world_pos=el.WorldPos(linear=vec(r * np.cos(theta), r * np.sin(theta), 0.0)),
                world_vel=el.WorldVel(linear=vec(-v * np.sin(theta), v * np.cos(theta), 0.0)),
                inertia=el.Inertia(rng.uniform(1e15, 1e20))), name=f"asteroid{i}")
        return w

    @el.system
    def gravity(graph: el.GraphQuery[el.TotalEdge],
                query: el.Query[el.WorldPos, el.Inertia]) -> el.Query[el.Force]:
        def gravity_fn(force, a_pos, a_inertia, b_pos, b_inertia):
            r = a_pos.linear() - b_pos.linear()
            norm = torch.linalg.norm(r)
            f = (G * a_inertia.mass()) * ((b_inertia.mass() / norm**3) * r)
            return el.Force(linear=force.force() - f)

        return graph.edge_fold(query, query, el.Force, el.Force(), gravity_fn)

    return build_world, el.six_dof(sys=gravity, integrator=el.Integrator.SemiImplicit)


def test_example_world_matches_jax():
    """4 asteroids x 500 ticks, as ``tests/test_examples.py`` runs the
    example; the example's fold is not additive in the carry (it drops the
    torque), so both packages fold sequentially, and the port probes it
    once."""
    mod = _load_example()
    build_world, system = _port_example(tel)
    with float_policy("f64"):
        jexec = mod.build_world(n_asteroids=4, seed=1).build(
            mod.build_system(), simulation_rate=1.0 / mod.SIM_TIME_STEP)
        texec = build_world(4, 1).build(system, simulation_rate=1.0 / mod.SIM_TIME_STEP,
                                        device="cpu")
        jinit = {k: jexec.column_array(k) for k in jexec.meta.components}
        ours_init = interop.columns_to_numpy(texec.cols, texec.meta)
        for name, ref in jinit.items():
            np.testing.assert_array_equal(ours_init[name], ref)
        folds = dict(TOTAL_FOLDS)
        jexec.run(500)
        texec.run(500)
    assert TOTAL_FOLDS["sequential"] - folds["sequential"] == 500
    assert TOTAL_FOLDS["dense"] == folds["dense"]
    assert TOTAL_FOLDS["probes"] - folds["probes"] == 1  # once, not per tick
    ours = interop.columns_to_numpy(texec.cols, texec.meta)
    for name in ("world_pos", "world_vel"):
        assert rel_err(ours[name], jexec.column_array(name)) <= 1e-12, name
    earth = texec.history("earth.world_pos")["earth.world_pos"]
    r0, r1 = np.asarray(earth[0])[4:], np.asarray(earth[-1])[4:]
    assert np.linalg.norm(r1 - r0) > 1e8
    np.testing.assert_allclose(np.linalg.norm(r1), np.linalg.norm(r0), rtol=1e-4)


def _probe(gq_cls, el, fold, comps, init):
    """The additive probe of one package over a fake 3-entity query of
    ``comps`` (component aliases with their column widths)."""
    class FakeQuery:
        batch1 = False

        def __init__(self, bufs):
            self.component_classes = [c for c, _ in comps]
            self.bufs = bufs

    def bufs(zeros):
        return [zeros((3, w)) for _, w in comps]

    arr = (lambda s: torch.zeros(s, dtype=torch.float64)) if el is tel else jax.numpy.zeros
    return gq_cls.__new__(gq_cls)._fold_is_additive(
        FakeQuery(bufs(arr)), FakeQuery(bufs(arr)), init(), fold)


def test_probe_classifies_folds_as_jax_does():
    """The n-body fold (it drops the carry's torque) and a max-style fold
    are not additive; a plain force sum is.  Both packages agree."""
    def nbody_fold(el, norm):
        def fold(force, a_pos, a_inertia, b_pos, b_inertia):
            r = a_pos.linear() - b_pos.linear()
            f = (tnb.G * a_inertia.mass()) * ((b_inertia.mass() / norm(r)**3) * r)
            return el.Force(linear=force.force() - f)
        return fold

    def sum_fold(force, a_pos, a_inertia, b_pos, b_inertia):
        return force + type(force).from_array(a_pos.inner[..., 1:] - b_pos.inner[..., 1:])

    def max_fold(maximum):
        return lambda force, a_pos, a_inertia, b_pos, b_inertia: type(force).from_array(
            maximum(force.inner, b_pos.inner[..., 1:]))

    verdicts = {}
    for el, gq, norm, maximum in (
        (jel, JGraphQuery, jax.numpy.linalg.norm, jax.numpy.maximum),
        (tel, TGraphQuery, torch.linalg.norm, torch.maximum),
    ):
        comps = [(el.WorldPos, 7), (el.Inertia, 7)]
        with float_policy("f64"):
            verdicts[el.__name__] = [
                _probe(gq, el, f, comps, el.Force)
                for f in (nbody_fold(el, norm), sum_fold, max_fold(maximum))]
    assert verdicts["elodin_tpu"] == verdicts["elodin_tpu_torch"] == [False, True, False]
