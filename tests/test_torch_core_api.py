"""The rest of the port's core API against the JAX package: ``MRP``,
``Quaternion.mrp`` / ``SpatialTransform.mrp``, ``SpatialMotion.cross`` /
``cross_dual`` / ``offset``, ``asarray``, ``el.skew``, ``el.Camera``,
``el.ShapeIndexer`` and the world's editor hooks.

The same seeded numpy inputs go through both packages in f64; each result
is held to the JAX function's at max |Δ| / max |ref| ≤ 1e-12, on a batch
axis and, for the port, under ``torch.func.vmap`` over that axis.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elodin_tpu as jel
import elodin_tpu_torch as tel
from torch_port_util import float_policy, rel_err

TOL = 1e-12
N = 64


def _rng(seed: int = 0):
    return np.random.default_rng(seed)


def _quats(rng, n=N):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[:, 3] = np.abs(q[:, 3])  # away from w = -1, where the MRP is singular
    return q


def _transforms(rng, n=N):
    return np.concatenate([_quats(rng, n), rng.normal(scale=5.0, size=(n, 3))], axis=-1)


def _t(x):
    return torch.as_tensor(x, dtype=torch.float64)


def _hold(ours, ref):
    # a spatial value's array (``torch.Tensor.inner`` is a method)
    ours = ours if isinstance(ours, torch.Tensor) else ours.inner
    ref = ref.inner if isinstance(ref, (jel.MRP, jel.Quaternion, jel.SpatialMotion,
                                        jel.SpatialForce)) else ref
    assert tuple(ours.shape) == tuple(np.shape(ref))
    assert rel_err(ours, np.asarray(ref)) <= TOL


def test_skew_matches_jax():
    """``tests/test_core.py:284``'s case, then 64 seeded vectors batched and
    one at a time under vmap."""
    arr = np.array([1.0, 2.0, 3.0])
    expect = np.array([[0.0, -3.0, 2.0], [3.0, 0.0, -1.0], [-2.0, 1.0, 0.0]])
    ours = tel.skew(arr)
    assert ours.dtype == torch.float64
    np.testing.assert_array_equal(ours.numpy(), expect)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jel.skew(arr)))
    v = _rng(1).normal(size=(N, 3))
    ref = np.asarray(jel.skew(v))
    _hold(tel.skew(v), ref)
    _hold(tel.skew(_t(v)), ref)
    _hold(torch.func.vmap(tel.skew)(_t(v)), ref)


@pytest.mark.parametrize("batched", [True, False], ids=["batch_axis", "vmap"])
def test_mrp_matches_jax(batched):
    rng = _rng(2)
    q, m, m2 = _quats(rng), rng.normal(scale=0.4, size=(N, 3)), rng.normal(size=(N, 3))
    stf = _transforms(rng)

    def port(fn, *args):
        args = [_t(a) for a in args]
        return fn(*args) if batched else torch.func.vmap(fn)(*args)

    with float_policy("f64"):
        cases = {
            "from_quaternion": (
                port(lambda x: tel.MRP.from_quaternion(tel.Quaternion.from_array(x)).inner, q),
                jel.MRP.from_quaternion(jel.Quaternion.from_array(q))),
            "from_quaternion(array)": (
                port(lambda x: tel.MRP.from_quaternion(x).inner, q),
                jel.MRP.from_quaternion(jnp.asarray(q))),
            "to_quaternion": (
                port(lambda x: tel.MRP.from_array(x).to_quaternion().inner, m),
                jel.MRP.from_array(m).to_quaternion()),
            "add": (
                port(lambda a, b: (tel.MRP.from_array(a) + tel.MRP.from_array(b)).inner, m, m2),
                jel.MRP.from_array(m) + jel.MRP.from_array(m2)),
            "Quaternion.mrp": (
                port(lambda x: tel.Quaternion.from_array(x).mrp().inner, q),
                jel.Quaternion.from_array(q).mrp()),
            "SpatialTransform.mrp": (
                port(lambda x: tel.SpatialTransform.from_array(x).mrp().inner, stf),
                jel.SpatialTransform.from_array(stf).mrp()),
        }
    for name, (ours, ref) in cases.items():
        assert isinstance(ref, jel.MRP) or name in ("to_quaternion",), name
        _hold(ours, ref)
    # the round trip returns the unit quaternion it started from
    back = tel.MRP.from_quaternion(tel.Quaternion.from_array(_t(q))).to_quaternion()
    np.testing.assert_allclose(back.inner.numpy(), q, atol=1e-14)


def test_mrp_defaults_and_metadata_match_jax():
    with float_policy("f64"):
        ours, ref = tel.MRP(), jel.MRP()
        assert ours.inner.dtype == torch.float64
        np.testing.assert_array_equal(ours.inner.numpy(), np.asarray(ref.inner))
        np.testing.assert_array_equal(tel.MRP([0.1, 0.2, 0.3]).inner.numpy(),
                                      np.asarray(jel.MRP([0.1, 0.2, 0.3]).inner))
    assert _component(tel.MRP.metadata) == _component(jel.MRP.metadata)
    assert tel.MRP.__metadata__ == (tel.MRP.metadata,)


@pytest.mark.parametrize("batched", [True, False], ids=["batch_axis", "vmap"])
def test_spatial_motion_cross_and_offset_match_jax(batched):
    """``offset`` rotates both halves by the transform's attitude, then
    crosses the rotated angular part with its *linear* part."""
    rng = _rng(3)
    a, b, f = (rng.normal(size=(N, 6)) for _ in range(3))
    stf = _transforms(rng)

    def port(fn, *args):
        args = [_t(x) for x in args]
        return fn(*args) if batched else torch.func.vmap(fn)(*args)

    sm, jsm = tel.SpatialMotion.from_array, jel.SpatialMotion.from_array
    with float_policy("f64"):
        cases = {
            "cross": (port(lambda x, y: sm(x).cross(sm(y)).inner, a, b),
                      jsm(a).cross(jsm(b))),
            "cross_dual": (
                port(lambda x, y: sm(x).cross_dual(tel.SpatialForce.from_array(y)).inner, a, f),
                jsm(a).cross_dual(jel.SpatialForce.from_array(f))),
            "offset": (
                port(lambda x, p: sm(x).offset(tel.SpatialTransform.from_array(p)).inner, a, stf),
                jsm(a).offset(jel.SpatialTransform.from_array(stf))),
        }
    for name, (ours, ref) in cases.items():
        _hold(ours, ref)
    out = sm(_t(a)).cross_dual(tel.SpatialForce.from_array(_t(f)))
    assert isinstance(out, tel.SpatialForce)
    assert isinstance(sm(_t(a)).offset(tel.SpatialTransform.from_array(_t(stf))),
                      tel.SpatialMotion)
    # one transform broadcast against a batch of motions
    _hold(sm(_t(a)).offset(tel.SpatialTransform.from_array(_t(stf[0]))),
          jsm(a).offset(jel.SpatialTransform.from_array(stf[0])))


def test_asarray_is_the_inner_array():
    rng = _rng(4)
    for cls, jcls, width in ((tel.Quaternion, jel.Quaternion, 4),
                             (tel.SpatialTransform, jel.SpatialTransform, 7),
                             (tel.SpatialMotion, jel.SpatialMotion, 6),
                             (tel.SpatialForce, jel.SpatialForce, 6),
                             (tel.SpatialInertia, jel.SpatialInertia, 7),
                             (tel.MRP, jel.MRP, 3)):
        x = rng.normal(size=(5, width))
        ours = cls.from_array(_t(x))
        assert ours.asarray() is ours.inner
        np.testing.assert_array_equal(ours.asarray().numpy(),
                                      np.asarray(jcls.from_array(x).asarray()))


def _component(c):
    return (c.name, c.ty.ty.value, tuple(c.ty.shape), dict(c.metadata))


def test_camera_and_shape_indexer_match_jax():
    assert _component(tel.Component.of(tel.Camera)) == _component(jel.Component.of(jel.Camera))
    assert _component(tel.Component.of(tel.Camera)) == ("camera", "u64", (1,), {})
    assert tel.ShapeIndexer is tel.component.ShapeIndexer

    # tests/test_jaxsim.py:105's case, in both packages
    P = {el: el.Annotated[torch.Tensor, el.Component(
        "p", el.ComponentType(el.PrimitiveType.F64, (2, 3)))] for el in (tel, jel)}
    for el in (tel, jel):
        idx = el.Component.index(P[el])
        assert isinstance(idx, el.ShapeIndexer)
        assert idx.indexes() == [0, 1, 2, 3, 4, 5]
        assert idx[1].indexes() == [3, 4, 5]
        assert idx[1][2].indexes() == [5]
        assert el.Component.name(P[el]) == "p"
        assert el.Component.id(P[el]) == "p"


def test_public_names_of_the_core_api():
    for name in ("MRP", "skew", "Camera", "ShapeIndexer"):
        assert name in dir(tel), name
    for hook in ("schematic", "recipe", "glb", "spawn_camera", "sensor_camera"):
        assert callable(getattr(tel.WorldBuilder, hook, None)), hook
    for cls in ("Quaternion", "SpatialTransform", "SpatialMotion", "SpatialForce",
                "SpatialInertia", "MRP"):
        assert callable(getattr(getattr(tel, cls), "asarray", None)), cls
    for cls, meth in (("Quaternion", "mrp"), ("SpatialTransform", "mrp"),
                      ("SpatialMotion", "cross"), ("SpatialMotion", "cross_dual"),
                      ("SpatialMotion", "offset")):
        assert callable(getattr(getattr(tel, cls), meth, None)), (cls, meth)


def test_world_build_carries_the_schematic():
    """``World.build`` copies the world's schematic onto the ``Exec``, as
    the JAX package's does; without one it is None in both."""
    text = 'viewport name=Viewport look_at="cube.world_pos" show_grid=#true'
    for el, kw in ((tel, {"device": "cpu"}), (jel, {})):
        w = el.World()
        w.spawn(el.Body(world_vel=el.SpatialMotion(angular=np.array([math.pi, 0.0, 0.0]))),
                name="cube")
        assert w.build(el.six_dof(sys=()), **kw).schematic_content is None
        w.schematic(text, "cube.kdl")
        assert (w.schematic_content, w.schematic_path) == (text, "cube.kdl")
        exec_ = w.build(el.six_dof(sys=()), **kw)
        assert exec_.schematic_content == text
