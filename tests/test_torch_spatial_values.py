"""The port's spatial value types against the JAX package's.

Each method and operator of ``SpatialTransform``, ``SpatialMotion``,
``SpatialForce`` and ``SpatialInertia`` runs on the same random batches
(numpy, seeded) in both packages; stated tolerance max |Δ| / max |ref|
≤ 1e-12 in f64 (the same operations in IEEE f64).  The constructors keep
the device of the part they are given, and the four classes flatten as
pytree nodes, so ``torch.func.vmap`` can return them.
"""

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import elodin_tpu as jel
import elodin_tpu_torch as tel
from elodin_tpu.spatial import quat_rotate as j_quat_rotate
from elodin_tpu_torch.spatial import quat_rotate as t_quat_rotate
from torch_port_util import float_policy, rel_err

TOL = 1e-12
B = 16


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 4))
    return {
        "stf": np.concatenate([q, rng.normal(size=(B, 3)) * 10], axis=-1),
        "stf2": np.concatenate([rng.normal(size=(B, 4)), rng.normal(size=(B, 3))], axis=-1),
        "sm": rng.normal(size=(B, 6)),
        "sm2": rng.normal(size=(B, 6)),
        "sf": rng.normal(size=(B, 6)) * 100,
        "sf2": rng.normal(size=(B, 6)),
        "si": np.concatenate([rng.uniform(1, 3, (B, 3)), rng.normal(size=(B, 3)),
                              rng.uniform(1, 5, (B, 1))], axis=-1),
        "v": rng.normal(size=(B, 3)),
        "s": rng.uniform(0.5, 2.0, (B, 1)),
    }


def _ops(el, a, quat_rotate):
    """Every method and operator, in one package; returns raw arrays."""
    stf = el.SpatialTransform.from_array(a["stf"])
    stf2 = el.SpatialTransform.from_array(a["stf2"])
    sm = el.SpatialMotion.from_array(a["sm"])
    sm2 = el.SpatialMotion.from_array(a["sm2"])
    sf = el.SpatialForce.from_array(a["sf"])
    sf2 = el.SpatialForce.from_array(a["sf2"])
    si = el.SpatialInertia.from_array(a["si"])
    return {
        "stf.linear": stf.linear(),
        "stf+stf": (stf + stf2).inner,
        "stf+sm": (stf + sm).inner,
        "stf*stf": (stf * stf2).inner,
        "sm.linear": sm.linear(),
        "sm.angular": sm.angular(),
        "sm+sm": (sm + sm2).inner,
        "sm-sm": (sm - sm2).inner,
        "sm*s": (sm * a["s"]).inner,
        "3*sm": (3.0 * sm).inner,
        "sf.force": sf.force(),
        "sf.linear": sf.linear(),
        "sf.torque": sf.torque(),
        "sf+sf": (sf + sf2).inner,
        "sf-sf": (sf - sf2).inner,
        "sf*s": (sf * a["s"]).inner,
        "2*sf": (2.0 * sf).inner,
        "sf/si": (sf / si).inner,
        "si.mass": si.mass(),
        "si.inertia_diag": si.inertia_diag(),
        "si.momentum": si.momentum(),
        "si*sm": (si * sm).inner,
        "quat_rotate": quat_rotate(a["stf"][:, :4], a["v"]),
    }


def test_value_methods_match_jax():
    a = _batches()
    ta = {k: torch.as_tensor(v) for k, v in a.items()}
    with float_policy("f64"):
        ref = _ops(jel, a, lambda q, v: j_quat_rotate(np.asarray(q), np.asarray(v)))
        ours = _ops(tel, ta, lambda q, v: t_quat_rotate(torch.as_tensor(q),
                                                         torch.as_tensor(v)))
    assert ours.keys() == ref.keys()
    for name, r in ref.items():
        o = ours[name]
        assert isinstance(o, torch.Tensor), name
        assert tuple(o.shape) == np.asarray(r).shape, name
        assert rel_err(o, np.asarray(r)) <= TOL, name


@pytest.mark.parametrize("cls,given", [
    ("SpatialTransform", ("linear",)),
    ("SpatialTransform", ("angular",)),
    ("SpatialTransform", ("angular", "linear")),
    ("SpatialMotion", ("linear",)),
    ("SpatialMotion", ("angular",)),
    ("SpatialForce", ("linear",)),
    ("SpatialForce", ("torque",)),
    ("SpatialForce", ("torque", "linear")),
    ("SpatialInertia", ("mass",)),
])
def test_constructors_keep_the_device_of_their_parts(cls, given):
    """Default parts are made on the device of the given part (here
    ``meta``, which holds no data), not on the CPU."""
    shapes = {"linear": (3,), "torque": (3,), "mass": (),
              "angular": (4,) if cls == "SpatialTransform" else (3,)}
    kwargs = {k: torch.zeros(shapes[k], device="meta") for k in given}
    value = getattr(tel, cls)(**kwargs)
    assert value.inner.device.type == "meta"
    assert value.inner.dtype == torch.float64


def test_constructors_without_parts_use_the_cpu_and_policy_dtype():
    with float_policy("f32"):
        for value in (tel.SpatialTransform(), tel.SpatialMotion(),
                      tel.SpatialForce(), tel.SpatialInertia(1.0)):
            assert value.inner.device.type == "cpu"
            assert value.inner.dtype == torch.float32


def test_value_types_are_pytree_nodes():
    f = tel.SpatialForce(linear=torch.arange(3.0, dtype=torch.float64))
    leaves, spec = pytree.tree_flatten({"f": f, "m": tel.SpatialMotion()})
    assert len(leaves) == 2 and leaves[0] is f.inner
    back = pytree.tree_unflatten(leaves, spec)
    assert isinstance(back["f"], tel.SpatialForce)
    assert torch.equal(back["f"].inner, f.inner)

    # vmap returns a batched value type
    lin = torch.randn(5, 3, dtype=torch.float64)
    out = torch.func.vmap(lambda x: tel.SpatialForce(linear=x) * 2.0)(lin)
    assert isinstance(out, tel.SpatialForce) and out.inner.shape == (5, 6)
    assert torch.equal(out.force(), lin * 2.0)
