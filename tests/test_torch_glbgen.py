"""The port's GLB writer (``elodin_tpu_torch.utils.glbgen``) and
``utils``' re-exports, on the CPU: ``make_glb`` / ``cube_glb`` write the
JAX package's bytes, and the port's ``db.scenemath.parse_glb`` reads them
back."""

import numpy as np
import pytest

from elodin_tpu.utils import glbgen as jglbgen
from elodin_tpu_torch import dataframe, entity, utils
from elodin_tpu_torch.db.scenemath import parse_glb
from elodin_tpu_torch.utils import glbgen

TRI = {"positions": [[0, 0, 0], [1, 0, 0], [0, 1, 0]], "normals": [[0, 0, 1]] * 3,
       "indices": [0, 1, 2], "color": (0.1, 0.2, 0.3, 1.0), "name": "tri",
       "translation": (1.0, 2.0, 3.0), "rotation": (0.0, 0.0, 0.0, 1.0), "scale": 2.0}


def _strip():
    # 66000 vertices: the indices need 32 bits; no normals, no colour
    x = np.linspace(0.0, 1.0, 66000)
    return {"positions": np.stack([x, x * x, -x], axis=1),
            "indices": np.arange(66000)[::-1].copy(), "scale": (1.0, 0.5, 2.0)}


@pytest.mark.parametrize("specs", [
    [TRI],
    [TRI, _strip()],
    [{"positions": np.zeros((3, 3))}],
], ids=["triangle", "triangle_and_u32_strip", "bare"])
def test_make_glb_writes_the_jax_packages_bytes(specs):
    ours = glbgen.make_glb(specs)
    assert ours == jglbgen.make_glb(specs)
    prims = parse_glb(ours)
    assert len(prims) == len(specs)
    for prim, spec in zip(prims, specs):
        np.testing.assert_array_equal(
            prim["pos"], np.asarray(spec["positions"], dtype=np.float32).reshape(-1))
        if spec.get("indices") is not None:
            np.testing.assert_array_equal(prim["idx"], np.asarray(spec["indices"]))


@pytest.mark.parametrize("kw", [{}, {"size": 3.0, "color": (0, 1, 0, 0.5),
                                      "translation": (0, 0, 5), "name": "box"}])
def test_cube_glb_writes_the_jax_packages_bytes(kw):
    ours = glbgen.cube_glb(**kw)
    assert ours == jglbgen.cube_glb(**kw)
    [prim] = parse_glb(ours)
    pos = prim["pos"].reshape(-1, 3)
    assert pos.shape == (24, 3) and len(prim["idx"]) == 36
    h = kw.get("size", 1.0) / 2
    np.testing.assert_array_equal(np.abs(pos), np.full((24, 3), h, dtype=np.float32))
    np.testing.assert_allclose(prim["color"], kw.get("color", (0.8, 0.3, 0.2, 1.0)))


def test_utils_reexports_the_ports_helpers():
    assert utils.DataFrame is dataframe.DataFrame
    assert utils.Series is dataframe.Series
    assert utils.assert_frame_equal is dataframe.assert_frame_equal
    assert utils.to_snake_case is entity.to_snake_case
    assert utils.to_snake_case("WorldPos") == "world_pos"
