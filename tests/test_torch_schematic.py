"""The port's copies of the KDL and schematic layers (``elodin_tpu_torch.kdl``,
``elodin_tpu_torch.schematic``) and the world's editor hooks, against the
JAX package's: the fixtures of ``tests/test_schematic.py`` load, dump and
lay out string for string alike in both packages, malformed schematics fail
with the same exception and message, non-strict loads give the same
warnings, every schematic of the port's examples validates strictly, and
``WorldBuilder``'s asset hooks store the JAX package's keys and values.
"""

import importlib
import os
import re

import pytest

import elodin_tpu as jel
import elodin_tpu_torch as tel
from elodin_tpu import kdl as jkdl
from elodin_tpu import schematic as jsch
from elodin_tpu_torch import kdl as tkdl
from elodin_tpu_torch import schematic as tsch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_EXAMPLES = os.path.join(REPO, "elodin_tpu_torch", "examples")


def _fixtures():
    """``tests/test_schematic.py``'s three reference-authored fixtures."""
    spec = importlib.util.spec_from_file_location(
        "jax_test_schematic_fixtures", os.path.join(REPO, "tests", "test_schematic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {"3body": mod.THREE_BODY, "motor": mod.MOTOR_PANEL, "rocket": mod.ROCKET_VIEW}


FIXTURES = _fixtures()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixtures_round_trip_and_lay_out_as_jax(name):
    text = FIXTURES[name]
    ours, ref = tsch.load(text), jsch.load(text)
    assert ours.warnings == ref.warnings == []
    out = tsch.dump(ours)
    assert out == jsch.dump(ref)
    assert tsch.dump(tsch.load(out)) == out == jsch.dump(jsch.load(out))
    assert tsch.to_layout_json(ours) == jsch.to_layout_json(ref)
    assert ours.eql_components() == ref.eql_components()
    assert [p.kind for p in ours.all_panels()] == [p.kind for p in ref.all_panels()]
    # the token layer alone: parse and serialise string for string
    assert tkdl.serialize(tkdl.parse(text)) == jkdl.serialize(jkdl.parse(text))
    assert tkdl.schematic_components(text) == jkdl.schematic_components(text)
    assert tkdl.db_asset_names(text) == jkdl.db_asset_names(text)


@pytest.mark.parametrize("text", [
    "vieport name=V",
    "hsplit { wibble }",
    'viewport lookat="a.world_pos"',
    "graph name=G",
], ids=["unknown_node", "unknown_child", "unknown_property", "missing_eql"])
def test_malformed_schematic_fails_as_in_jax(text):
    with pytest.raises(jsch.SchematicError) as ref:
        jsch.load(text)
    with pytest.raises(tsch.SchematicError) as ours:
        tsch.load(text)
    assert str(ours.value) == str(ref.value)
    assert issubclass(tsch.SchematicError, ValueError)
    # the world's hook validates at load, naming the node
    with pytest.raises(tsch.SchematicError, match=re.escape(str(ref.value))):
        tel.World().schematic(text)


def test_non_strict_warnings_and_extras_as_in_jax():
    text = "wibble a=1\nviewport name=V zorp=2"
    ours, ref = tsch.load(text, strict=False), jsch.load(text, strict=False)
    assert ours.warnings == ref.warnings and len(ours.warnings) == 2
    assert [n.name for n in ours.extras] == [n.name for n in ref.extras] == ["wibble"]
    assert tsch.dump(ours) == jsch.dump(ref)


def _port_example_worlds():
    """Every port example that calls ``w.schematic``: its world (the
    examples' own builders)."""
    from elodin_tpu_torch.examples.ball import sim as ball
    from elodin_tpu_torch.examples.covariance_ellipsoids import main as cov
    from elodin_tpu_torch.examples.drone import main as drone
    from elodin_tpu_torch.examples.ellipsoid import sim as ellipsoid
    from elodin_tpu_torch.examples.falcon9 import main as falcon9
    from elodin_tpu_torch.examples.geo_frames import sim as geo
    from elodin_tpu_torch.examples.rotating_cube import sim as cube
    from elodin_tpu_torch.examples.sensor_camera import main as cam
    from elodin_tpu_torch.examples.three_body import main as three_body
    from elodin_tpu_torch.examples.voyager import main as voyager

    return {
        "ball": ball.world(),
        "drone": drone.build_world(),
        "three_body": three_body.build_world(),
        "falcon9": falcon9.build_world()[0],
        "rotating_cube": cube.world(),
        "geo_frames": geo.world(),
        "ellipsoid": ellipsoid.world()[0],
        "covariance_ellipsoids": cov.world(),
        "sensor_camera": cam.world(),
        "voyager": voyager.build()[0],
    }


def test_port_example_schematics_validate_strictly():
    """Every ``.schematic(...)`` of the port's examples validates strictly:
    each literal one in the sources (``tests/test_schematic.py``'s scan),
    and each world's own text, f-strings formatted; ten worlds in all."""
    n_literal = 0
    for dirpath, _dirs, files in os.walk(PORT_EXAMPLES):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                for m in re.finditer(r"\.schematic\(\s*(?:\"\"\"|''')(.*?)(?:\"\"\"|''')",
                                     text, re.S):
                    tsch.load(m.group(1))
                    n_literal += 1
    assert n_literal >= 7, n_literal
    worlds = _port_example_worlds()
    assert len(worlds) >= 10
    for name, w in worlds.items():
        assert w.schematic_content, name
        sch = tsch.load(w.schematic_content)
        assert not sch.warnings, name
        assert tsch.dump(sch) == jsch.dump(jsch.load(w.schematic_content)), name


@pytest.mark.parametrize("example", ["rotating_cube", "geo_frames", "ellipsoid",
                                     "covariance_ellipsoids", "sensor_camera", "voyager",
                                     "ball", "drone"])
def test_port_example_schematic_text_is_jax_s(example):
    """The port keeps each JAX example's schematic text unchanged."""
    from torch_port_util import jax_example

    ours = _port_example_worlds()[example]
    jax_worlds = {
        "rotating_cube": lambda: jax_example("rotating-cube", "sim").world(),
        "geo_frames": lambda: jax_example("geo-frames", "sim").world(),
        "ellipsoid": lambda: jax_example("ellipsoid", "sim").world()[0],
        "covariance_ellipsoids": lambda: jax_example("covariance-ellipsoids", "main").world(),
        "sensor_camera": lambda: jax_example("sensor-camera", "main").world(),
        "voyager": lambda: jax_example("voyager", "main").build()[0],
        "ball": lambda: jax_example("ball", "sim").world(),
        "drone": lambda: jax_example("drone", "main").build_world(),
    }
    ref = jax_worlds[example]()
    assert ours.schematic_content == ref.schematic_content
    assert ours.schematic_path == ref.schematic_path


def test_asset_hooks_store_jax_s_keys_and_values():
    class Recipe:
        name = "sitl"

    results = {}
    for el in (tel, jel):
        w = el.World()
        ball = w.spawn(el.Body(), name="Ball 0")
        other = w.spawn(el.Body())
        w.recipe(Recipe())
        w.recipe("plain")
        w.glb("https://example.invalid/a.glb", scale=2.0)
        w.spawn_camera(look_at="ball_0.world_pos")
        w.sensor_camera(entity=ball, name="scene_cam", width=256, fov=90.0, format="rgba")
        w.sensor_camera(entity=other, name="thermal_cam", fps=30.0)
        w.sensor_camera(name="free_cam")
        results[el.__name__] = (sorted(w.recipes), dict(w.assets))
    ours, ref = results["elodin_tpu_torch"], results["elodin_tpu"]
    assert ours == ref
    assert list(ours[1]) == ["glb_0", "camera_1", "ball_0.scene_cam", "2.thermal_cam",
                             "None.free_cam"]
    cams = [k for k in ours[1] if "cam" in k]
    assert len(cams) == 4  # camera_1 and the three sensor cameras
    assert ours[1]["ball_0.scene_cam"] == (
        ("sensor_camera",), {"entity": 1, "name": "scene_cam", "width": 256, "fov": 90.0,
                             "format": "rgba"})
    assert ours[0] == ["'plain'", "sitl"]  # a recipe without a name is keyed by its repr
