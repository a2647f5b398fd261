"""Scene-viewer math + GLB parsing, server-side (the ONE implementation).

This is the pure logic the WebGL viewer (static/scene3d.js) renders from:
column-major mat4 helpers, the binary-glTF (GLB) triangle-mesh parser, the
scene -> draw-list assembly (editor object_3d/line_3d/arrow parity,
libs/elodin-editor/src/object_3d.rs), and camera framing.  It executes
HERE, in Python, under pytest — the browser fetches pre-digested results
from /api/drawlist and /api/glb (db/webui.py), and the JS keeps only the
camera interaction + WebGL upload/draw code.  No JS engine runs the
tests, so the parse/diff/frame logic is a tested Python module and the
client is a thin renderer.

Conventions match WebGL/glTF: matrices are flat column-major lists of 16
floats; quaternions are dicts {x,y,z,w}; colors {r,g,b,a} or [r,g,b,a].

A host-only copy of ``elodin_tpu/db/scenemath.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import json
import math
import struct

import numpy as np

# -- column-major mat4 ------------------------------------------------------


def m4ident() -> list[float]:
    return [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]


def m4mul(a, b) -> list[float]:
    """a*b (apply b first) on flat column-major mat4s."""
    o = [0.0] * 16
    for c in range(4):
        for r in range(4):
            o[c * 4 + r] = (
                a[r] * b[c * 4]
                + a[4 + r] * b[c * 4 + 1]
                + a[8 + r] * b[c * 4 + 2]
                + a[12 + r] * b[c * 4 + 3]
            )
    return o


def m4_from_quat_pos_scale(q, p, s) -> list[float]:
    """quaternion {x,y,z,w} + position [3] + scale [3] -> flat mat4."""
    x, y, z, w = q["x"], q["y"], q["z"], q["w"]
    sx, sy, sz = s
    o = [0.0] * 16
    o[0] = (1 - 2 * (y * y + z * z)) * sx
    o[1] = 2 * (x * y + w * z) * sx
    o[2] = 2 * (x * z - w * y) * sx
    o[4] = 2 * (x * y - w * z) * sy
    o[5] = (1 - 2 * (x * x + z * z)) * sy
    o[6] = 2 * (y * z + w * x) * sy
    o[8] = 2 * (x * z + w * y) * sz
    o[9] = 2 * (y * z - w * x) * sz
    o[10] = (1 - 2 * (x * x + y * y)) * sz
    o[12], o[13], o[14], o[15] = p[0], p[1], p[2], 1.0
    return o


def m4_from_trs(node: dict) -> list[float]:
    """glTF node TRS (or explicit column-major "matrix") -> flat mat4."""
    if node.get("matrix"):
        return [float(v) for v in node["matrix"]]
    t = node.get("translation", [0.0, 0.0, 0.0])
    r = node.get("rotation", [0.0, 0.0, 0.0, 1.0])
    s = node.get("scale", [1.0, 1.0, 1.0])
    return m4_from_quat_pos_scale(
        {"x": r[0], "y": r[1], "z": r[2], "w": r[3]}, t, s
    )


def arrow_mats(a: dict) -> tuple[list[float], list[float]]:
    """Foxglove-style arrow -> (shaft cylinder mat, head cone mat), both in
    the arrow's local frame (+x is the arrow direction)."""
    sl = a["shaft_length"]
    sd = a["shaft_diameter"] / 2.0
    hl = a["head_length"]
    hd = a["head_diameter"] / 2.0
    rt = math.sqrt(0.5)
    qzx = {"x": 0.0, "y": rt, "z": 0.0, "w": rt}  # rotate z -> x
    shaft = m4_from_quat_pos_scale(qzx, [sl / 2.0, 0.0, 0.0], [sd, sd, sl])
    head = m4_from_quat_pos_scale(
        {"x": 0.0, "y": 0.0, "z": 0.0, "w": 1.0}, [sl, 0.0, 0.0], [hl, hd, hd]
    )
    return shaft, head


# -- binary glTF (GLB) parser -----------------------------------------------
# Triangle meshes only: POSITION (+NORMAL if present, else flat normals),
# indices of any component type, node hierarchy flattened to world matrices,
# color from pbrMetallicRoughness.baseColorFactor.  Textures, skins,
# animations and sparse accessors are ignored.

GLB_MAGIC = 0x46546C67
CH_JSON = 0x4E4F534A
CH_BIN = 0x004E4942
_CT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_N = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def parse_glb(buf: bytes) -> list[dict]:
    """GLB bytes -> list of primitives, each
    {pos: f32 ndarray (3n,), norm: f32 ndarray (3n,),
     idx: uint16/uint32 ndarray | None, color: [4], matrix: [16]}."""
    if len(buf) < 12 or struct.unpack_from("<I", buf, 0)[0] != GLB_MAGIC:
        raise ValueError("not a GLB")
    off, gltf, bin_chunk = 12, None, b""
    while off + 8 <= len(buf):
        ln, ty = struct.unpack_from("<II", buf, off)
        body = buf[off + 8: off + 8 + ln]
        if ty == CH_JSON:
            gltf = json.loads(body.decode())
        elif ty == CH_BIN:
            bin_chunk = body
        off += 8 + ln + ((4 - ln % 4) % 4)
    if gltf is None:
        raise ValueError("GLB: no JSON chunk")

    def accessor(i: int) -> np.ndarray:
        a = gltf["accessors"][i]
        n = _TYPE_N[a["type"]]
        bv = gltf["bufferViews"][a["bufferView"]]
        base = bv.get("byteOffset", 0) + a.get("byteOffset", 0)
        stride = bv.get("byteStride", 0)
        dt = np.dtype(_CT_DTYPE[a["componentType"]]).newbyteorder("<")
        eb = dt.itemsize
        if not stride or stride == n * eb:
            return np.frombuffer(bin_chunk, dt, count=a["count"] * n,
                                 offset=base)
        out = np.empty(a["count"] * n, dt)
        for e in range(a["count"]):
            out[e * n: (e + 1) * n] = np.frombuffer(
                bin_chunk, dt, count=n, offset=base + e * stride
            )
        return out

    def flat_normals(pos: np.ndarray, idx) -> np.ndarray:
        """Per-vertex normal = unnormalized sum of adjacent face normals
        (normalized in the shader — matches the JS it replaced)."""
        v = pos.reshape(-1, 3).astype(np.float64)
        tri = (idx.reshape(-1, 3) if idx is not None
               else np.arange(len(v)).reshape(-1, 3))
        fn = np.cross(v[tri[:, 1]] - v[tri[:, 0]], v[tri[:, 2]] - v[tri[:, 0]])
        norm = np.zeros_like(v)
        for k in range(3):
            np.add.at(norm, tri[:, k], fn)
        return norm.astype(np.float32).ravel()

    prims: list[dict] = []

    def walk(node_idx: int, parent: list[float]) -> None:
        node = gltf["nodes"][node_idx]
        world = m4mul(parent, m4_from_trs(node))
        if "mesh" in node:
            for p in gltf["meshes"][node["mesh"]].get("primitives", []):
                if p.get("mode", 4) != 4 or "POSITION" not in p["attributes"]:
                    continue
                pos = np.asarray(accessor(p["attributes"]["POSITION"]),
                                 np.float32)
                idx = accessor(p["indices"]) if "indices" in p else None
                if idx is not None and idx.dtype not in (np.uint16, np.uint32):
                    idx = idx.astype(np.uint32)
                if "NORMAL" in p["attributes"]:
                    norm = np.asarray(accessor(p["attributes"]["NORMAL"]),
                                      np.float32)
                else:
                    norm = flat_normals(pos, idx)
                color = [0.72, 0.72, 0.74, 1.0]
                if "material" in p:
                    pbr = gltf.get("materials", [{}])[p["material"]].get(
                        "pbrMetallicRoughness"
                    )
                    if pbr and pbr.get("baseColorFactor"):
                        color = pbr["baseColorFactor"]
                prims.append({"pos": pos, "norm": norm, "idx": idx,
                              "color": color, "matrix": world})
        for c in node.get("children", []):
            walk(c, world)

    scenes = gltf.get("scenes")
    if scenes:
        roots = scenes[gltf.get("scene", 0)].get("nodes", [])
    else:
        roots = list(range(len(gltf.get("nodes", []))))
    for r in roots:
        walk(r, m4ident())
    return prims


def glb_to_json(buf: bytes) -> dict:
    """parse_glb packaged for the /api/glb endpoint: vertex data rides as
    base64 little-endian blobs (JSON float lists would be ~10x larger),
    with the typed-array dtype named so the client reconstructs exactly."""
    prims = []
    for p in parse_glb(buf):
        idx = p["idx"]
        prims.append({
            "pos_b64": base64.b64encode(
                np.ascontiguousarray(p["pos"], "<f4").tobytes()).decode(),
            "norm_b64": base64.b64encode(
                np.ascontiguousarray(p["norm"], "<f4").tobytes()).decode(),
            "idx_b64": (base64.b64encode(
                np.ascontiguousarray(idx).tobytes()).decode()
                if idx is not None else ""),
            "idx_u32": bool(idx is not None and idx.dtype == np.uint32),
            "color": [float(c) for c in p["color"]],
            "matrix": [float(v) for v in p["matrix"]],
        })
    return {"prims": prims}


# -- unit primitive geometry (unit radius / unit edge, axes per Foxglove) ----


def geom_cube() -> dict:
    """Unit cube centered at origin: 6 faces x 4 verts, indexed."""
    p, n, idx = [], [], []
    faces = [
        ([1, 0, 0], [0, 1, 0], [0, 0, 1]), ([-1, 0, 0], [0, 0, 1], [0, 1, 0]),
        ([0, 1, 0], [0, 0, 1], [1, 0, 0]), ([0, -1, 0], [1, 0, 0], [0, 0, 1]),
        ([0, 0, 1], [1, 0, 0], [0, 1, 0]), ([0, 0, -1], [0, 1, 0], [1, 0, 0]),
    ]
    for nf, u, v in faces:
        base = len(p) // 3
        for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            p.extend(0.5 * (nf[k] + su * u[k] + sv * v[k]) for k in range(3))
            n.extend(nf)
        idx.extend((base, base + 1, base + 2, base, base + 2, base + 3))
    return {"pos": np.asarray(p, np.float32),
            "norm": np.asarray(n, np.float32),
            "idx": np.asarray(idx, np.uint16)}


def geom_sphere(lat: int, lon: int) -> dict:
    """Unit sphere, lat x lon quad strip."""
    p, n, idx = [], [], []
    for i in range(lat + 1):
        th = math.pi * i / lat
        st, ct = math.sin(th), math.cos(th)
        for j in range(lon + 1):
            ph = 2 * math.pi * j / lon
            x, y, z = st * math.cos(ph), st * math.sin(ph), ct
            p.extend((x, y, z))
            n.extend((x, y, z))
    for i in range(lat):
        for j in range(lon):
            a = i * (lon + 1) + j
            b = a + lon + 1
            idx.extend((a, b, a + 1, b, b + 1, a + 1))
    return {"pos": np.asarray(p, np.float32),
            "norm": np.asarray(n, np.float32),
            "idx": np.asarray(idx, np.uint16)}


def geom_cylinder(seg: int) -> dict:
    """Unit cylinder: radius 1, z in [-0.5, 0.5] (Foxglove axis = z)."""
    p, n, idx = [], [], []
    for j in range(seg + 1):
        ph = 2 * math.pi * j / seg
        c, s = math.cos(ph), math.sin(ph)
        p.extend((c, s, -0.5, c, s, 0.5))
        n.extend((c, s, 0, c, s, 0))
    for j in range(seg):
        a = 2 * j
        idx.extend((a, a + 2, a + 1, a + 1, a + 2, a + 3))
    for z, nz in ((-0.5, -1), (0.5, 1)):
        center = len(p) // 3
        p.extend((0, 0, z))
        n.extend((0, 0, nz))
        for j in range(seg + 1):
            ph = 2 * math.pi * j / seg
            p.extend((math.cos(ph), math.sin(ph), z))
            n.extend((0, 0, nz))
        for j in range(seg):
            if nz > 0:
                idx.extend((center, center + 1 + j, center + 2 + j))
            else:
                idx.extend((center, center + 2 + j, center + 1 + j))
    return {"pos": np.asarray(p, np.float32),
            "norm": np.asarray(n, np.float32),
            "idx": np.asarray(idx, np.uint16)}


def geom_cone(seg: int) -> dict:
    """Unit cone: base radius 1 at x=0, apex at x=1 (arrows point +x)."""
    p, n, idx = [], [], []
    inv = 1 / math.sqrt(2)
    for j in range(seg + 1):
        ph = 2 * math.pi * j / seg
        c, s = math.cos(ph), math.sin(ph)
        p.extend((0, c, s, 1, 0, 0))
        n.extend((inv, c * inv, s * inv, inv, c * inv, s * inv))
    for j in range(seg):
        idx.extend((2 * j, 2 * j + 2, 2 * j + 1))
    center = len(p) // 3
    p.extend((0, 0, 0))
    n.extend((-1, 0, 0))
    for j in range(seg + 1):
        ph = 2 * math.pi * j / seg
        p.extend((0, math.cos(ph), math.sin(ph)))
        n.extend((-1, 0, 0))
    for j in range(seg):
        idx.extend((center, center + 2 + j, center + 1 + j))
    return {"pos": np.asarray(p, np.float32),
            "norm": np.asarray(n, np.float32),
            "idx": np.asarray(idx, np.uint16)}


def _geom_b64(g: dict) -> dict:
    return {
        "pos_b64": base64.b64encode(
            np.ascontiguousarray(g["pos"], "<f4").tobytes()).decode(),
        "norm_b64": base64.b64encode(
            np.ascontiguousarray(g["norm"], "<f4").tobytes()).decode(),
        "idx_b64": base64.b64encode(
            np.ascontiguousarray(g["idx"], "<u2").tobytes()).decode(),
        "idx_u32": False,
    }


def geoms_to_json() -> dict:
    """The four unit primitives for /api/geoms (same b64 packaging as
    glb_to_json; tessellation levels match the pre-port client tables)."""
    return {
        "cube": _geom_b64(geom_cube()),
        "sphere": _geom_b64(geom_sphere(18, 28)),
        "cylinder": _geom_b64(geom_cylinder(24)),
        "cone": _geom_b64(geom_cone(24)),
    }


# -- scene -> draw list ------------------------------------------------------


def build_draw_list(scene: dict) -> dict:
    """SceneUpdate-style entity JSON (/api/scene) -> flat draw descriptors:
    {"solids": [{kind, color, mat}], "lines": [{pts, color, mat}],
     "glbs": [{url, data, color|None, mat}]}.  Frame-locked entities are
    premultiplied by their frame's live transform (scene.transforms, baked
    from the *.world_pos series)."""
    out = {"solids": [], "lines": [], "glbs": []}

    def raw_pose2mat(pose, size):
        return m4_from_quat_pos_scale(
            pose["orientation"],
            [pose["position"]["x"], pose["position"]["y"],
             pose["position"]["z"]],
            size,
        )

    for ent in scene.get("entities", []):
        tf = scene.get("transforms", {}).get(ent.get("frame_id"))
        parent = raw_pose2mat(tf, [1, 1, 1]) if tf else None

        def pose2mat(pose, size, _parent=parent):
            m = raw_pose2mat(pose, size)
            return m4mul(_parent, m) if _parent else m

        for sp in ent.get("spheres", []):
            out["solids"].append({
                "kind": "sphere", "color": sp["color"],
                "mat": pose2mat(sp["pose"], [sp["size"]["x"] / 2,
                                             sp["size"]["y"] / 2,
                                             sp["size"]["z"] / 2]),
            })
        for cb in ent.get("cubes", []):
            out["solids"].append({
                "kind": "cube", "color": cb["color"],
                "mat": pose2mat(cb["pose"], [cb["size"]["x"],
                                             cb["size"]["y"],
                                             cb["size"]["z"]]),
            })
        for cy in ent.get("cylinders", []):
            out["solids"].append({
                "kind": "cylinder", "color": cy["color"],
                "mat": pose2mat(cy["pose"], [cy["size"]["x"] / 2,
                                             cy["size"]["y"] / 2,
                                             cy["size"]["z"]]),
            })
        for ar in ent.get("arrows", []):
            base_m = pose2mat(ar["pose"], [1, 1, 1])
            shaft, head = arrow_mats(ar)
            out["solids"].append({"kind": "cylinder", "color": ar["color"],
                                  "mat": m4mul(base_m, shaft)})
            out["solids"].append({"kind": "cone", "color": ar["color"],
                                  "mat": m4mul(base_m, head)})
        for ln in ent.get("lines", []):
            pts: list[float] = []
            for pt in ln.get("points", []):
                pts.extend((pt["x"], pt["y"], pt["z"]))
            out["lines"].append({
                "pts": pts, "color": ln["color"],
                "mat": pose2mat(ln.get("pose") or {
                    "position": {"x": 0, "y": 0, "z": 0},
                    "orientation": {"x": 0, "y": 0, "z": 0, "w": 1},
                }, [1, 1, 1]),
            })
        for md in ent.get("models", []):
            out["glbs"].append({
                "url": md.get("url", ""), "data": md.get("data", ""),
                "color": md["color"] if md.get("override_color") else None,
                "mat": pose2mat(md["pose"], [md["scale"]["x"],
                                             md["scale"]["y"],
                                             md["scale"]["z"]]),
            })
    return out


def frame_scene(dl: dict) -> dict:
    """Initial camera framing: centroid of draw origins / line points and
    the bounding radius around it ({"center": [3], "radius": r})."""
    pts: list[tuple[float, float, float]] = []
    for s in dl["solids"]:
        pts.append((s["mat"][12], s["mat"][13], s["mat"][14]))
    for g in dl["glbs"]:
        pts.append((g["mat"][12], g["mat"][13], g["mat"][14]))
    for ln in dl["lines"]:
        p = ln["pts"]
        pts.extend((p[i], p[i + 1], p[i + 2]) for i in range(0, len(p) - 2, 3))
    if not pts:
        return {"center": [0.0, 0.0, 0.0], "radius": 10.0}
    arr = np.asarray(pts, np.float64)
    c = arr.mean(axis=0)
    r2 = max(1.0, float(((arr - c) ** 2).sum(axis=1).max()))
    return {"center": [float(v) for v in c], "radius": math.sqrt(r2)}
