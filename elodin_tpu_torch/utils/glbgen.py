"""Minimal binary-glTF (GLB) authoring — procedural mesh assets for the
3D scene viewport without shipping binary fixtures.

The reference ships hand-made .glb files and renders them through Bevy's
glTF loader (libs/elodin-editor object_3d pipeline); this framework's
web viewer parses GLB in the browser (db/static/scene3d.js).  This module
writes spec-conformant GLB 2.0 containers the viewer (and any glTF
consumer) can load: one buffer, tightly-packed accessors, one mesh per
primitive spec, per-primitive node TRS and pbr baseColorFactor.

Spec: glTF 2.0 — 12-byte header, JSON chunk (0x4E4F534A), BIN chunk
(0x004E4942), 4-byte-aligned chunks.

A host-only copy of ``elodin_tpu/utils/glbgen.py``; it writes the same
bytes, the asset's ``generator`` string included.
"""

from __future__ import annotations

import json
import struct

import numpy as np

__all__ = ["make_glb", "cube_glb"]


def _pad4(b: bytes, fill: bytes) -> bytes:
    return b + fill * (-len(b) % 4)


def make_glb(primitives: list[dict]) -> bytes:
    """Build a GLB from primitive specs.

    Each spec: ``positions`` (N,3 float) required; optional ``normals``
    (N,3), ``indices`` (M, uint), ``color`` (RGBA 0-1), ``translation``
    (3,), ``rotation`` (quat x,y,z,w), ``scale`` (3,) or scalar,
    ``name``.
    """
    bin_parts: list[bytes] = []
    buffer_views: list[dict] = []
    accessors: list[dict] = []

    def add_blob(arr: np.ndarray, target: int) -> int:
        raw = arr.tobytes()
        offset = sum(len(p) for p in bin_parts)
        bin_parts.append(_pad4(raw, b"\x00"))
        buffer_views.append({
            "buffer": 0, "byteOffset": offset, "byteLength": len(raw),
            "target": target,
        })
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, ctype: int, atype: str,
                     target: int, minmax: bool = False) -> int:
        bv = add_blob(arr, target)
        acc = {
            "bufferView": bv, "componentType": ctype,
            "count": int(arr.shape[0]), "type": atype,
        }
        if minmax:
            acc["min"] = [float(v) for v in arr.min(axis=0)]
            acc["max"] = [float(v) for v in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    meshes, materials, nodes = [], [], []
    for spec in primitives:
        pos = np.asarray(spec["positions"], dtype="<f4").reshape(-1, 3)
        attrs = {"POSITION": add_accessor(pos, 5126, "VEC3", 34962,
                                          minmax=True)}
        if spec.get("normals") is not None:
            norm = np.asarray(spec["normals"], dtype="<f4").reshape(-1, 3)
            attrs["NORMAL"] = add_accessor(norm, 5126, "VEC3", 34962)
        prim: dict = {"attributes": attrs, "mode": 4}
        if spec.get("indices") is not None:
            idx = np.asarray(spec["indices"])
            if idx.max(initial=0) < 65536:
                acc = add_accessor(idx.astype("<u2").reshape(-1), 5123,
                                   "SCALAR", 34963)
            else:
                acc = add_accessor(idx.astype("<u4").reshape(-1), 5125,
                                   "SCALAR", 34963)
            prim["indices"] = acc
        color = spec.get("color")
        if color is not None:
            materials.append({"pbrMetallicRoughness": {
                "baseColorFactor": [float(c) for c in color],
                "metallicFactor": 0.1, "roughnessFactor": 0.8,
            }})
            prim["material"] = len(materials) - 1
        meshes.append({"primitives": [prim]})
        node: dict = {"mesh": len(meshes) - 1}
        if spec.get("name"):
            node["name"] = spec["name"]
        if spec.get("translation") is not None:
            node["translation"] = [float(v) for v in spec["translation"]]
        if spec.get("rotation") is not None:
            node["rotation"] = [float(v) for v in spec["rotation"]]
        if spec.get("scale") is not None:
            s = spec["scale"]
            node["scale"] = ([float(s)] * 3 if np.isscalar(s)
                             else [float(v) for v in s])
        nodes.append(node)

    bin_chunk = b"".join(bin_parts)
    doc = {
        "asset": {"version": "2.0", "generator": "elodin_tpu.utils.glbgen"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    if materials:
        doc["materials"] = materials
    json_chunk = _pad4(json.dumps(doc, separators=(",", ":")).encode(), b" ")
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    return b"".join([
        b"glTF", struct.pack("<II", 2, total),
        struct.pack("<I", len(json_chunk)), b"JSON", json_chunk,
        struct.pack("<I", len(bin_chunk)), b"BIN\x00", bin_chunk,
    ])


def cube_glb(size: float = 1.0, color=(0.8, 0.3, 0.2, 1.0), **node) -> bytes:
    """A unit-ish cube GLB with face normals — the simplest visible asset."""
    h = size / 2.0
    faces = [  # (normal, tangent-u, tangent-v)
        ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((0, 1, 0), (0, 0, 1), (1, 0, 0)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (0, 1, 0), (1, 0, 0)),
    ]
    pos, norm, idx = [], [], []
    for nf, u, v in faces:
        base = len(pos)
        for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            pos.append([h * (nf[k] + su * u[k] + sv * v[k])
                        for k in range(3)])
            norm.append(list(nf))
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return make_glb([{
        "positions": pos, "normals": norm, "indices": idx, "color": color,
        **node,
    }])
