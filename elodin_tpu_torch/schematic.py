"""Typed schematic model over the KDL panel vocabulary (a host-only copy of
``elodin_tpu/schematic.py``: the port imports nothing of the JAX package).

Parity target: the reference's `impeller2-kdl` typed serde
(libs/impeller2/kdl/src/de.rs, ser.rs over libs/impeller2/wkt/src/gui.rs) —
malformed schematics fail at LOAD time with the offending node named,
instead of at render time, and a loaded schematic serializes back to KDL
losslessly (round-trip tested against reference-authored schematics).

The generic token layer stays in ``elodin_tpu_torch.kdl``; this module types the
editor-facing vocabulary on top of it:

  panels:     tabs | hsplit | vsplit | viewport | graph | component_monitor
              | query_table | query_plot | inspector | hierarchy
              | schematic_tree | data_overview | action_pane | video_stream
  elements:   object_3d | line_3d | vector_arrow | coordinate | theme
              | window | time_line (plus any panel at top level)
  meshes:     glb | sphere | box (inside object_3d), with color/material

Unknown node names and unknown properties raise ``SchematicError`` naming
the node, unless ``strict=False`` collects them as warnings and preserves
the raw nodes for round-trip fidelity.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from . import kdl

_PANEL_LEAVES = {
    "inspector",
    "hierarchy",
    "schematic_tree",
    "data_overview",
    "action_pane",
    "welcome",
}

_KNOWN_PROPS = {
    "tabs": {"name", "share", "active"},
    "hsplit": {"name", "share", "shares", "active"},
    "vsplit": {"name", "share", "shares", "active"},
    "viewport": {
        "name", "share", "pos", "look_at", "show_grid", "active", "hdr",
        "fov", "show_gizmos", "create_frustum", "near", "far", "show_frustums",
        "frame",
    },
    "graph": {
        "name", "share", "eql", "type", "auto_y_range", "y_min", "y_max",
        "locked",
    },
    "component_monitor": {"name", "share", "component", "component_name"},
    "query_table": {"name", "share", "query"},
    "query_plot": {
        "name", "share", "query", "type", "auto_refresh", "color",
        "behavior", "aggregate",
    },
    "video_stream": {"name", "share", "msg_name", "waiting"},
    "sensor_view": {"name", "share"},
    "geo_position_gauge": {"name", "share", "eql", "component", "source", "display"},
    "orientation_gauge": {"name", "share", "eql", "component", "source", "display"},
    "object_3d": {"name", "eql", "frame", "frame_orientation"},
    "line_3d": {"line_width", "color", "perspective", "name", "frame"},
    "vector_arrow": {
        "origin", "scale", "name", "body_frame", "color", "label",
        "thickness", "label_position", "normalize", "arrow_thickness",
    },
    "coordinate": {"frame", "lat", "lon", "alt"},
    "theme": {"mode", "scheme"},
    "window": {"path", "x", "y", "width", "height"},
    "time_line": {"start", "end"},
}


class SchematicError(ValueError):
    """A schematic failed load-time validation; message names the node."""


@dataclass
class Panel:
    """One panel node: kind + typed properties + child panels."""

    kind: str
    props: dict = dc_field(default_factory=dict)
    args: list = dc_field(default_factory=list)
    children: list["Panel"] = dc_field(default_factory=list)

    @property
    def name(self):
        return self.props.get("name")

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


@dataclass
class Object3D:
    eql: str
    mesh: kdl.Node | None = None  # glb/sphere/box subtree, preserved verbatim
    props: dict = dc_field(default_factory=dict)
    children: list = dc_field(default_factory=list)


@dataclass
class Line3D:
    eql: str
    props: dict = dc_field(default_factory=dict)
    children: list = dc_field(default_factory=list)  # e.g. `color` nodes


@dataclass
class VectorArrow:
    vector: str
    props: dict = dc_field(default_factory=dict)
    children: list = dc_field(default_factory=list)  # e.g. `color` nodes


@dataclass
class Coordinate:
    frame: str = "ECEF"
    props: dict = dc_field(default_factory=dict)


@dataclass
class Theme:
    props: dict = dc_field(default_factory=dict)


@dataclass
class Window:
    props: dict = dc_field(default_factory=dict)
    panels: list[Panel] = dc_field(default_factory=list)


@dataclass
class Schematic:
    panels: list[Panel] = dc_field(default_factory=list)
    objects: list[Object3D] = dc_field(default_factory=list)
    lines: list[Line3D] = dc_field(default_factory=list)
    arrows: list[VectorArrow] = dc_field(default_factory=list)
    coordinate: Coordinate | None = None
    theme: Theme | None = None
    windows: list[Window] = dc_field(default_factory=list)
    extras: list[kdl.Node] = dc_field(default_factory=list)
    warnings: list[str] = dc_field(default_factory=list)

    def eql_components(self) -> list[str]:
        """Every component path a renderer would subscribe to."""
        out: list[str] = []

        def from_expr(expr):
            if not isinstance(expr, str):
                return
            for piece in expr.replace(",", " ").split():
                if "." in piece and not piece.replace(".", "").isdigit():
                    out.append(piece.strip("\"'()"))

        for p in self.all_panels():
            from_expr(p.props.get("eql"))
            from_expr(p.props.get("pos"))
            from_expr(p.props.get("look_at"))
            for a in p.args:
                from_expr(a)
        for o in self.objects:
            from_expr(o.eql)
        for ln in self.lines:
            from_expr(ln.eql)
        for ar in self.arrows:
            from_expr(ar.props.get("origin"))
        for node in self.extras:
            for n in node.walk():
                for a in n.args:
                    from_expr(a)
                for v in n.props.values():
                    from_expr(v)
        seen: set[str] = set()
        uniq = []
        for c in out:
            if c not in seen:
                seen.add(c)
                uniq.append(c)
        return uniq

    def all_panels(self):
        for p in self.panels:
            yield from p.walk()
        for w in self.windows:
            for p in w.panels:
                yield from p.walk()


def _check_props(node: kdl.Node, strict: bool, warnings: list[str]) -> None:
    known = _KNOWN_PROPS.get(node.name)
    if known is None:
        return
    for key in node.props:
        if key not in known:
            msg = f"{node.name}: unknown property '{key}'"
            if strict:
                raise SchematicError(msg)
            warnings.append(msg)


def _parse_panel(node: kdl.Node, strict: bool, warnings: list[str]) -> Panel:
    kind = node.name
    if kind not in _KNOWN_PROPS and kind not in _PANEL_LEAVES:
        raise SchematicError(f"unknown panel node '{kind}'")
    _check_props(node, strict, warnings)
    children = []
    for c in node.children:
        if c.name in _PANEL_LEAVES or c.name in (
            "tabs", "hsplit", "vsplit", "viewport", "graph",
            "component_monitor", "query_table", "query_plot", "video_stream",
            "sensor_view", "geo_position_gauge", "orientation_gauge",
        ):
            children.append(_parse_panel(c, strict, warnings))
        else:
            msg = f"{kind}: unknown child node '{c.name}'"
            if strict:
                raise SchematicError(msg)
            warnings.append(msg)
    if kind == "graph" and not (node.args or node.props.get("eql")):
        raise SchematicError("graph: missing the EQL expression argument")
    return Panel(kind, dict(node.props), list(node.args), children)


_PANEL_ROOTS = {
    "tabs", "hsplit", "vsplit", "viewport", "graph", "component_monitor",
    "query_table", "query_plot", "video_stream", "sensor_view",
    "geo_position_gauge", "orientation_gauge",
} | _PANEL_LEAVES


def load(text: str, strict: bool = True) -> Schematic:
    """Parse + validate a schematic; raises SchematicError naming the bad
    node (load-time validation, de.rs behavior).  ``strict=False`` demotes
    unknown properties/children to warnings and keeps unknown top-level
    nodes in ``extras`` for round-trip fidelity."""
    sch = Schematic()
    for node in kdl.parse(text):
        name = node.name
        if name in _PANEL_ROOTS:
            sch.panels.append(_parse_panel(node, strict, sch.warnings))
        elif name == "object_3d":
            eql = node.args[0] if node.args else node.props.get("eql")
            if not eql:
                raise SchematicError("object_3d: missing the EQL argument")
            _check_props(node, strict, sch.warnings)
            mesh = node.children[0] if node.children else None
            sch.objects.append(
                Object3D(eql, mesh, dict(node.props), list(node.children))
            )
        elif name == "line_3d":
            if not node.args:
                raise SchematicError("line_3d: missing the EQL argument")
            _check_props(node, strict, sch.warnings)
            sch.lines.append(
                Line3D(node.args[0], dict(node.props), list(node.children))
            )
        elif name == "vector_arrow":
            if not node.args:
                raise SchematicError("vector_arrow: missing the vector argument")
            _check_props(node, strict, sch.warnings)
            sch.arrows.append(
                VectorArrow(node.args[0], dict(node.props), list(node.children))
            )
        elif name == "coordinate":
            _check_props(node, strict, sch.warnings)
            frame = node.props.get("frame", node.args[0] if node.args else "ECEF")
            sch.coordinate = Coordinate(frame, dict(node.props))
        elif name == "theme":
            _check_props(node, strict, sch.warnings)
            sch.theme = Theme(dict(node.props))
        elif name == "window":
            _check_props(node, strict, sch.warnings)
            panels = [_parse_panel(c, strict, sch.warnings) for c in node.children]
            w = Window(dict(node.props), panels)
            if node.args and "path" not in w.props:
                w.props["path"] = node.args[0]
            sch.windows.append(w)
        elif name == "time_line":
            _check_props(node, strict, sch.warnings)
            sch.extras.append(node)
        else:
            msg = f"unknown schematic node '{name}'"
            if strict:
                raise SchematicError(msg)
            sch.warnings.append(msg)
            sch.extras.append(node)
    return sch


def _panel_to_node(p: Panel) -> kdl.Node:
    return kdl.Node(
        p.kind, list(p.args), dict(p.props),
        [_panel_to_node(c) for c in p.children],
    )


def dump(sch: Schematic) -> str:
    """Serialize a typed schematic back to KDL (ser.rs counterpart)."""
    nodes: list[kdl.Node] = []
    if sch.theme is not None:
        nodes.append(kdl.Node("theme", [], dict(sch.theme.props), []))
    if sch.coordinate is not None:
        props = dict(sch.coordinate.props)
        props.setdefault("frame", sch.coordinate.frame)
        nodes.append(kdl.Node("coordinate", [], props, []))
    nodes.extend(_panel_to_node(p) for p in sch.panels)
    for o in sch.objects:
        nodes.append(kdl.Node("object_3d", [o.eql], dict(o.props),
                              list(o.children)))
    for ln in sch.lines:
        nodes.append(kdl.Node("line_3d", [ln.eql], dict(ln.props),
                              list(ln.children)))
    for ar in sch.arrows:
        nodes.append(kdl.Node("vector_arrow", [ar.vector], dict(ar.props),
                              list(ar.children)))
    for w in sch.windows:
        nodes.append(kdl.Node("window", [], dict(w.props),
                              [_panel_to_node(p) for p in w.panels]))
    nodes.extend(sch.extras)
    return kdl.serialize(nodes)


def to_layout_json(sch: Schematic) -> dict:
    """Renderer-facing JSON: the panel tree + scene objects (consumed by
    db/webui.py's schematic-driven layout)."""

    def panel(p: Panel) -> dict:
        return {
            "kind": p.kind,
            "name": p.name,
            "props": {k: v for k, v in p.props.items() if k != "name"},
            "args": p.args,
            "children": [panel(c) for c in p.children],
        }

    return {
        "panels": [panel(p) for p in sch.panels],
        "objects": [
            {"eql": o.eql, "props": o.props} for o in sch.objects
        ],
        "lines": [{"eql": ln.eql, "props": ln.props} for ln in sch.lines],
        "arrows": [{"vector": a.vector, "props": a.props} for a in sch.arrows],
        "coordinate": (
            {"frame": sch.coordinate.frame, **sch.coordinate.props}
            if sch.coordinate
            else None
        ),
        "theme": sch.theme.props if sch.theme else None,
        "components": sch.eql_components(),
        "warnings": sch.warnings,
    }
