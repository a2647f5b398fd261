"""Minimal KDL document parser for editor schematics (a host-only copy of
``elodin_tpu/kdl.py``: the port imports nothing of the JAX package)
(parity target: libs/impeller2/kdl — serde for viewport/graph/object_3d
panel trees; this covers the KDL subset the examples' schematics use:
nodes with arguments, key=value properties, ``#true``/``#false`` keywords,
quoted strings, numbers, and ``{ }`` children blocks, plus ``//`` comments).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field


@dataclass
class Node:
    name: str
    args: list = field(default_factory=list)
    props: dict = field(default_factory=dict)
    children: list = field(default_factory=list)

    def child(self, name: str) -> "Node | None":
        for c in self.children:
            if c.name == name:
                return c
        return None

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


_TOKEN = re.compile(
    r"""
    (?P<ws>[ \t]+)
  | (?P<comment>//[^\n]*)
  | (?P<newline>[\r\n;]+)
  | (?P<lbrace>\{)
  | (?P<rbrace>\})
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<keyword>\#(?:true|false|null))
  | (?P<number>[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?)
  | (?P<equals>=)
  | (?P<ident>[^\s{}=;"]+)
    """,
    re.VERBOSE,
)


def _tokens(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            raise ValueError(f"KDL parse error at {text[pos:pos+30]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        yield kind, m.group()
    yield "eof", ""


def _unescape(s: str) -> str:
    # single left-to-right scan: sequential str.replace mis-decodes
    # overlapping sequences ('\\\\n' would lose the backslash AND eat 'n')
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            out.append({"n": "\n", "t": "\t", "r": "\r", '"': '"',
                        "\\": "\\"}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _value(kind: str, raw: str):
    if kind == "string":
        return _unescape(raw[1:-1])
    if kind == "number":
        f = float(raw)
        return int(f) if f.is_integer() and "." not in raw and "e" not in raw.lower() else f
    if kind == "keyword":
        return {"#true": True, "#false": False, "#null": None}[raw]
    return raw


def parse(text: str) -> list[Node]:
    """Parse a KDL document into a list of top-level nodes."""
    toks = list(_tokens(text))
    i = 0

    def parse_nodes(stop_at_rbrace: bool):
        nonlocal i
        nodes = []
        while True:
            kind, raw = toks[i]
            if kind == "newline":
                i += 1
                continue
            if kind == "eof":
                if stop_at_rbrace:
                    raise ValueError("KDL: unexpected end of document")
                return nodes
            if kind == "rbrace":
                if not stop_at_rbrace:
                    raise ValueError("KDL: unexpected '}'")
                i += 1
                return nodes
            nodes.append(parse_node())

    def parse_node():
        nonlocal i
        kind, raw = toks[i]
        if kind not in ("ident", "string"):
            raise ValueError(f"KDL: expected node name, got {raw!r}")
        node = Node(_value(kind, raw) if kind == "string" else raw)
        i += 1
        while True:
            kind, raw = toks[i]
            if kind in ("newline", "eof", "rbrace"):
                if kind == "newline":
                    i += 1
                return node
            if kind == "lbrace":
                i += 1
                node.children = parse_nodes(stop_at_rbrace=True)
                return node
            if kind in ("string", "number", "keyword", "ident"):
                # property (name=value) or argument
                if toks[i + 1][0] == "equals":
                    key = _value(kind, raw) if kind == "string" else raw
                    vkind, vraw = toks[i + 2]
                    if vkind not in ("string", "number", "keyword", "ident"):
                        raise ValueError(
                            f"KDL: property {key!r} missing value"
                        )
                    node.props[key] = _value(vkind, vraw)
                    i += 3
                else:
                    node.args.append(_value(kind, raw))
                    i += 1
            else:
                raise ValueError(f"KDL: unexpected token {raw!r}")

    return parse_nodes(stop_at_rbrace=False)


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "#true" if v else "#false"
    if v is None:
        return "#null"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    # bare only when the re-lex is unambiguous: no comment starters, not
    # number-like, no slashes — otherwise 'a 42 //x' re-parses as int + a
    # line comment swallowing the rest of the node's values
    if (
        s
        and re.fullmatch(r"[^\s{}=;\"#/][^\s{}=;\"/]*", s)
        and not re.fullmatch(r"[+-]?\d[\d_.eE+-]*", s)
    ):
        return s  # bare identifier
    escaped = (
        s.replace("\\", "\\\\").replace('"', '\\"')
        .replace("\n", "\\n").replace("\t", "\\t").replace("\r", "\\r")
    )
    return f'"{escaped}"'


_BARE_IDENT = r"[^\s{}=;\"#/][^\s{}=;\"/]*"


def serialize(nodes: list[Node], indent: int = 0) -> str:
    """Render nodes back to KDL text (impeller2_kdl ser.rs equivalent).
    Round-trips through ``parse`` value-exactly."""
    pad = "    " * indent
    out = []
    for n in nodes:
        parts = [_fmt_value(n.name) if not re.fullmatch(
            r"[^\s{}=;\"]+", n.name) else n.name]
        parts += [_fmt_value(a) for a in n.args]
        parts += [
            # keys lex as node/prop names: quote anything that wouldn't
            # re-lex as a single ident (spaces, '=', quotes, slashes)
            f"{k if re.fullmatch(_BARE_IDENT, k) else _fmt_value(str(k))}"
            f"={_fmt_value(v)}"
            for k, v in n.props.items()
        ]
        line = pad + " ".join(parts)
        if n.children:
            line += " {\n" + serialize(n.children, indent + 1) + "\n" + pad + "}"
        out.append(line)
    return "\n".join(out)


_PATH_PROPS = ("glb", "file", "path", "mesh", "texture", "effect")
_PATH_SUFFIXES = (".glb", ".gltf", ".png", ".jpg", ".ktx2", ".effect", ".ron")


def rewrite_asset_paths(text: str, map_fn) -> str:
    """Rewrite every asset-path value in a schematic through ``map_fn``
    (impeller2_kdl rewrite.rs rewrite_asset_paths/rewrite_glb_paths):
    path-bearing properties and any argument with an asset-file suffix.
    Returns the serialized document."""
    nodes = parse(text)
    for root in nodes:
        for n in root.walk():
            for k in list(n.props):
                v = n.props[k]
                if isinstance(v, str) and (
                    k in _PATH_PROPS or v.lower().endswith(_PATH_SUFFIXES)
                ):
                    n.props[k] = map_fn(v)
            n.args = [
                map_fn(a)
                if isinstance(a, str) and a.lower().endswith(_PATH_SUFFIXES)
                else a
                for a in n.args
            ]
    return serialize(nodes)


def schematic_components(text: str) -> list[str]:
    """Component paths referenced by a schematic (graphs, object_3d,
    line_3d anchors) — what the editor subscribes to."""
    out = []
    for node in parse(text):
        for n in node.walk():
            if n.name in ("graph", "object_3d", "line_3d", "vector_arrow"):
                for a in n.args:
                    if isinstance(a, str) and "." in a and not a.startswith("("):
                        out.extend(p.strip() for p in a.split(","))
    return [o for o in out if o]


def db_asset_names(text: str) -> list[str]:
    """`db:`-prefixed asset keys in a schematic
    (impeller2_kdl::collect_db_asset_names equivalent)."""
    out = []
    for node in parse(text):
        for n in node.walk():
            for v in list(n.args) + list(n.props.values()):
                if isinstance(v, str) and v.startswith("db:"):
                    out.append(v[3:])
    return out
