"""EQL — the telemetry expression query language.

Parity target: libs/db/eql (PEG parser + formula registry compiling to
DataFusion SQL).  Grammar kept: dotted component paths with optional element
labels or array indices, arithmetic over aligned series, and method-style
formulas::

    a.world_pos[4]                      # element by index
    rocket.mach                         # whole component
    rocket.world_vel.norm()             # formula call
    (a.x - b.x).abs()                   # arithmetic + formula
    rocket.mach.time_slice(1.0, 2.0)    # time windowing
    rocket.accel.fft()                  # spectra

This implementation evaluates directly against the ``Database`` store and
returns (time, values) numpy arrays — there is no SQL engine in the middle,
so every formula is a vectorized numpy op.

A host-only copy of ``elodin_tpu/db/eql.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from .storage import Database

# -- AST ---------------------------------------------------------------------


@dataclass
class Series:
    time: np.ndarray  # i64 us
    values: np.ndarray  # (n,) or (n, k)
    label: str

    def binop(self, other, fn, sym):
        if isinstance(other, Series):
            # align on timestamps (inner join)
            common, ia, ib = np.intersect1d(
                self.time, other.time, return_indices=True
            )
            return Series(
                common,
                fn(self.values[ia], other.values[ib]),
                f"({self.label} {sym} {other.label})",
            )
        return Series(self.time, fn(self.values, other), f"({self.label} {sym} {other})")


class _Parser:
    """Recursive-descent for the EQL grammar (eql/src/lib.rs peg block)."""

    TOKEN = re.compile(
        r"\s*(?:(?P<num>\d+\.\d+|\d+\.|\.\d+|\d+(?![\w.]))"
        r"|(?P<str>'[^']*'|\"[^\"]*\")|(?P<ident>[A-Za-z_][\w]*)"
        r"|(?P<op>[-+*/().\[\],]))"
    )

    def __init__(self, text: str):
        self.tokens = []
        pos = 0
        while pos < len(text):
            m = self.TOKEN.match(text, pos)
            if not m:
                if text[pos:].strip():
                    raise ValueError(f"EQL parse error at {text[pos:]!r}")
                break
            pos = m.end()
            if m.group("num"):
                self.tokens.append(("num", float(m.group("num"))))
            elif m.group("str"):
                self.tokens.append(("str", m.group("str")[1:-1]))
            elif m.group("ident"):
                self.tokens.append(("ident", m.group("ident")))
            else:
                self.tokens.append(("op", m.group("op")))
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else (None, None)

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def expect(self, op):
        kind, val = self.next()
        if kind != "op" or val != op:
            raise ValueError(f"EQL: expected {op!r}, got {val!r}")

    def expect_eof(self):
        kind, val = self.peek()
        if kind is not None:
            # trailing garbage after a complete expression must not be
            # silently ignored ('rocket.mach 2' is a malformed query,
            # not a query for rocket.mach)
            raise ValueError(f"EQL: unexpected trailing input at {val!r}")

    # expr := term (('+'|'-') term)*
    def expr(self):
        node = self.term()
        while self.peek() == ("op", "+") or self.peek() == ("op", "-"):
            _, op = self.next()
            node = ("binop", op, node, self.term())
        return node

    def term(self):
        node = self.postfix()
        while self.peek() == ("op", "*") or self.peek() == ("op", "/"):
            _, op = self.next()
            node = ("binop", op, node, self.postfix())
        return node

    # postfix := atom ( '.' ident [ '(' args ')' ] | '[' num ']' )*
    def postfix(self):
        node = self.atom()
        while True:
            kind, val = self.peek()
            if (kind, val) == ("op", "."):
                self.next()
                k2, name = self.next()
                if k2 != "ident":
                    raise ValueError("EQL: expected identifier after '.'")
                if self.peek() == ("op", "("):
                    self.next()
                    args = []
                    while self.peek() != ("op", ")"):
                        args.append(self.expr())
                        if self.peek() == ("op", ","):
                            self.next()
                    self.expect(")")
                    node = ("call", name, node, args)
                else:
                    node = ("field", node, name)
            elif (kind, val) == ("op", "["):
                self.next()
                k2, idx = self.next()
                if k2 != "num":
                    raise ValueError("EQL: expected index")
                self.expect("]")
                node = ("index", node, int(idx))
            else:
                return node

    def atom(self):
        kind, val = self.next()
        if (kind, val) == ("op", "-"):
            # unary minus: -x parses as (0 - x) over the postfix expression
            return ("binop", "-", ("num", 0.0), self.postfix())
        if kind == "num":
            return ("num", val)
        if kind == "str":
            return ("str", val)
        if kind == "ident":
            return ("ident", val)
        if (kind, val) == ("op", "("):
            node = self.expr()
            self.expect(")")
            return node
        raise ValueError(f"EQL: unexpected token {val!r}")


# -- formulas (eql/src/formulas/) -------------------------------------------


def _f_norm(s: Series, args):
    v = np.linalg.norm(np.atleast_2d(s.values.T).T, axis=-1)
    return Series(s.time, v, f"{s.label}.norm()")


def _f_abs(s, args):
    return Series(s.time, np.abs(s.values), f"{s.label}.abs()")


def _f_sqrt(s, args):
    return Series(s.time, np.sqrt(s.values), f"{s.label}.sqrt()")


def _f_sign(s, args):
    return Series(s.time, np.sign(s.values), f"{s.label}.sign()")


def _f_degrees(s, args):
    return Series(s.time, np.degrees(s.values), f"{s.label}.degrees()")


def _f_radians(s, args):
    return Series(s.time, np.radians(s.values), f"{s.label}.radians()")


def _f_arccos(s, args):
    return Series(s.time, np.arccos(np.clip(s.values, -1, 1)), f"{s.label}.arccos()")


def _f_clip(s, args):
    lo, hi = args
    return Series(s.time, np.clip(s.values, lo, hi), f"{s.label}.clip()")


def _f_atan2(s, args):
    (other,) = args
    if isinstance(other, Series):
        common, ia, ib = np.intersect1d(s.time, other.time, return_indices=True)
        return Series(
            common, np.arctan2(s.values[ia], other.values[ib]), f"{s.label}.atan2()"
        )
    return Series(s.time, np.arctan2(s.values, other), f"{s.label}.atan2()")


def _f_time_slice(s, args):
    lo, hi = args
    t0 = s.time[0] if len(s.time) else 0
    mask = (s.time >= t0 + lo * 1e6) & (s.time < t0 + hi * 1e6)
    return Series(s.time[mask], s.values[mask], f"{s.label}.time_slice()")


def _f_fft(s, args):
    spec = np.abs(np.fft.rfft(s.values, axis=0))
    return Series(np.arange(len(spec)), spec, f"{s.label}.fft()")


def _f_fftfreq(s, args):
    dt = np.median(np.diff(s.time)) * 1e-6 if len(s.time) > 1 else 1.0
    freqs = np.fft.rfftfreq(len(s.time), dt)
    return Series(np.arange(len(freqs)), freqs, f"{s.label}.fftfreq()")


def _f_angular(s, args):
    return Series(s.time, s.values[..., :4] if s.values.ndim > 1 and s.values.shape[-1] == 7 else s.values[..., :3], f"{s.label}.angular()")


def _f_linear(s, args):
    k = s.values.shape[-1]
    return Series(s.time, s.values[..., 4:] if k == 7 else s.values[..., 3:], f"{s.label}.linear()")


def _quat_rotate_np(q, v):
    """Rotate vectors v (...,3) by quaternions q (...,4) [x,y,z,w]."""
    import numpy as _np

    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * _np.cross(xyz, v)
    return v + w * t + _np.cross(xyz, t)


def _axis_quat(axis_idx, angle_deg):
    import numpy as _np

    half = _np.radians(float(angle_deg)) / 2.0
    q = _np.zeros(4)
    q[axis_idx] = _np.sin(half)
    q[3] = _np.cos(half)
    return q


def _quat_mul_np(a, b):
    import numpy as _np

    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return _np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def _f_cast(s, args):
    """series.cast('f32') — dtype conversion (formulas/cast.rs)."""
    import numpy as _np

    ty = str(args[0]).strip().strip("'\"").lower()
    dt = {
        "u8": "u1", "uint8": "u1", "u16": "<u2", "uint16": "<u2",
        "u32": "<u4", "uint32": "<u4", "u64": "<u8", "uint64": "<u8",
        "i8": "i1", "int8": "i1", "i16": "<i2", "int16": "<i2",
        "i32": "<i4", "int32": "<i4", "i64": "<i8", "int64": "<i8",
        "bool": "?", "f32": "<f4", "float32": "<f4",
        "f64": "<f8", "float64": "<f8",
    }[ty]
    return Series(s.time, s.values.astype(_np.dtype(dt)), f"{s.label}.cast({ty})")


def _f_direction(s, args):
    """pose.direction(x, y, z): body direction -> world frame
    (formulas/direction.rs)."""
    import numpy as _np

    v = _np.asarray([float(a) for a in args[:3]])
    n = _np.linalg.norm(v)
    v = v / n if n > 0 else v
    q = s.values[..., :4]
    out = _quat_rotate_np(q, _np.broadcast_to(v, q.shape[:-1] + (3,)))
    return Series(s.time, out, f"{s.label}.direction(...)")


def _rotate_body_axis(s, args, axis_idx, name):
    """Rotate the pose attitude about its own BODY axis by degrees
    (formulas/rotate.rs rotate_x/y/z: post-multiply; position unchanged)."""
    import numpy as _np

    q_rot = _axis_quat(axis_idx, args[0])
    vals = _np.array(s.values, copy=True)
    if vals.shape[-1] == 7:
        vals[..., :4] = _quat_mul_np(
            vals[..., :4], _np.broadcast_to(q_rot, vals[..., :4].shape)
        )
    else:
        vals = _quat_rotate_np(
            _np.broadcast_to(q_rot, vals.shape[:-1] + (4,)), vals
        )
    return Series(s.time, vals, f"{s.label}.{name}({args[0]})")


def _rotate_axis(s, args, axis_idx, name):
    """Rotate a pose (7) or vector (3) about a WORLD axis by degrees
    (formulas/rotate_world.rs)."""
    import numpy as _np

    q_rot = _axis_quat(axis_idx, args[0])
    vals = _np.array(s.values, copy=True)
    if vals.shape[-1] == 7:
        vals[..., :4] = _quat_mul_np(
            _np.broadcast_to(q_rot, vals[..., :4].shape), vals[..., :4]
        )
        vals[..., 4:] = _quat_rotate_np(
            _np.broadcast_to(q_rot, vals[..., :4].shape), vals[..., 4:]
        )
    else:
        vals = _quat_rotate_np(
            _np.broadcast_to(q_rot, vals.shape[:-1] + (4,)), vals
        )
    return Series(s.time, vals, f"{s.label}.{name}({args[0]})")


def _f_rotate_x(s, args):
    return _rotate_body_axis(s, args, 0, "rotate_x")


def _f_rotate_y(s, args):
    return _rotate_body_axis(s, args, 1, "rotate_y")


def _f_rotate_z(s, args):
    return _rotate_body_axis(s, args, 2, "rotate_z")


def _f_rotate_world_x(s, args):
    return _rotate_axis(s, args, 0, "rotate_world_x")


def _f_rotate_world_y(s, args):
    return _rotate_axis(s, args, 1, "rotate_world_y")


def _f_rotate_world_z(s, args):
    return _rotate_axis(s, args, 2, "rotate_world_z")


def _f_rotate_world(s, args):
    """pose.rotate_world(rx, ry, rz) degrees, applied extrinsically in
    x, y, z order (formulas/rotate_world.rs RotateWorld)."""
    out = _rotate_axis(s, [args[0]], 0, "rotate_world_x")
    out = _rotate_axis(out, [args[1]], 1, "rotate_world_y")
    return _rotate_axis(out, [args[2]], 2, "rotate_world")


def _f_translate(s, args):
    """pose.translate(x, y, z): offset in the BODY frame
    (formulas/translate.rs)."""
    import numpy as _np

    off = _np.asarray([float(a) for a in args[:3]])
    vals = _np.array(s.values, copy=True)
    vals[..., 4:] = vals[..., 4:] + _quat_rotate_np(
        vals[..., :4], _np.broadcast_to(off, vals[..., 4:].shape)
    )
    return Series(s.time, vals, f"{s.label}.translate(...)")


def _f_translate_world(s, args):
    """pose.translate_world(x, y, z): offset in the WORLD frame
    (formulas/translate_world.rs)."""
    import numpy as _np

    off = _np.asarray([float(a) for a in args[:3]])
    vals = _np.array(s.values, copy=True)
    vals[..., 4:] = vals[..., 4:] + off
    return Series(s.time, vals, f"{s.label}.translate_world(...)")



FORMULAS = {
    "norm": _f_norm,
    "abs": _f_abs,
    "sqrt": _f_sqrt,
    "sign": _f_sign,
    "degrees": _f_degrees,
    "radians": _f_radians,
    "arccos": _f_arccos,
    "clip": _f_clip,
    "atan2": _f_atan2,
    "time_slice": _f_time_slice,
    "fft": _f_fft,
    "fftfreq": _f_fftfreq,
    "angular": _f_angular,
    "linear": _f_linear,
    "cast": _f_cast,
    "direction": _f_direction,
    "rotate_x": _f_rotate_x,
    "rotate_y": _f_rotate_y,
    "rotate_z": _f_rotate_z,
    "rotate_world_x": _f_rotate_world_x,
    "rotate_world_y": _f_rotate_world_y,
    "rotate_world_z": _f_rotate_world_z,
    "rotate_world": _f_rotate_world,
    "translate": _f_translate,
    "translate_world": _f_translate_world,
}


# -- evaluation --------------------------------------------------------------


class Context:
    """EQL evaluation context over a Database (eql Context, lib.rs:555)."""

    def __init__(self, db: Database):
        self.db = db

    def _component(self, path: str) -> Series:
        store = self.db.by_name(path)
        if store is None:
            raise KeyError(f"component {path!r} not found")
        n = store.len
        values = store.values[:n]
        if store.elem_count == 1:
            values = values[:, 0]
        elif store.shape:
            values = values.reshape((n,) + store.shape)
        return Series(store.timestamps[:n].copy(), values.copy(), path)

    def _element(self, path: str, label: str) -> Series | None:
        """Resolve a trailing path part as an element label (e.g.
        `pos.x` with element_names metadata)."""
        store = self.db.by_name(path)
        if store is None:
            return None
        labels = (store.metadata.get("element_names") or "").split(",")
        if label not in labels:
            return None
        idx = labels.index(label)
        n = store.len
        return Series(
            store.timestamps[:n].copy(),
            store.values[:n, idx].copy(),
            f"{path}.{label}",
        )

    def eval(self, node):
        kind = node[0]
        if kind == "num":
            return node[1]
        if kind == "str":
            return node[1]
        if kind == "ident":
            return ("path", node[1])
        if kind == "field":
            base = self.eval(node[1])
            if isinstance(base, tuple) and base[0] == "path":
                path = f"{base[1]}.{node[2]}"
                if self.db.by_name(path) is not None:
                    return ("path", path)
                elem = self._element(base[1], node[2])
                if elem is not None:
                    return elem
                return ("path", path)  # may resolve with more parts
            raise ValueError(f"cannot access field {node[2]} of {base}")
        if kind == "index":
            s = self._resolve(self.eval(node[1]))
            return Series(s.time, s.values[..., node[2]], f"{s.label}[{node[2]}]")
        if kind == "call":
            name = node[1]
            target = self._resolve(self.eval(node[2]))
            fn = FORMULAS.get(name)
            if fn is None:
                raise KeyError(f"unknown EQL formula {name!r}")
            args = [
                self._resolve_or_scalar(self.eval(a)) for a in node[3]
            ]
            return fn(target, args)
        if kind == "binop":
            op = node[1]
            a = self._resolve_or_scalar(self.eval(node[2]))
            b = self._resolve_or_scalar(self.eval(node[3]))
            ops = {
                "+": (np.add, "+"),
                "-": (np.subtract, "-"),
                "*": (np.multiply, "*"),
                "/": (np.divide, "/"),
            }
            fn, sym = ops[op]
            if isinstance(a, Series):
                return a.binop(b, fn, sym)
            if isinstance(b, Series):
                return Series(b.time, fn(a, b.values), f"({a} {sym} {b.label})")
            return fn(a, b)
        raise ValueError(f"bad node {node}")

    def _resolve(self, v) -> Series:
        if isinstance(v, tuple) and v[0] == "path":
            return self._component(v[1])
        if isinstance(v, Series):
            return v
        raise ValueError(f"expected a component series, got {v}")

    def _resolve_or_scalar(self, v):
        if isinstance(v, tuple) and v[0] == "path":
            return self._component(v[1])
        return v

    def query(self, text: str) -> Series:
        p = _Parser(text)
        node = p.expr()
        p.expect_eof()
        out = self.eval(node)
        return self._resolve(out) if not isinstance(out, Series) else out


def eql(db: Database, text: str) -> Series:
    return Context(db).query(text)


# -- EQL -> SQL compilation (eql/src/lib.rs:23-47 compiles to DataFusion
# SQL; here the target is the sqlite engine in db/sql.py) -------------------


class _SqlCompiler:
    """Compiles the SQL-expressible EQL subset (component paths, element
    selection, arithmetic, scalar formulas) to one SELECT over the
    component tables joined on time.  Formulas that need whole-series
    context (fft, time_slice, spatial rotations) stay on the numpy
    evaluator — ``to_sql`` raises ValueError for them and callers fall
    back to ``eql()``."""

    def __init__(self, db: Database):
        self.db = db
        self.tables: list[str] = []  # join order

    def _table(self, store) -> str:
        from .sql import sanitize_sql_table_name

        name = sanitize_sql_table_name(store.name or f"c_{store.component_id:x}")
        if name not in self.tables:
            self.tables.append(name)
        return name

    def _elem_cols(self, store) -> list[str]:
        from .sql import _element_columns

        return _element_columns(store)

    def _path_of(self, node) -> str | None:
        if node[0] == "ident":
            return node[1]
        if node[0] == "field" and (base := self._path_of(node[1])) is not None:
            return f"{base}.{node[2]}"
        return None

    def _resolve(self, node):
        """-> (store, element_index|None) for a path node.

        Raises ValueError (the documented not-SQL-expressible signal, so
        callers' eql() fallbacks engage) for computed expressions and for
        unknown components alike."""
        path = self._path_of(node)
        if path is None:
            raise ValueError(
                "EQL->SQL: norm()/indexing of a computed expression is "
                "not SQL-expressible"
            )
        store = self.db.by_name(path)
        if store is not None:
            return store, None
        if "." in path:
            base, label = path.rsplit(".", 1)
            store = self.db.by_name(base)
            if store is not None:
                labels = (store.metadata.get("element_names") or "").split(",")
                if label in labels:
                    return store, labels.index(label)
        raise ValueError(f"component {path!r} not found")

    def compile(self, node) -> str:
        kind = node[0]
        if kind == "num":
            return repr(node[1])
        if kind in ("ident", "field"):
            store, idx = self._resolve(node)
            cols = self._elem_cols(store)
            if idx is None:
                if len(cols) != 1:
                    raise ValueError(
                        f"{store.name}: vector component needs an element "
                        "selector or norm() in SQL context"
                    )
                idx = 0
            return f'"{self._table(store)}"."{cols[idx]}"'
        if kind == "index":
            store, _ = self._resolve(node[1])
            cols = self._elem_cols(store)
            return f'"{self._table(store)}"."{cols[node[2]]}"'
        if kind == "binop":
            return (
                f"({self.compile(node[2])} {node[1]} {self.compile(node[3])})"
            )
        if kind == "call":
            name, target, args = node[1], node[2], node[3]
            if name == "norm":
                store, idx = self._resolve(target)
                cols = self._elem_cols(store)
                t = self._table(store)
                if idx is not None:
                    # norm() of a single selected element is |x| — summing
                    # over ALL element columns would silently disagree
                    # with the numpy evaluator
                    return f'abs("{t}"."{cols[idx]}")'
                terms = " + ".join(
                    f'"{t}"."{c}" * "{t}"."{c}"' for c in cols
                )
                return f"sqrt({terms})"
            simple = {
                "abs": "abs", "sqrt": "sqrt", "sign": "sign",
                "degrees": "degrees", "radians": "radians",
                "arccos": "acos",
            }
            if name in simple:
                return f"{simple[name]}({self.compile(target)})"
            if name == "atan2":
                return (
                    f"atan2({self.compile(target)}, {self.compile(args[0])})"
                )
            if name == "clip":
                lo, hi = self.compile(args[0]), self.compile(args[1])
                return f"max({lo}, min({hi}, {self.compile(target)}))"
            raise ValueError(f"EQL formula {name!r} is not SQL-expressible")
        raise ValueError(f"EQL->SQL: unsupported node {node[0]!r}")


def to_sql(db: Database, text: str, label: str = "value") -> str:
    """Compile an EQL expression to a SQL query over the component tables
    (joined on time when it spans several components)."""
    p = _Parser(text)
    node = p.expr()
    p.expect_eof()
    c = _SqlCompiler(db)
    expr = c.compile(node)
    if not c.tables:
        raise ValueError("EQL expression references no components")
    base = c.tables[0]
    joins = "".join(
        f' JOIN "{t}" USING (time)' for t in c.tables[1:]
    )
    return (
        f'SELECT "{base}".time AS time, {expr} AS {label} '
        f'FROM "{base}"{joins} ORDER BY "{base}".time'
    )


def eql_sql(db: Database, text: str):
    """Run an EQL expression through the SQL engine; returns a pyarrow
    table (falls back to the numpy evaluator via ``eql`` when the
    expression uses non-SQL formulas)."""
    from .sql import run_sql

    try:
        sql = to_sql(db, text)
    except ValueError:
        # non-SQL-expressible formula (fft, time_slice, rotate_*, computed
        # norms): evaluate with the numpy path and present the same shape
        import pyarrow as pa

        s = eql(db, text)
        import numpy as _np

        vals = _np.asarray(s.values)
        cols = {"time": pa.array(_np.asarray(s.time, dtype="<i8"),
                                 type=pa.timestamp("us"))}
        if vals.ndim == 1:
            cols[s.label] = pa.array(vals)
        else:
            for i in range(vals.shape[1]):
                cols[f"{s.label}[{i}]"] = pa.array(vals[:, i])
        return pa.table(cols)

    return run_sql(db, sql)
