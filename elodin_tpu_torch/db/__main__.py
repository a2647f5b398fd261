"""elodin-db command line (parity: reference `elodin-db` binary,
libs/db/src/main.rs — run, export, merge, trim, compact, plus gen-cpp from
libs/db/cli).

Usage:
    python -m elodin_tpu_torch db run [path] [--addr HOST:PORT]
    python -m elodin_tpu_torch db query <path> --sql "SELECT ..." | --eql expr [--precision full]
    python -m elodin_tpu_torch db bench [--rows N]
    python -m elodin_tpu_torch db export <path> --output DIR [--format csv|parquet|arrow] [--join]
    python -m elodin_tpu_torch db merge <dst> <src...>
    python -m elodin_tpu_torch db trim <path> --start-us N --stop-us N
    python -m elodin_tpu_torch db compact <path>
    python -m elodin_tpu_torch db list <path>
    python -m elodin_tpu_torch db gen-cpp <path> --output header.hpp

A host-only copy of ``elodin_tpu/db/__main__.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from .storage import Database


def cmd_run(args):
    from .server import Server

    db = Database(args.path)
    srv = Server(db, args.addr).start()
    print(f"elodin-db listening on 127.0.0.1:{srv.port} (path={args.path})")
    if getattr(srv, "assets_http", None) is not None:
        print(f"web viewer at http://127.0.0.1:{srv.assets_http.port}/")
    follower = None
    if args.follows:
        from .follow import Follower

        follower = Follower(db, args.follows, server=srv)
        print(f"following {args.follows} (replicating all data)")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        if follower is not None:
            follower.stop()
        srv.stop()


def _render_table(headers: list[str], rows: list[list[str]]) -> str:
    """Rounded box-drawing table, matching the reference `elodin-db query`
    output format (libs/db/tests_query/query_cli_goldie.rs goldens)."""
    widths = [
        max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
        for i, h in enumerate(headers)
    ]

    def line(left, mid, right):
        return left + mid.join("─" * (w + 2) for w in widths) + right

    def row(cells):
        return "│" + "│".join(
            f" {c:<{w}} " for c, w in zip(cells, widths)
        ) + "│"

    out = [line("╭", "┬", "╮"), row(headers), line("├", "┼", "┤")]
    out += [row(r) for r in rows]
    out.append(line("╰", "┴", "╯"))
    return "\n".join(out) + "\n"


def _fmt_query_value(v, prim: str | None, precision: str) -> str:
    if prim == "bool":
        return "true" if float(v) != 0.0 else "false"
    if prim in ("u8", "u16", "u32", "u64", "i8", "i16", "i32", "i64"):
        return str(int(v))
    f = float(v)
    if precision == "full":
        s = repr(f)
        return s[:-2] if s.endswith(".0") and f == int(f) else s
    return f"{f:.6g}"


def cmd_query(args):
    """`elodin-db query --sql ... | --eql ... <path>` — pretty-printed
    query results (libs/db query CLI, golden-tested against the reference
    tests_query fixtures)."""
    db = Database(args.path)
    prim_by_col: dict[str, str] = {}
    from .sql import _element_columns

    for store in db.components.values():
        for col in _element_columns(store):
            prim_by_col[col] = store.prim

    if args.sql:
        from .sql import run_sql

        table = run_sql(db, args.sql)
        headers, columns = [], []
        for name in table.column_names:
            col = table[name]
            if name == "time" or name.endswith(".time"):
                headers.append("time (s)")
                import pyarrow as pa

                vals = col.cast(pa.int64()).to_pylist()
                columns.append([_fmt_query_value(v / 1e6, None, args.precision)
                                for v in vals])
            else:
                headers.append(name)
                prim = prim_by_col.get(name.rsplit(".", 1)[-1], None)
                columns.append(
                    [_fmt_query_value(v, prim, args.precision)
                     for v in col.to_pylist()]
                )
        rows = [list(r) for r in zip(*columns)] if columns else []
    else:
        from .eql import eql

        if not args.eql:
            raise SystemExit(
                "query: pass --sql <query> or --eql <expression>"
            )
        series = eql(db, args.eql)
        vals = np.atleast_2d(np.asarray(series.values).T).T
        width = vals.shape[1] if vals.ndim > 1 else 1
        # every element gets a column — printing only [0] silently lies
        # about vector components
        if width > 1:
            headers = ["time (s)"] + [
                f"{series.label}[{i}]" for i in range(width)
            ]
        else:
            headers = ["time (s)", series.label]
        rows = [
            [_fmt_query_value(t / 1e6, None, args.precision)]
            + [_fmt_query_value(v, None, args.precision)
               for v in np.atleast_1d(row)]
            for t, row in zip(series.time, vals)
        ]
    import sys as _sys

    _sys.stdout.write(_render_table(headers, rows))


def cmd_bench(args):
    """Ingest + fan-out throughput (parity: libs/db/src/bin/bench.rs):
    spins an ephemeral server, streams rows through a TableWriter, and
    reports rows/s with and without a live subscriber."""
    import json as _json
    import time as _time

    import numpy as _np

    from .client import Client, f64
    from .server import Server
    from .storage import Database

    db = Database(None)
    srv = Server(db, "127.0.0.1:0").start()
    try:
        addr = f"127.0.0.1:{srv.port}"
        client = Client.connect(addr)
        writer = client.table_writer(
            {"bench.pos": f64[3], "bench.vel": f64[3], "bench.alt": f64}
        )
        rows = int(args.rows)
        vals = {
            "bench.pos": _np.array([1.0, 2.0, 3.0]),
            "bench.vel": _np.array([0.1, 0.2, 0.3]),
            "bench.alt": 42.0,
        }
        # warm-up + store creation
        for i in range(100):
            writer.write(timestamp_us=i, values=vals)
        t0 = _time.perf_counter()
        for i in range(rows):
            writer.write(timestamp_us=100 + i, values=vals)
        # a read forces the server to have drained the ingest (the store
        # exists once the first row lands: until then the read is refused)
        deadline = _time.perf_counter() + 60
        while _time.perf_counter() < deadline:
            try:
                ts, _ = client.time_series("bench.alt", start_us=0)
            except RuntimeError:
                continue
            if len(ts) >= rows + 100:
                break
        ingest = rows / (_time.perf_counter() - t0)

        # vectorized bulk path: one numpy pack + one send for all rows
        t0 = _time.perf_counter()
        writer.write_batch(
            _np.arange(rows) + 1_000_000,
            {
                "bench.pos": _np.tile(vals["bench.pos"], (rows, 1)),
                "bench.vel": _np.tile(vals["bench.vel"], (rows, 1)),
                "bench.alt": _np.full(rows, 42.0),
            },
        )
        deadline = _time.perf_counter() + 60
        while _time.perf_counter() < deadline:
            ts, _ = client.time_series("bench.alt", start_us=0)
            if len(ts) >= 2 * rows + 100:
                break
        bulk = rows / (_time.perf_counter() - t0)

        # fan-out: a live real-time subscriber coalesces commits (the
        # server pushes the LATEST row per notify, queue drop-oldest), so
        # the honest number is updates delivered per second, bounded by a
        # drain with a timeout — never a blocking read
        import queue as _queue

        sub = client.stream(["bench.alt"], frequency=None)
        t0 = _time.perf_counter()
        for i in range(rows):
            writer.write(timestamp_us=10_000_000 + i, values=vals)
        got = 0
        # clock stops at the LAST delivered row: including the trailing
        # empty-queue timeout in the denominator understated fast runs ~6x
        last_t = _time.perf_counter()
        while True:
            try:
                sub._q.get(timeout=0.5)
                got += 1
                last_t = _time.perf_counter()
            except _queue.Empty:
                break
        fanout = got / max(last_t - t0, 1e-9)
        sub.close()
        writer.close()
        client.close()
        print(_json.dumps({
            "rows": rows,
            "ingest_rows_per_sec": round(ingest, 1),
            "bulk_ingest_rows_per_sec": round(bulk, 1),
            "fanout_rows_per_sec": round(fanout, 1),
        }))
    finally:
        srv.stop()


def cmd_export(args):
    from .export import export_csv_joined, save_archive

    db = Database(args.path)
    if args.format == "mcap":
        from .export_mcap import export_mcap

        out = Path(args.output)
        if not out.suffix:
            out.mkdir(parents=True, exist_ok=True)
            # name the archive after the database directory (export_mcap.rs
            # run(): {db_name}.mcap + {db_name}.foxglove-layout.json)
            out = out / f"{Path(args.path).name or 'elodin-db'}.mcap"
        n = export_mcap(
            db, str(out),
            pattern=args.pattern,
            include_private=args.include_private,
            all_assets=args.all_assets,
            epoch_offset_us=args.epoch_offset_us,
            max_embed_mb=args.max_embed_mb,
        )
        print(f"exported {n} messages -> {out}")
        return
    if args.join and args.format == "csv":
        Path(args.output).mkdir(parents=True, exist_ok=True)
        export_csv_joined(db, str(Path(args.output) / "joined.csv"),
                          include_private=args.include_private)
    else:
        save_archive(db, args.output, args.format,
                     include_private=args.include_private,
                     pattern=args.pattern, flatten=not args.no_flatten,
                     mono_ns=args.mono_ns,
                     fast_floats=args.csv_fast_floats)
    print(f"exported {len(db.components)} components -> {args.output}")


def cmd_merge(args):
    dst = Database(args.dst)
    total = 0
    touched = set()
    for src_path in args.src:
        src = Database(src_path)
        for cid, store in src.components.items():
            out = dst.get_or_create(cid, store.prim, store.shape, store.name)
            out.set_metadata(name=store.name, metadata=store.metadata)
            n = store.len
            if n:
                out.append_batch(store.timestamps[:n], store.values[:n])
                total += n
                touched.add(cid)
    # restore the sorted-timestamps invariant range()/searchsorted relies
    # on: overlapping recordings (or out-of-order sources) interleave
    for cid in touched:
        out = dst.components[cid]
        n = out.len
        ts = out.timestamps[:n]
        if n > 1 and (np.diff(ts) < 0).any():
            order = np.argsort(ts, kind="stable")
            out.timestamps[:n] = ts[order]
            out.values[:n] = out.values[:n][order]
            _rewrite(out)
    dst.flush()
    print(f"merged {total} rows from {len(args.src)} databases into {args.dst}")


def cmd_trim(args):
    db = Database(args.path)
    kept = 0
    for store in db.components.values():
        ts, values = store.range(args.start_us, args.stop_us)
        n = len(ts)
        store.timestamps = np.asarray(ts).copy()
        store.values = np.asarray(values).copy()
        store.len = n
        kept += n
        _rewrite(store)
    print(f"trimmed {args.path}: kept {kept} rows in [{args.start_us}, {args.stop_us})")


def cmd_compact(args):
    db = Database(args.path)
    for store in db.components.values():
        _rewrite(store)
    print(f"compacted {len(db.components)} components")


def _rewrite(store):
    """Rewrite a store's on-disk files to exactly its live rows."""
    if store.path is None:
        return
    n = store.len
    if store._native is not None:
        store._native.close()
        store._native = None
    (store.path / "timestamps.bin").unlink(missing_ok=True)
    (store.path / "data.bin").unlink(missing_ok=True)
    from ..native import NativeStore, available

    if available():
        ns = NativeStore(
            store.path / "timestamps.bin", store.path / "data.bin",
            store.row_nbytes,
        )
        if n:
            ns.append(store.timestamps[:n], store.values[:n])
        ns.close()
    else:
        with open(store.path / "timestamps.bin", "wb") as f:
            f.write(np.ascontiguousarray(store.timestamps[:n], dtype="<i8").tobytes())
        with open(store.path / "data.bin", "wb") as f:
            f.write(np.ascontiguousarray(store.values[:n], dtype=store.dtype).tobytes())


def cmd_list(args):
    db = Database(args.path)
    for store in sorted(db.components.values(), key=lambda s: s.name or ""):
        span = ""
        if store.len:
            t0, t1 = store.timestamps[0], store.timestamps[store.len - 1]
            span = f"  [{t0} .. {t1}]us"
        print(
            f"{store.name or hex(store.component_id):40} {store.prim}"
            f"{list(store.shape)}  {store.len} rows{span}"
        )


_PRIM_CPP = {
    "f64": "double", "f32": "float", "u64": "uint64_t", "u32": "uint32_t",
    "u16": "uint16_t", "u8": "uint8_t", "i64": "int64_t", "i32": "int32_t",
    "i16": "int16_t", "i8": "int8_t", "bool": "bool",
}


def cmd_gen_cpp(args):
    """Emit C++ bindings for the stored schema — writer wiring PLUS typed
    per-component row structs with a Row::write(...) aggregate (parity with
    the reference's RON-driven codegen, libs/postcard-c/codegen)."""
    db = Database(args.path)
    prim_names = {
        "f64": "F64", "f32": "F32", "u64": "U64", "u32": "U32", "u16": "U16",
        "u8": "U8", "i64": "I64", "i32": "I32", "i16": "I16", "i8": "I8",
        "bool": "Bool",
    }
    stores = [
        s for s in sorted(db.components.values(), key=lambda s: s.name or "")
        if s.name
    ]
    lines = [
        "// generated by elodin-db gen-cpp — do not edit",
        "#pragma once",
        '#include "elodin_db.hpp"',
        "",
    ]
    # typed row structs: one member per component, flattened element counts
    lines.append("struct Row {")
    members = []
    for store in stores:
        cpp = _PRIM_CPP[store.prim]
        ident = "".join(
            c if (c.isalnum() or c == "_") else "_" for c in store.name
        )
        n = store.elem_count
        decl = f"{cpp} {ident}" + (f"[{n}]" if n > 1 else "")
        lines.append(f"    {decl} = {{}};  // {store.name} {store.shape}")
        members.append((ident, n))
    lines += [
        "",
        "    void write(elodin::TableWriter& w, int64_t timestamp_us) {",
        "        w.write(timestamp_us, {",
    ]
    for ident, n in members:
        ref = f"&{ident}" if n == 1 else ident
        lines.append(f"            {ref},")
    lines += ["        });", "    }", "};", ""]

    lines += [
        "inline elodin::TableWriter make_writer(elodin::Client& client) {",
        "    return elodin::TableWriter(client, {",
    ]
    for store in stores:
        shape = ", ".join(str(s) for s in store.shape)
        lines.append(
            f'        {{"{store.name}", elodin::PrimType::'
            f"{prim_names[store.prim]}, {{{shape}}}}},"
        )
    lines += ["    });", "}", ""]
    out = Path(args.output)
    out.write_text("\n".join(lines))
    print(f"wrote {out} ({len(stores)} components)")


WALLCLOCK_MIN_US = 946_684_800_000_000  # 2000-01-01: below this = monotonic


def cmd_prune(args):
    """Remove empty components (parity: libs/db/src/prune.rs — dry-run and
    auto-confirm semantics; empty = zero committed rows)."""
    import shutil

    db = Database(args.path)
    empty = [s for s in db.components.values() if s.len == 0 and s.path]
    if not empty:
        print("nothing to prune")
        return
    for store in empty:
        label = store.name or f"{store.component_id:016x}"
        if args.dry_run:
            print(f"would prune {label} ({store.path})")
        else:
            if store._native is not None:
                store._native.close()
                store._native = None
            shutil.rmtree(store.path)
            print(f"pruned {label}")
    if args.dry_run:
        print(f"{len(empty)} empty components (dry run, nothing removed)")
    else:
        print(f"pruned {len(empty)} empty components")


def cmd_fix_timestamps(args):
    """Shift monotonic-clock component series onto the wall-clock timeline
    (parity: libs/db/src/fix_timestamps.rs — components stamped with
    device-boot time are aligned so their last sample matches the latest
    wall-clock sample)."""
    db = Database(args.path)
    wall = [s for s in db.components.values()
            if s.len and s.timestamps[0] >= WALLCLOCK_MIN_US]
    mono = [s for s in db.components.values()
            if s.len and s.timestamps[0] < WALLCLOCK_MIN_US]
    if not mono:
        print("all components already wall-clock")
        return
    if not wall:
        print("no wall-clock reference components; aborting")
        return
    ref_last = max(int(s.timestamps[s.len - 1]) for s in wall)
    for store in mono:
        shift = ref_last - int(store.timestamps[store.len - 1])
        label = store.name or f"{store.component_id:016x}"
        if args.dry_run:
            print(f"would shift {label} by {shift} us")
            continue
        store.timestamps[: store.len] += shift
        _rewrite(store)
        print(f"shifted {label} by {shift} us")
    if not args.dry_run:
        print(f"fixed {len(mono)} components (reference last = {ref_last} us)")


def cmd_time_align(args):
    """Shift components so their first sample lands on a target timestamp
    (parity: libs/db/src/time_align.rs — fixes series written at the same
    real moment but stamped with different clock offsets)."""
    db = Database(args.path)
    target_us = int(args.target * 1_000_000)
    stores = [
        s for s in db.components.values()
        if s.len and (args.component is None
                      or s.name == args.component
                      or f"{s.component_id:016x}" == args.component)
    ]
    if not stores:
        print("no matching components with data")
        return
    for store in stores:
        shift = target_us - int(store.timestamps[0])
        label = store.name or f"{store.component_id:016x}"
        if shift == 0:
            continue
        if args.dry_run:
            print(f"would shift {label} by {shift} us ({store.len} rows)")
            continue
        store.timestamps[: store.len] += shift
        _rewrite(store)
        print(f"shifted {label} by {shift} us")
    if args.dry_run:
        print(f"{len(stores)} components inspected (dry run)")
    else:
        print(f"aligned {len(stores)} components to {target_us} us")


def cmd_export_videos(args):
    """Export H.264 video message logs to MP4 files (parity:
    libs/db/src/export_videos.rs — Annex-B logs are muxed directly; raw
    sensor-camera RGBA logs would need an H.264 encoder, which is not
    bundled, so they are dumped as .rgba.bin + a shape sidecar)."""
    import fnmatch
    import json as _json

    from .video import export_h264_log, find_nal, NAL_SPS

    db = Database(args.path)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    names = {}
    for mid, log in db.msg_logs.items():
        name = getattr(log.metadata, "name", None)
        names[mid] = name or mid.hex()
    exported = 0
    for mid, log in sorted(db.msg_logs.items(), key=lambda kv: names[kv[0]]):
        name = names[mid]
        if args.pattern and not fnmatch.fnmatch(name, args.pattern):
            continue
        if not log.entries:
            continue
        safe = name.replace("/", "_")
        if any(find_nal(p, NAL_SPS) for _, p in log.entries[:20]):
            stats = export_h264_log(
                log.entries, name, out_dir / f"{safe}.mp4", args.fps
            )
            if stats:
                print(
                    f"  {name}: {stats['frames']} frames, "
                    f"{stats['duration_s']:.1f}s, "
                    f"{stats['width']}x{stats['height']} @ {stats['fps']:g} fps"
                    f" -> {out_dir / (safe + '.mp4')}"
                )
                exported += 1
        elif args.raw:
            blob = b"".join(p for _, p in log.entries)
            (out_dir / f"{safe}.rgba.bin").write_bytes(blob)
            (out_dir / f"{safe}.rgba.json").write_text(
                _json.dumps({"frames": len(log.entries),
                             "frame_bytes": len(log.entries[0][1])})
            )
            print(f"  {name}: {len(log.entries)} raw frames (no SPS; "
                  "dumped .rgba.bin — no H.264 encoder bundled)")
            exported += 1
    if exported == 0:
        print("no video message logs found"
              + (f" matching {args.pattern!r}" if args.pattern else ""))
    else:
        print(f"exported {exported} video logs -> {out_dir}")


def cmd_truncate(args):
    """Clear all data from a database, preserving schemas and metadata
    (parity: libs/db/src/truncate.rs — component series and msg logs are
    emptied; schema.json / msg metadata stay so writers can resume)."""
    db = Database(args.path)
    rows = sum(s.len for s in db.components.values())
    msgs = sum(len(m.entries) for m in db.msg_logs.values())
    print(f"database {args.path}: {len(db.components)} components "
          f"({rows} rows), {len(db.msg_logs)} msg logs ({msgs} entries)")
    if rows == 0 and msgs == 0:
        print("database is already empty; nothing to truncate")
        return
    if args.dry_run:
        print(f"would clear {rows} rows + {msgs} msg entries (dry run)")
        return
    if not args.yes:
        print(f"refusing to clear {rows} rows + {msgs} msg entries without "
              "--yes (or use --dry-run to preview)")
        return
    for store in db.components.values():
        store.len = 0
        _rewrite(store)
    for log in db.msg_logs.values():
        log.entries.clear()
        if log._file is not None:
            log._file.close()
            log._file = open(log.path / "log.bin", "wb")
    print(f"truncated: cleared {rows} rows + {msgs} msg entries "
          "(schemas and metadata preserved)")


def _fuzzy_score(query: str, name: str) -> int | None:
    """Subsequence match score (parity: libs/db/src/drop.rs's SkimMatcherV2
    selection — exact > prefix > substring > subsequence; None = no match)."""
    q, n = query.lower(), name.lower()
    if q == n:
        return 1000
    if n.startswith(q):
        return 500
    if q in n:
        return 250
    pos = 0
    for ch in q:
        pos = n.find(ch, pos)
        if pos < 0:
            return None
        pos += 1
    return 100 - len(n)


def cmd_drop(args):
    """Drop (delete) components from a database with fuzzy / glob / --all
    selection (parity: libs/db/src/drop.rs)."""
    import fnmatch
    import shutil

    db = Database(args.path)
    stores = [s for s in db.components.values() if s.path]
    if not stores:
        print("no components found in database")
        return
    if args.all:
        matched = stores
    elif args.pattern:
        matched = [
            s for s in stores
            if fnmatch.fnmatch(s.name or f"{s.component_id:016x}", args.pattern)
        ]
    elif args.name:
        scored = [
            (s, _fuzzy_score(args.name, s.name or f"{s.component_id:016x}"))
            for s in stores
        ]
        scored = [(s, sc) for s, sc in scored if sc is not None]
        scored.sort(key=lambda t: -t[1])
        # exact/prefix matches drop just the best hit; otherwise every
        # subsequence match is shown and requires --yes to proceed
        matched = [s for s, sc in scored if sc >= scored[0][1]] if scored else []
    else:
        print("specify a component name, --pattern, or --all")
        return
    if not matched:
        print("no components matched")
        return
    total = sum(s.len for s in matched)
    ambiguous = (
        len(matched) > 1 and not (args.yes or args.all or args.pattern)
    )
    verb = "would drop" if (args.dry_run or ambiguous) else "drop"
    for s in matched:
        print(f"{verb} {s.name or hex(s.component_id)} ({s.len} rows)")
    if args.dry_run:
        print(f"{len(matched)} components, {total} rows (dry run)")
        return
    if ambiguous:
        print(f"{len(matched)} fuzzy matches; pass --yes to drop all of them "
              "or narrow the name")
        return
    for s in matched:
        if s._native is not None:
            s._native.close()
            s._native = None
        if s._ts_file is not None:
            s._ts_file.close()
            s._data_file.close()
        shutil.rmtree(s.path)
        del db.components[s.component_id]
    print(f"dropped {len(matched)} components ({total} rows)")


def cmd_info(args):
    """Display information about a database (parity: libs/db/src/main.rs
    Info command — counts, size on disk, time span)."""
    db = Database(args.path)
    rows = sum(s.len for s in db.components.values())
    msgs = sum(len(m.entries) for m in db.msg_logs.values())
    nbytes = sum(
        f.stat().st_size
        for f in Path(args.path).rglob("*") if f.is_file()
    )
    spans = [
        (int(s.timestamps[0]), int(s.timestamps[s.len - 1]))
        for s in db.components.values() if s.len
    ]
    print(f"path:         {args.path}")
    print(f"components:   {len(db.components)} ({rows} rows)")
    print(f"msg logs:     {len(db.msg_logs)} ({msgs} entries)")
    print(f"assets:       {len(db.assets.mem)}")
    print(f"size on disk: {nbytes / 1e6:.2f} MB")
    if spans:
        t0 = min(t for t, _ in spans)
        t1 = max(t for _, t in spans)
        print(f"time span:    [{t0} .. {t1}] us ({(t1 - t0) / 1e6:.3f} s)")


def cmd_repl(args):
    """Interactive DB console (parity: `elodin-db lua` REPL + script runner,
    libs/db/src/main.rs:28-29 and libs/db/cli/src/lib.rs:681-814 — the
    reference embeds Lua; the TPU rebuild drops into Python with the same
    vocabulary: connect, message constructors, sql, streams)."""
    import code

    from . import Client, Field, f32, f64, sql_table_name
    from . import msgs as M
    from .postcard import msg_id
    from .vtable import VTableBuilder, component_id_of

    ns = {
        "connect": Client.connect,
        "Client": Client,
        "Field": Field,
        "f64": f64,
        "f32": f32,
        "msgs": M,
        "ComponentId": component_id_of,
        "msg_id": msg_id,
        "SQLQuery": M.SQLQuery,
        "Stream": M.Stream,
        "MsgStream": M.MsgStream,
        "UdpUnicast": M.UdpUnicast,
        "SetComponentMetadata": M.SetComponentMetadata,
        "VTableBuilder": VTableBuilder,
        "sql_table_name": sql_table_name,
        "np": np,
    }
    if args.addr:
        ns["client"] = Client.connect(args.addr)
    banner = (
        f"elodin-db repl (python) — client={'connected ' + args.addr if args.addr else 'use connect(addr)'}\n"
        "names: connect, client, Field, f64/f32, msgs, ComponentId, "
        "VTableBuilder, sql_table_name"
    )
    if args.script:
        src = Path(args.script).read_text()
        exec(compile(src, args.script, "exec"), ns)
        return
    code.interact(banner=banner, local=ns)


def main(argv=None):
    p = argparse.ArgumentParser(prog="elodin-db")
    sub = p.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run")
    run_p.add_argument("path", nargs="?", default=None)
    run_p.add_argument("--addr", default="127.0.0.1:2240")
    run_p.add_argument("--follows", default=None, metavar="ADDR",
                       help="follow another elodin-db instance, "
                            "replicating all data")
    run_p.set_defaults(fn=cmd_run)

    bench_p = sub.add_parser("bench", help="ingest/fan-out throughput")
    bench_p.add_argument("--rows", type=int, default=20000)
    bench_p.set_defaults(fn=cmd_bench)

    qry = sub.add_parser("query", help="run a SQL/EQL query, pretty-print")
    qry.add_argument("path")
    qry.add_argument("--sql", default=None)
    qry.add_argument("--eql", default=None)
    qry.add_argument("--precision", default="short",
                     choices=("short", "full"))
    qry.set_defaults(fn=cmd_query)

    exp = sub.add_parser("export")
    exp.add_argument("path")
    exp.add_argument("--output", required=True)
    exp.add_argument("--format", default="csv")
    exp.add_argument("--join", action="store_true")
    exp.add_argument("--no-flatten", action="store_true",
                     help="keep vector components as one array column")
    exp.add_argument("--mono-ns", action="store_true")
    exp.add_argument("--csv-fast-floats", action="store_true")
    exp.add_argument("--pattern", default=None)
    exp.add_argument("--include-private", action="store_true")
    exp.add_argument("--all-assets", action="store_true",
                     help="attach every db asset to the MCAP, not just "
                          "schematic-referenced ones")
    exp.add_argument("--epoch-offset-us", type=int, default=None,
                     help="microsecond offset added to all timestamps in "
                          "the MCAP export (auto-rebases pre-1970 data)")
    exp.add_argument("--max-embed-mb", type=int, default=32,
                     help="largest GLB (MiB) to base64-embed in SceneUpdate")
    exp.set_defaults(fn=cmd_export)

    mrg = sub.add_parser("merge")
    mrg.add_argument("dst")
    mrg.add_argument("src", nargs="+")
    mrg.set_defaults(fn=cmd_merge)

    trim = sub.add_parser("trim")
    trim.add_argument("path")
    trim.add_argument("--start-us", type=int, default=-(2**62))
    trim.add_argument("--stop-us", type=int, default=2**62)
    trim.set_defaults(fn=cmd_trim)

    comp = sub.add_parser("compact")
    comp.add_argument("path")
    comp.set_defaults(fn=cmd_compact)

    lst = sub.add_parser("list")
    lst.add_argument("path")
    lst.set_defaults(fn=cmd_list)

    gen = sub.add_parser("gen-cpp")
    gen.add_argument("path")
    gen.add_argument("--output", required=True)
    gen.set_defaults(fn=cmd_gen_cpp)

    prune = sub.add_parser("prune", help="remove empty components")
    prune.add_argument("path")
    prune.add_argument("--dry-run", action="store_true")
    prune.add_argument("--yes", action="store_true")
    prune.set_defaults(fn=cmd_prune)

    fixts = sub.add_parser("fix-timestamps",
                           help="align monotonic series to wall clock")
    fixts.add_argument("path")
    fixts.add_argument("--dry-run", action="store_true")
    fixts.set_defaults(fn=cmd_fix_timestamps)

    ta = sub.add_parser("time-align",
                        help="align first samples to a target timestamp")
    ta.add_argument("path")
    ta.add_argument("--target", type=float, required=True,
                    help="target timestamp in seconds")
    ta.add_argument("--component", default=None)
    ta.add_argument("--dry-run", action="store_true")
    ta.set_defaults(fn=cmd_time_align)

    ev = sub.add_parser("export-videos",
                        help="export H.264 msg logs to MP4 files")
    ev.add_argument("path")
    ev.add_argument("--output", "-o", required=True)
    ev.add_argument("--pattern", default=None,
                    help="filter message logs by name glob")
    ev.add_argument("--fps", type=float, default=30.0,
                    help="frame rate when SPS has no timing_info")
    ev.add_argument("--raw", action="store_true",
                    help="also dump non-H.264 logs as raw frame blobs")
    ev.set_defaults(fn=cmd_export_videos)

    trunc = sub.add_parser(
        "truncate", help="clear all data, preserving schemas and metadata")
    trunc.add_argument("path")
    trunc.add_argument("--dry-run", action="store_true")
    trunc.add_argument("--yes", action="store_true")
    trunc.set_defaults(fn=cmd_truncate)

    drp = sub.add_parser("drop", help="drop (delete) components")
    drp.add_argument("path")
    drp.add_argument("name", nargs="?", default=None,
                     help="component name (fuzzy matched)")
    drp.add_argument("--pattern", default=None, help="glob pattern")
    drp.add_argument("--all", action="store_true")
    drp.add_argument("--dry-run", action="store_true")
    drp.add_argument("--yes", action="store_true")
    drp.set_defaults(fn=cmd_drop)

    info = sub.add_parser("info", help="display database information")
    info.add_argument("path")
    info.set_defaults(fn=cmd_info)

    repl = sub.add_parser("repl", help="interactive console / script runner")
    repl.add_argument("addr", nargs="?", default=None)
    repl.add_argument("--script", default=None)
    repl.set_defaults(fn=cmd_repl)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
