"""Browser-based live telemetry viewer served from the DB's HTTP port.

Parity: the data-facing core of libs/elodin-editor — component browser,
live time-series plots, value readouts, playback over recorded ranges — as a
dependency-free single-page app.  The reference editor is a native Bevy app
(libs/elodin-editor/src/ui/plot/, ui/tiles.rs); its 3D viewport is out of
scope here, but every query it makes (DumpMetadata, GetTimeSeries,
SparklineQuery-style downsampling) has a JSON mirror under ``/api/*`` so a
browser can attach to any running sim or recorded DB:

- ``GET /``                  — the viewer app (no external assets)
- ``GET /api/info``          — DB summary (counts, time span)
- ``GET /api/components``    — name/prim/shape/rows/metadata/latest
- ``GET /api/series``        — LTTB-downsampled series (name, start_us,
  stop_us, max_points)
- ``GET /api/latest``        — newest sample for one component
- ``GET /api/scene``         — the MCAP exporter's SceneUpdate entities,
  live (object_3d models, line_3d trajectories, vector arrows, follow
  entity) for 3D clients
- ``GET /api/drawlist``      — the scene pre-digested into flat draw
  descriptors + camera framing (db/scenemath.py — the server-side single
  implementation of the viewer's scene logic; scene3d.js renders it
  verbatim)
- ``GET /api/glb?url=``      — a GLB asset parsed into upload-ready
  primitives (base64 vertex blobs)
- ``GET /api/geoms``         — unit cube/sphere/cylinder/cone tessellations
- ``GET /api/videos``        — H.264 msg logs playable in the browser
- ``GET /api/video?id=``     — one log muxed to MP4 on demand (the
  browser's own hardware decoder replaces the reference's editor-side
  video-toolbox decode path)

Routes are registered into ``AssetHttpServer.routes`` (db/assets.py), so the
viewer rides the same port the asset store already serves.

A host-only copy of ``elodin_tpu/db/webui.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from .downsample import lttb


def _qint(query, key, default):
    """Parse a numeric query param robustly: the JS timeline sends
    fractional microsecond values (scrub/playback interpolation), and
    int("...5") would 500 every poll while scrubbing."""
    try:
        return int(float(query.get(key, default)))
    except (TypeError, ValueError):
        return int(default)


def _finite(o):
    """NaN/Inf are not valid JSON (browser JSON.parse rejects the bare
    tokens json.dumps emits) — map them to null, which plots render as a
    gap instead of the whole response failing to parse."""
    if isinstance(o, float):
        return o if math.isfinite(o) else None
    if isinstance(o, list):
        return [_finite(x) for x in o]
    if isinstance(o, dict):
        return {k: _finite(v) for k, v in o.items()}
    return o


def _json_resp(obj) -> tuple[int, str, bytes]:
    return 200, "application/json", json.dumps(_finite(obj)).encode()


def register_routes(routes: dict, db) -> None:
    def api_info(path, query):
        with db.lock:
            comps = list(db.components.values())
            rows = sum(c.len for c in comps)
            msgs = sum(len(m.entries) for m in db.msg_logs.values())
            spans = [
                (int(c.timestamps[0]), int(c.timestamps[c.len - 1]))
                for c in comps if c.len
            ]
        t0 = min((t for t, _ in spans), default=0)
        t1 = max((t for _, t in spans), default=0)
        return _json_resp({
            "path": str(db.path) if db.path else None,
            "components": len(comps), "rows": rows, "msgs": msgs,
            "start_us": t0, "stop_us": t1,
        })

    def api_components(path, query):
        out = []
        with db.lock:
            for c in db.components.values():
                latest = c.latest()
                out.append({
                    "name": c.name or f"{c.component_id:016x}",
                    "prim": c.prim,
                    "shape": list(c.shape),
                    "rows": c.len,
                    "metadata": c.metadata,
                    "latest_us": latest[0] if latest else None,
                })
        out.sort(key=lambda d: d["name"])
        return _json_resp(out)

    def _find(name: str):
        with db.lock:
            for c in db.components.values():
                if c.name == name or f"{c.component_id:016x}" == name:
                    return c
        return None

    def api_series(path, query):
        name = query.get("name", "")
        c = _find(name)
        if c is None:
            return 404, "text/plain", f"unknown component {name}".encode()
        start = _qint(query, "start_us", -(2**62))
        stop = _qint(query, "stop_us", 2**62)
        max_points = max(16, min(4000, _qint(query, "max_points", 600)))
        with db.lock:
            ts, vals = c.range(start, stop)
            ts = np.asarray(ts).copy()
            vals = np.asarray(vals, dtype=np.float64).copy()
        if len(ts) > max_points:
            # LTTB on the first channel picks the indices for all channels
            idx = lttb(ts.astype(np.float64), vals[:, 0], max_points)
            ts, vals = ts[idx], vals[idx]
        names = None
        labels = (c.metadata or {}).get("element_names")
        if labels:
            names = [s for s in labels.split(",") if s]
        return _json_resp({
            "name": name,
            "t": [int(x) for x in ts],
            "v": [[float(x) for x in row] for row in vals],
            "element_names": names,
            "prim": c.prim, "shape": list(c.shape),
        })

    def api_latest(path, query):
        name = query.get("name", "")
        c = _find(name)
        if c is None:
            return 404, "text/plain", f"unknown component {name}".encode()
        latest = c.latest()
        if latest is None:
            return _json_resp({"name": name, "t": None, "v": None})
        ts, row = latest
        return _json_resp({
            "name": name, "t": int(ts),
            "v": [float(x) for x in np.asarray(row).reshape(-1)],
        })

    def api_schematic(path, query):
        # prefer the persisted active schematic (set_active_schematic,
        # export path parity); fall back to the legacy fixed asset key
        raw = None
        active = getattr(db, "active_schematic", None)
        if active:
            raw = db.assets.get(active)
        if raw is None:
            raw = db.assets.get("schematic.kdl")
        if raw is None:
            # exporter-parity last resort: the first .kdl asset (covers a
            # DB whose config.json was lost but schematics survive)
            names = sorted(
                n for n in db.assets.keys() if n.endswith(".kdl")
            )
            if names:
                raw = db.assets.get(names[0])
        if raw is None:
            return _json_resp({"components": [], "raw": None})
        from .. import schematic as _schematic

        text = raw.decode(errors="replace")
        try:
            # typed layout: the viewer consumes the validated panel tree
            sch = _schematic.load(text, strict=False)
            payload = _schematic.to_layout_json(sch)
        except (_schematic.SchematicError, ValueError) as e:
            # SchematicError = typed-vocabulary violations; ValueError =
            # malformed KDL syntax from kdl.parse.  Both surface as a
            # structured error payload the viewer renders, not an HTTP 500.
            payload = {"components": [], "error": str(e)}
        payload["raw"] = text
        return _json_resp(payload)

    def api_scene(path, query):
        """The MCAP exporter's SceneUpdate entities (editor 3D-scene
        parity: object_3d models, line_3d trajectories, vector arrows,
        live frame transforms).  ``?ts_us=`` renders the scene at a
        scrubbed timeline position instead of the latest sample."""
        from .export_mcap import build_scene_json

        ts_us = _qint(query, "ts_us", 0)
        try:
            with db.lock:
                scene = build_scene_json(
                    db, ts_ns=ts_us * 1000 if ts_us > 0 else None)
        except Exception as e:  # noqa: BLE001 — surface, don't 500
            scene = {"entities": [], "error": str(e)}
        return _json_resp(scene)

    def api_drawlist(path, query):
        """The scene pre-digested into flat draw descriptors + camera
        framing (db/scenemath.py — the server-side single implementation
        of the viewer's scene-assembly logic).  The client renders this
        verbatim; ``?ts_us=`` scrubs like /api/scene."""
        from . import scenemath
        from .export_mcap import build_scene_json

        ts_us = _qint(query, "ts_us", 0)
        try:
            with db.lock:
                scene = build_scene_json(
                    db, ts_ns=ts_us * 1000 if ts_us > 0 else None)
        except Exception as e:  # noqa: BLE001 — surface, don't 500
            return _json_resp({"solids": [], "lines": [], "glbs": [],
                               "frame": {"center": [0, 0, 0], "radius": 10},
                               "error": str(e)})
        dl = scenemath.build_draw_list(scene)
        dl["frame"] = scenemath.frame_scene(dl)
        ftf = scene.get("transforms", {}).get(scene.get("follow_entity"))
        if ftf:
            dl["follow"] = [ftf["position"]["x"], ftf["position"]["y"],
                            ftf["position"]["z"]]
        if scene.get("warnings"):
            dl["warnings"] = scene["warnings"]
        return _json_resp(dl)

    _geom_cache: list = []

    def api_geoms(path, query):
        """Unit primitive geometry (cube/sphere/cylinder/cone) generated by
        scenemath — one tested implementation; the client only uploads."""
        from . import scenemath

        if not _geom_cache:
            _geom_cache.append(json.dumps(scenemath.geoms_to_json()).encode())
        return 200, "application/json", _geom_cache[0]

    _glb_cache: dict = {}

    def api_glb(path, query):
        """A GLB asset parsed server-side (scenemath.parse_glb) into
        upload-ready primitives; vertex data rides as base64 blobs.
        ``?url=/assets/<key>`` — the reference the live /api/scene hands
        out for models."""
        from . import scenemath

        url = query.get("url", "")
        if not url.startswith("/assets/"):
            return 404, "text/plain", b"expected url=/assets/<key>"
        key = url[len("/assets/"):]
        cached = _glb_cache.get(key)
        if cached is not None:
            return 200, "application/json", cached
        raw = db.assets.get(key)
        if raw is None:
            return 404, "text/plain", b"unknown asset"
        try:
            body = json.dumps(scenemath.glb_to_json(raw)).encode()
        except Exception as e:  # noqa: BLE001
            return 415, "text/plain", f"GLB parse failed: {e}".encode()
        _glb_cache[key] = body
        return 200, "application/json", body

    def api_msg_logs(path, query):
        out = []
        with db.lock:
            for mid, log in db.msg_logs.items():
                name = getattr(log.metadata, "name", None)
                out.append({
                    "id": mid.hex(),
                    "name": name or mid.hex(),
                    "entries": len(log.entries),
                    "latest_us": log.entries[-1][0] if log.entries else None,
                })
        out.sort(key=lambda d: d["name"])
        return _json_resp(out)

    def api_msgs(path, query):
        mid_hex = query.get("id", "")
        limit = max(1, min(500, _qint(query, "limit", 50)))
        start = _qint(query, "start_us", 0)
        try:
            mid = bytes.fromhex(mid_hex)
        except ValueError:
            return 404, "text/plain", b"unknown msg log"
        with db.lock:
            log = db.msg_logs.get(mid)
            if log is None:
                return 404, "text/plain", b"unknown msg log"
            entries = [e for e in log.entries if e[0] >= start][-limit:]
        rows = []
        for ts, data in entries:
            # decode LogEntry-style text payloads; binary shown as hex head
            try:
                text = data.decode("utf-8")
                if not text.isprintable() and "\n" not in text:
                    raise ValueError
            except (UnicodeDecodeError, ValueError):
                text = data[:48].hex() + ("…" if len(data) > 48 else "")
            rows.append({"t": ts, "text": text, "bytes": len(data)})
        return _json_resp(rows)

    _video_cache: dict = {}

    def api_videos(path, query):
        """H.264 msg logs the browser can play.  Requires BOTH an SPS and a
        PPS in the head — the mux needs both, so listing SPS-only logs
        would offer streams that always 415."""
        from .video import NAL_PPS, NAL_SPS, find_nal

        out = []
        with db.lock:
            for mid, log in db.msg_logs.items():
                head = log.entries[:20]
                if not any(find_nal(p, NAL_SPS) for _, p in head):
                    continue
                if not any(find_nal(p, NAL_PPS) for _, p in head):
                    continue
                name = getattr(log.metadata, "name", None) or mid.hex()
                out.append({"id": mid.hex(), "name": name,
                            "frames": len(log.entries)})
        out.sort(key=lambda d: d["name"])
        return _json_resp(out)

    def api_video(path, query):
        """Mux one recorded H.264 Annex-B msg log into an MP4 on demand —
        the browser's <video> element does the decode, replacing the
        reference's editor-side video-toolbox decoder
        (libs/video-toolbox) with the client's own hardware decoder."""
        import tempfile

        from .video import export_h264_log

        try:
            mid = bytes.fromhex(query.get("id", ""))
        except ValueError:
            return 404, "text/plain", b"unknown video log"
        with db.lock:
            log = db.msg_logs.get(mid)
            entries = list(log.entries) if log else []
            name = (getattr(log.metadata, "name", None) or mid.hex()
                    if log else "")
        if not entries:
            return 404, "text/plain", b"unknown video log"
        key = (mid, len(entries))  # entries only append; length = version
        mp4 = _video_cache.get(key)
        if mp4 is None:
            with tempfile.NamedTemporaryFile(suffix=".mp4") as tmp:
                stats = export_h264_log(entries, name, tmp.name)
                if not stats:
                    return 415, "text/plain", b"no decodable H.264 in log"
                tmp.seek(0)
                mp4 = tmp.read()
            _video_cache.clear()  # hold one mux; stale versions never serve
            _video_cache[key] = mp4
        return 200, "video/mp4", mp4

    def api_sql(path, query):
        q = query.get("q", "").strip()
        if not q:
            return 400, "text/plain", b"missing q"
        from .sql import run_sql

        table = run_sql(db, q)
        cols = table.column_names[:32]
        n = min(table.num_rows, 500)
        data = table.slice(0, n).to_pydict()
        rows = [
            [_jsonable(data[c][i]) for c in cols] for i in range(n)
        ]
        return _json_resp({"columns": cols, "rows": rows,
                           "total_rows": table.num_rows})

    def index(path, query):
        if path != "/":
            return 404, "text/plain", b"not found"
        return 200, "text/html; charset=utf-8", VIEWER_HTML.encode()

    def static_js(path, query):
        # the viewer logic lives in static/*.js (reviewable, testable
        # artifacts rather than embedded strings)
        name = path.rsplit("/", 1)[-1]
        return (200, "application/javascript; charset=utf-8",
                _static_file(name))

    routes["/api/info"] = api_info
    routes["/api/components"] = api_components
    routes["/api/series"] = api_series
    routes["/api/latest"] = api_latest
    routes["/api/schematic"] = api_schematic
    routes["/api/scene"] = api_scene
    routes["/api/drawlist"] = api_drawlist
    routes["/api/glb"] = api_glb
    routes["/api/geoms"] = api_geoms
    routes["/api/msg-logs"] = api_msg_logs
    routes["/api/msgs"] = api_msgs
    routes["/api/videos"] = api_videos
    routes["/api/video"] = api_video
    routes["/api/sql"] = api_sql
    routes["/static/viewer.js"] = static_js
    routes["/static/scene3d.js"] = static_js
    routes["/"] = index


def _static_file(name: str) -> bytes:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "static", name)
    with open(path, "rb") as f:
        return f.read()


def viewer_js() -> bytes:
    return _static_file("viewer.js")


def scene3d_js() -> bytes:
    return _static_file("scene3d.js")


def _jsonable(v):
    import datetime as _dt

    import numpy as _np

    if isinstance(v, (bytes, bytearray)):
        return v.hex()
    if isinstance(v, (_dt.datetime, _dt.date, _dt.time)):
        return v.isoformat()
    if isinstance(v, _np.generic):
        return v.item()
    if isinstance(v, float) and (v != v or v in (float("inf"), float("-inf"))):
        return str(v)
    return v


# The single-page viewer.  Chart styling follows the repo's data-viz
# conventions: fixed-order categorical palette (validated for adjacent-pair
# CVD separation in light and dark), 2px lines, hairline grid, crosshair
# tooltip listing every series, legend for >=2 series, table view toggle.
VIEWER_HTML = r"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>elodin-db viewer</title>
<style>
:root {
  color-scheme: light;
  --surface-1:#fcfcfb; --page:#f9f9f7;
  --ink-1:#0b0b0b; --ink-2:#52514e; --ink-3:#898781;
  --grid:#e1e0d9; --axis:#c3c2b7; --border:rgba(11,11,11,0.10);
  --good:#0ca30c; --critical:#d03b3b;
  --s1:#2a78d6; --s2:#eb6834; --s3:#1baf7a; --s4:#eda100;
  --s5:#e87ba4; --s6:#008300; --s7:#4a3aa7; --s8:#e34948;
}
@media (prefers-color-scheme: dark) {
  :root {
    color-scheme: dark;
    --surface-1:#1a1a19; --page:#0d0d0d;
    --ink-1:#ffffff; --ink-2:#c3c2b7; --ink-3:#898781;
    --grid:#2c2c2a; --axis:#383835; --border:rgba(255,255,255,0.10);
    --s1:#3987e5; --s2:#d95926; --s3:#199e70; --s4:#c98500;
    --s5:#d55181; --s6:#008300; --s7:#9085e9; --s8:#e66767;
  }
}
* { box-sizing: border-box; }
body {
  margin:0; background:var(--page); color:var(--ink-1);
  font:14px/1.45 system-ui,-apple-system,"Segoe UI",sans-serif;
}
header {
  display:flex; align-items:baseline; gap:16px; padding:10px 16px;
  border-bottom:1px solid var(--border); background:var(--surface-1);
  position:sticky; top:0; z-index:3;
}
header h1 { font-size:15px; margin:0; font-weight:600; }
header .sub { color:var(--ink-2); font-size:12px; }
#status { margin-left:auto; font-size:12px; color:var(--ink-2);
  display:flex; align-items:center; gap:6px; }
#dot { width:8px; height:8px; border-radius:50%; background:var(--critical); }
#dot.live { background:var(--good); }
.layout { display:flex; min-height:calc(100vh - 45px); }
nav {
  width:260px; flex:none; border-right:1px solid var(--border);
  background:var(--surface-1); padding:10px; overflow-y:auto;
  max-height:calc(100vh - 45px); position:sticky; top:45px;
}
nav input {
  width:100%; padding:6px 8px; margin-bottom:8px;
  border:1px solid var(--axis); border-radius:6px;
  background:var(--page); color:var(--ink-1); font:inherit;
}
.comp {
  display:flex; justify-content:space-between; gap:6px; padding:5px 8px;
  border-radius:6px; cursor:pointer; font-size:13px;
}
.comp:hover { background:var(--page); }
.comp.on { background:var(--page); font-weight:600; }
.comp .rows { color:var(--ink-3); font-size:11px;
  font-variant-numeric:tabular-nums; }
main { flex:1; padding:14px; min-width:0; }
.filters { display:flex; gap:6px; margin-bottom:12px; align-items:center; }
.filters button {
  font:12px system-ui; padding:4px 10px; border-radius:6px;
  border:1px solid var(--axis); background:var(--surface-1);
  color:var(--ink-2); cursor:pointer;
}
.filters button.on { color:var(--ink-1); font-weight:600;
  border-color:var(--ink-3); }
.card {
  background:var(--surface-1); border:1px solid var(--border);
  border-radius:10px; padding:12px 14px 8px; margin-bottom:14px;
}
.card h2 { font-size:13px; font-weight:600; margin:0; }
.card .head { display:flex; align-items:center; gap:10px; }
.card .latest { color:var(--ink-2); font-size:12px;
  font-variant-numeric:tabular-nums; }
.card .tools { margin-left:auto; display:flex; gap:6px; }
.card .tools button {
  font:11px system-ui; padding:2px 8px; border-radius:5px;
  border:1px solid var(--axis); background:transparent;
  color:var(--ink-2); cursor:pointer;
}
.legend { display:flex; flex-wrap:wrap; gap:4px 14px; margin:6px 0 2px;
  font-size:12px; color:var(--ink-2); }
.legend .key { display:inline-block; width:14px; height:0;
  border-top:2px solid; border-radius:1px; vertical-align:middle;
  margin-right:5px; }
.plotwrap { position:relative; }
canvas { display:block; width:100%; height:220px; }
.tip {
  position:absolute; pointer-events:none; background:var(--surface-1);
  border:1px solid var(--border); border-radius:6px; padding:6px 9px;
  font-size:12px; box-shadow:0 2px 8px rgba(0,0,0,0.12); display:none;
  z-index:2; min-width:120px;
}
.tip .t { color:var(--ink-3); margin-bottom:3px;
  font-variant-numeric:tabular-nums; }
.tip .row { display:flex; gap:8px; justify-content:space-between; }
.tip .v { font-weight:600; font-variant-numeric:tabular-nums; }
.tip .n { color:var(--ink-2); }
table.vals { border-collapse:collapse; width:100%; font-size:12px;
  margin:6px 0; }
table.vals th, table.vals td {
  text-align:right; padding:3px 8px; border-bottom:1px solid var(--grid);
  font-variant-numeric:tabular-nums; color:var(--ink-2);
}
table.vals th { color:var(--ink-3); font-weight:500; }
.empty { color:var(--ink-3); padding:40px; text-align:center; }
</style>
</head>
<body>
<header>
  <h1>elodin-db</h1>
  <span class="sub" id="dbinfo"></span>
  <span id="status"><span id="dot"></span><span id="stext">connecting</span></span>
</header>
<div class="layout">
  <nav>
    <input id="search" placeholder="filter components" aria-label="filter components">
    <div id="complist"></div>
  </nav>
  <main>
    <div class="filters" id="ranges" role="group" aria-label="time range">
      <span style="font-size:12px;color:var(--ink-3)">window</span>
    </div>
    <div class="filters timeline" role="group" aria-label="timeline">
      <button id="playbtn" aria-label="play">&#9654;</button>
      <input id="scrub" type="range" min="0" max="1000" value="1000"
             aria-label="timeline position" style="flex:1;max-width:420px">
      <span id="timelabel" style="font-size:12px;color:var(--ink-2);
        font-variant-numeric:tabular-nums;min-width:90px"></span>
      <button id="livebtn" class="on">live</button>
      <button id="view3d">3D view</button>
      <button id="scenebtn">scene</button>
      <button id="sqlbtn">SQL</button>
      <button id="logsbtn">logs</button>
      <button id="videobtn">video</button>
    </div>
    <div id="cards"><div class="empty">select components on the left to plot them</div></div>
  </main>
</div>
<script src="/static/viewer.js"></script>
<script src="/static/scene3d.js"></script>
</body>
</html>
"""
