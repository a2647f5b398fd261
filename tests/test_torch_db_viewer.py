"""The port's web viewer, ``/ws`` bridge and scene math
(``elodin_tpu_torch.db.webui``, ``ws``, ``scenemath``), on the CPU, held
to the JAX package's.

* Every case of ``tests/test_webui.py``, ``test_ws.py`` and
  ``test_scenemath.py`` on the port's server and modules.  Where the JAX
  test slept for rows to land, these poll the server for them.
* The ``/ws`` bridge three ways: the port's ``WsClient`` on the port's
  server and on the JAX package's, and the JAX package's ``WsClient`` on
  the port's; a ``time_series`` read through ``/ws`` is bitwise the TCP
  client's.
* Every ``/api/*`` route and static file of one database on disk, served
  by the port's server and then by the JAX package's: the bodies are
  byte for byte the same.
* ``parse_glb``, ``glb_to_json``, ``build_draw_list``, ``frame_scene`` and
  the unit geometries of the same inputs: bitwise the JAX package's.

Tolerance: bitwise (byte for byte) in every cross-package case.
"""

import base64
import json
import struct
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import elodin_tpu.db as jdb
import elodin_tpu_torch.db as tdb
from elodin_tpu.db import scenemath as jsm
from elodin_tpu.db import ws as jws
from elodin_tpu_torch.db import msgs as M
from elodin_tpu_torch.db import scenemath as sm
from elodin_tpu_torch.db.ws import WsClient

PKG = {"jax": jdb, "torch": tdb}
WS = {"jax": jws.WsClient, "torch": WsClient}
PAIRS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]  # (server, client)
WAIT_S = 30.0


def _rows(client, name, n):
    """Wait until the server holds ``n`` rows of ``name``."""
    deadline = time.monotonic() + WAIT_S
    while True:
        try:
            if len(client.time_series(name)[0]) >= n:
                return
        except RuntimeError:  # the store is not made yet
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"{name}: {n} rows never landed")
        time.sleep(0.01)


# -- the web viewer (tests/test_webui.py) ---------------------------------------


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get_content_type(), r.read()


def test_webui_api_and_page(tmp_path):
    from elodin_tpu_torch.db import Client, Server

    srv = Server.start(str(tmp_path / "db"))
    try:
        base = f"http://127.0.0.1:{srv.port + 1}"
        c = Client.connect(srv.addr)
        from elodin_tpu_torch.db import f64

        spec = f64[3].labeled("x", "y", "z")
        with c.table_writer({"ball.world_pos": spec}) as w:
            for i in range(100):
                w.write(1_000_000 + i * 1000,
                        {"ball.world_pos": np.array([i, 2.0 * i, -i])})
        _rows(c, "ball.world_pos", 100)

        status, ctype, body = _get(base + "/api/info")
        info = json.loads(body)
        assert status == 200 and info["components"] == 1
        assert info["rows"] == 100

        status, _, body = _get(base + "/api/components")
        comps = json.loads(body)
        assert comps[0]["name"] == "ball.world_pos"
        assert comps[0]["shape"] == [3]
        assert comps[0]["metadata"]["element_names"] == "x,y,z"

        # series: downsampled to max_points, labels carried
        status, _, body = _get(
            base + "/api/series?name=ball.world_pos&max_points=20")
        s = json.loads(body)
        assert status == 200
        assert 16 <= len(s["t"]) <= 20
        assert s["element_names"] == ["x", "y", "z"]
        assert s["t"][0] == 1_000_000 and s["t"][-1] == 1_099_000
        assert s["v"][-1] == [99.0, 198.0, -99.0]

        # time-window query
        status, _, body = _get(
            base + "/api/series?name=ball.world_pos"
            "&start_us=1050000&stop_us=1060000")
        s = json.loads(body)
        assert all(1_050_000 <= t < 1_060_000 for t in s["t"])

        status, _, body = _get(base + "/api/latest?name=ball.world_pos")
        latest = json.loads(body)
        assert latest["v"] == [99.0, 198.0, -99.0]

        # unknown component -> 404
        try:
            _get(base + "/api/series?name=nope")
            assert False, "expected 404"
        except urllib.error.HTTPError as e:
            assert e.code == 404

        # the viewer page serves, and older routes still work
        status, ctype, body = _get(base + "/")
        assert status == 200 and ctype == "text/html"
        html = body.decode()
        assert "elodin-db viewer" in html
        # the page logic is the static artifact, not an embedded string
        assert 'src="/static/viewer.js"' in html
        _, _, js_body = _get(base + "/static/viewer.js")
        js = js_body.decode()
        # untrusted names must go through textContent, never innerHTML
        assert "innerHTML" not in js and "innerHTML" not in html
        assert "textContent" in js
        status, _, body = _get(base + "/healthz")
        assert status == 200 and body == b"ok"
        c.close()
    finally:
        srv.stop()


def test_webui_scene_endpoint(tmp_path):
    """/api/scene serves the MCAP exporter's SceneUpdate entities live."""
    from elodin_tpu_torch.db import Client, Server

    srv = Server.start(str(tmp_path / "db"))
    try:
        base = f"http://127.0.0.1:{srv.port + 1}"
        c = Client.connect(srv.addr)
        c.send("sat.world_pos", np.array([0, 0, 0, 1, 1.0, 2.0, 3.0]),
               timestamp_us=1_000_000)
        c.send("sat.world_pos", np.array([0, 0, 0, 1, 1.5, 2.0, 3.0]),
               timestamp_us=1_010_000)
        _rows(c, "sat.world_pos", 2)
        srv.db.assets.put("schematic.kdl", b"""
line_3d sat.world_pos color=yellow
object_3d sat.world_pos {
    sphere radius=0.5 { material base_color=red }
}
""")
        s = json.loads(_get(base + "/api/scene")[2])
        assert s.get("error") is None, s
        topics = {e["topic"] for e in s["entities"]}
        assert any(t.endswith("-line") for t in topics), topics
        assert s["follow_entity"] == "sat"
        line = next(e for e in s["entities"] if e["topic"].endswith("-line"))
        pts = line["lines"][0]["points"]
        assert pts[0] == {"x": 1.0, "y": 2.0, "z": 3.0}

        # live frame transform baked in (frame-locked entities would
        # otherwise render at identity in a JSON consumer)
        tf = s["transforms"]["sat"]
        assert tf["position"] == {"x": 1.5, "y": 2.0, "z": 3.0}
        assert tf["orientation"]["w"] == 1.0

        # scrubbed scene: ?ts_us renders the pose at/before that time
        s0 = json.loads(_get(base + "/api/scene?ts_us=1000000")[2])
        assert s0["transforms"]["sat"]["position"]["x"] == 1.0
        c.close()
    finally:
        srv.stop()


def test_webui_schematic_sql_msgs(tmp_path):
    """Schematic, SQL console, and msg-log endpoints (editor parity)."""
    import urllib.error

    from elodin_tpu_torch.db import Client, Server
    from elodin_tpu_torch.db import msgs as M
    from elodin_tpu_torch.db.postcard import msg_id

    srv = Server.start(str(tmp_path / "db"))
    try:
        base = f"http://127.0.0.1:{srv.port + 1}"
        c = Client.connect(srv.addr)
        c.send("ball.world_pos", np.arange(7.0), timestamp_us=1_000_000)
        c.send("ball.mass", np.array([2.5]), timestamp_us=1_000_000)
        _rows(c, "ball.world_pos", 1)
        _rows(c, "ball.mass", 1)

        # schematic: none yet -> empty; then stored as asset
        s = json.loads(_get(base + "/api/schematic")[2])
        assert s["components"] == []
        srv.db.assets.put("schematic.kdl", b'''
vsplit {
    graph "ball.world_pos"
    graph "ball.mass"
}
''')
        s = json.loads(_get(base + "/api/schematic")[2])
        assert s["components"] == ["ball.world_pos", "ball.mass"]

        # the persisted active schematic (set_active_schematic flow, as the
        # MCAP exporter uses) takes precedence over the legacy fixed key
        srv.db.assets.put(
            "schematics/alt.kdl", b'vsplit {\n graph "ball.mass"\n}\n'
        )
        srv.db.set_active_schematic("schematics/alt.kdl")
        s = json.loads(_get(base + "/api/schematic")[2])
        assert s["components"] == ["ball.mass"]
        srv.db.set_active_schematic(None)

        # malformed KDL syntax (unclosed brace -> ValueError from kdl.parse)
        # surfaces as a structured error payload, not an HTTP 500
        srv.db.assets.put("schematic.kdl", b"vsplit {\n  graph \"x\"\n")
        s = json.loads(_get(base + "/api/schematic")[2])
        assert s["components"] == [] and s["error"]
        srv.db.assets.put("schematic.kdl", b'''
vsplit {
    graph "ball.world_pos"
    graph "ball.mass"
}
''')

        # sql over http
        from elodin_tpu_torch.db import sql_table_name

        t = sql_table_name("ball.mass")
        _, _, body = _get(base + "/api/sql?q=" +
                          urllib.request.quote(f"select * from {t}"))
        res = json.loads(body)
        assert res["total_rows"] == 1
        assert 2.5 in res["rows"][0]
        # bad sql -> error status, not a hang
        try:
            _get(base + "/api/sql?q=drop%20table%20x")
            assert False, "expected error"
        except urllib.error.HTTPError as e:
            assert e.code in (400, 500)

        # msg logs
        mid = msg_id("sim.log")
        log = srv.db.msg_log(mid)
        log.set_metadata(M.MsgMetadata(1, "sim.log", {}))
        log.append(1_000_000, b"hello from the sim")
        log.append(2_000_000, bytes([0, 1, 2, 254, 255]))
        logs = json.loads(_get(base + "/api/msg-logs")[2])
        assert logs[0]["name"] == "sim.log" and logs[0]["entries"] == 2
        msgs = json.loads(_get(base + f"/api/msgs?id={mid.hex()}")[2])
        assert msgs[0]["text"] == "hello from the sim"
        assert msgs[1]["text"].startswith("000102")  # binary -> hex preview
        c.close()
    finally:
        srv.stop()


def test_webui_series_with_nan_parses(tmp_path):
    """Regression: NaN samples made json.dumps emit bare NaN tokens, which
    browser JSON.parse rejects — the plot never rendered. Non-finite floats
    must serialize as null."""
    from elodin_tpu_torch.db import Client, Server, f64

    srv = Server.start(str(tmp_path / "db"))
    try:
        base = f"http://127.0.0.1:{srv.port + 1}"
        c = Client.connect(srv.addr)
        with c.table_writer({"nan.x": f64}) as w:
            w.write(1_000_000, {"nan.x": 1.0})
            w.write(1_001_000, {"nan.x": float("nan")})
            w.write(1_002_000, {"nan.x": float("inf")})
            w.write(1_003_000, {"nan.x": 3.0})
        _rows(c, "nan.x", 4)
        _, _, body = _get(base + "/api/series?name=nan.x")
        s = json.loads(body)  # strict JSON: would fail on bare NaN
        flat = [v[0] for v in s["v"]]
        assert flat == [1.0, None, None, 3.0]
        _, _, body = _get(base + "/api/latest?name=nan.x")
        assert json.loads(body)["v"] == [3.0]
        c.close()
    finally:
        srv.stop()


def test_viewer_js_served_and_endpoint_contract(tmp_path):
    """The viewer logic is a static artifact (/static/viewer.js).  Contract
    checks that run without a JS engine (none runs the tests):
    every endpoint the JS fetches must be a registered route, the page must
    reference the script, and the poll3d stale-panel guard (regression
    b6008dd: a close/reopen mid-fetch must not write a stale trajectory
    batch into the new panel) must re-check panel identity after the await."""
    import re

    from elodin_tpu_torch.db import Server
    from elodin_tpu_torch.db.webui import VIEWER_HTML

    srv = Server.start(str(tmp_path / "db"))
    try:
        base = f"http://127.0.0.1:{srv.port + 1}"
        status, ctype, body = _get(base + "/static/viewer.js")
        assert status == 200 and "javascript" in ctype
        js = body.decode()
        assert '"use strict";' in js

        status, _, page = _get(base + "/")
        assert b'src="/static/viewer.js"' in page
        assert "<script>" not in VIEWER_HTML  # no embedded JS remains

        # endpoint contract: every fetch()ed /api path exists in the routes
        from elodin_tpu_torch.db.webui import register_routes

        routes = {}

        class _FakeDb:  # register_routes only stores closures
            pass

        register_routes(routes, _FakeDb())
        fetched = set(re.findall(r'fetch\(["`]((?:/api|/static)[^"`?]*)', js))
        assert fetched, "viewer.js fetches nothing? extraction broke"
        for url in fetched:
            assert url in routes, f"viewer.js fetches unregistered {url}"

        # poll3d stale-panel guard: identity re-checked after the await
        poll3d = js[js.index("async function poll3d"):]
        poll3d = poll3d[:poll3d.index("\nfunction")]
        awaits = poll3d.index("await")
        assert "view3d === me" in poll3d[awaits:], (
            "poll3d lost its post-await panel-identity re-check (b6008dd)"
        )
    finally:
        srv.stop()


def test_webui_video_endpoints(tmp_path):
    """/api/videos lists H.264 msg logs and /api/video muxes one to MP4 on
    demand (browser-side decode replaces the reference's editor
    video-toolbox decoder; mux path shared with export-videos)."""
    from test_db import _golomb_sps, _walk_boxes

    from elodin_tpu_torch.db import Server, msgs as M
    from elodin_tpu_torch.db.storage import Database

    path = str(tmp_path / "db")
    db = Database(path)
    sc = b"\x00\x00\x00\x01"
    sps = _golomb_sps()
    pps = b"\x68\xce\x38\x80"
    idr = b"\x65" + bytes(range(1, 40))
    log = db.msg_log(b"\xab\xcd")
    log.set_metadata(M.MsgMetadata(0xABCD, "video.cam0", {}))
    for i in range(8):
        payload = (sc + sps + sc + pps + sc + idr) if i % 4 == 0 \
            else (sc + b"\x41" + bytes(range(1, 24)))
        log.append(1_000_000 + i * 33_333, payload)
    # a non-video log must NOT appear in /api/videos
    txt = db.msg_log(b"\x01\x02")
    txt.set_metadata(M.MsgMetadata(0x0102, "log.text", {}))
    txt.append(1_000_000, b"hello")
    db.flush()
    del db, log, txt

    srv = Server.start(path)
    try:
        base = f"http://127.0.0.1:{srv.port + 1}"
        status, _, body = _get(base + "/api/videos")
        vids = json.loads(body)
        assert status == 200
        assert [v["name"] for v in vids] == ["video.cam0"]
        assert vids[0]["frames"] == 8

        status, ctype, mp4 = _get(base + f"/api/video?id={vids[0]['id']}")
        assert status == 200 and ctype == "video/mp4"
        boxes = {f: (a, b) for f, a, b in _walk_boxes(mp4)}
        assert set(boxes) == {b"ftyp", b"mdat", b"moov"}
        # second fetch serves the cached mux byte-identically
        _, _, mp4b = _get(base + f"/api/video?id={vids[0]['id']}")
        assert mp4b == mp4

        import urllib.error
        try:
            _get(base + "/api/video?id=dead")
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        srv.stop()


def test_scene3d_js_served_and_contract(tmp_path):
    """The WebGL scene viewer (/static/scene3d.js).  Contract checks that
    run without a JS engine: served, referenced by the page, every fetched
    endpoint registered, the pure S3D math/parse section touches no DOM/GL,
    and the poll loop re-checks panel identity after its await (the same
    stale-write hazard regression-tested for viewer.js's poll3d)."""
    import re

    from elodin_tpu_torch.db import Server
    from elodin_tpu_torch.db.webui import register_routes, scene3d_js

    srv = Server.start(str(tmp_path / "db"))
    try:
        base = f"http://127.0.0.1:{srv.port + 1}"
        status, ctype, body = _get(base + "/static/scene3d.js")
        assert status == 200 and "javascript" in ctype
        js = body.decode()
        assert js == scene3d_js().decode()
        assert '"use strict";' in js
        assert "innerHTML" not in js

        status, _, page = _get(base + "/")
        assert b'src="/static/scene3d.js"' in page
        assert b'id="scenebtn"' in page

        routes = {}

        class _FakeDb:
            pass

        register_routes(routes, _FakeDb())
        fetched = set(re.findall(r'fetch\(["`]((?:/api|/static)[^"`?]*)', js))
        # the scene logic executes server-side (db/scenemath.py,
        # tests/test_scenemath.py); the client fetches pre-digested results
        assert {"/api/drawlist", "/api/geoms", "/api/glb"} <= fetched
        for url in fetched:
            assert url in routes, f"scene3d.js fetches unregistered {url}"
        # no client-side GLB parsing / draw-list assembly remains
        for gone in ("parseGLB", "buildDrawList", "frameScene", "geomCube"):
            assert gone not in js, f"client still carries {gone}"

        # pure section boundary: no DOM/WebGL below the banner until the
        # renderer section starts
        pure = js[: js.index("// Renderer + poll loop")]
        for token in ("document.", "window.", "getContext", "gl."):
            assert token not in pure, f"S3D pure section uses {token}"

        # poll loop stale-guard after the await
        poll = js[js.index("async function pollScene3d"):]
        poll = poll[: poll.index("\nfunction")]
        assert "sceneView !== me" in poll[poll.index("await"):]
    finally:
        srv.stop()


def test_webui_drawlist_glb_geoms_endpoints(tmp_path):
    """The scene3d data plane: /api/drawlist (scene pre-digested by
    scenemath, scrubbable), /api/glb (server-parsed GLB primitives), and
    /api/geoms (unit geometry) — the client renders these verbatim."""
    import base64

    from elodin_tpu_torch.db import Client, Server
    
    srv = Server.start(str(tmp_path / "db"))
    try:
        base = f"http://127.0.0.1:{srv.port + 1}"
        c = Client.connect(srv.addr)
        c.send("sat.world_pos", np.array([0, 0, 0, 1, 1.0, 2.0, 3.0]),
               timestamp_us=1_000_000)
        c.send("sat.world_pos", np.array([0, 0, 0, 1, 1.5, 2.0, 3.0]),
               timestamp_us=1_010_000)
        _rows(c, "sat.world_pos", 2)
        srv.db.assets.put("m.glb", tri_glb())
        srv.db.assets.put("schematic.kdl", b"""
line_3d sat.world_pos color=yellow
object_3d sat.world_pos {
    sphere radius=0.5 { material base_color=red }
}
object_3d sat.world_pos {
    glb path="m.glb"
}
""")
        dl = json.loads(_get(base + "/api/drawlist")[2])
        assert dl.get("error") is None, dl
        kinds = [s["kind"] for s in dl["solids"]]
        assert "sphere" in kinds
        assert dl["lines"] and dl["lines"][0]["pts"][:3] == [1.0, 2.0, 3.0]
        # live frame transform premultiplied into the solid's matrix
        sph = next(s for s in dl["solids"] if s["kind"] == "sphere")
        assert sph["mat"][12] == 1.5
        assert dl["follow"] == [1.5, 2.0, 3.0]
        assert dl["frame"]["radius"] > 0

        # scrubbed: ?ts_us poses the drawlist at/before that time
        dl0 = json.loads(_get(base + "/api/drawlist?ts_us=1000000")[2])
        sph0 = next(s for s in dl0["solids"] if s["kind"] == "sphere")
        assert sph0["mat"][12] == 1.0

        # the model reference resolves through /api/glb (parsed server-side)
        glb_url = dl["glbs"][0]["url"]
        status, ctype, body = _get(base + "/api/glb?url=" + glb_url)
        assert status == 200 and "json" in ctype
        prims = json.loads(body)["prims"]
        pos = np.frombuffer(base64.b64decode(prims[0]["pos_b64"]), "<f4")
        np.testing.assert_array_equal(pos, [0, 0, 0, 1, 0, 0, 0, 1, 0])
        assert prims[0]["color"] == [1, 0, 0, 1]
        # cache path + error paths (urlopen raises on non-2xx)
        import urllib.error

        def code_of(url):
            try:
                return _get(url)[0]
            except urllib.error.HTTPError as e:
                return e.code

        assert code_of(base + "/api/glb?url=" + glb_url) == 200
        assert code_of(base + "/api/glb?url=/assets/missing.glb") == 404
        assert code_of(base + "/api/glb?url=/etc/passwd") == 404
        srv.db.assets.put("bad.glb", b"not a glb at all")
        assert code_of(base + "/api/glb?url=/assets/bad.glb") == 415

        status, _, gb = _get(base + "/api/geoms")
        assert status == 200
        geoms = json.loads(gb)
        assert set(geoms) == {"cube", "sphere", "cylinder", "cone"}
        c.close()
    finally:
        srv.stop()


# -- the /ws bridge (tests/test_ws.py) -----------------------------------------


def _read_packets(ws, want_ty, count=1, max_msgs=50):
    """Reassemble length-framed packets from WS byte-stream messages."""
    buf = bytearray()
    out = []
    for _ in range(max_msgs):
        buf += ws.recv_bytes()
        while len(buf) >= 4:
            n = int.from_bytes(buf[:4], "little")
            if len(buf) - 4 < n:
                break
            pkt = M.parse_packet(bytes(buf[4:4 + n]))
            del buf[:4 + n]
            if pkt.ty == want_ty:
                out.append(pkt)
                if len(out) >= count:
                    return out
    raise AssertionError(f"wanted {count} packets of ty={want_ty}, got {out}")


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-server-{p[1]}-client")
def test_ws_bridge_speaks_the_wire_protocol(tmp_path, pair):
    server_pkg, client_pkg = pair
    srv = PKG[server_pkg].Server.start(str(tmp_path / "db"))
    try:
        c = PKG[client_pkg].Client.connect(srv.addr)
        spec = PKG[client_pkg].f64[3].labeled("x", "y", "z")
        with c.table_writer({"ball.world_pos": spec}) as w:
            w.write(1_000_000, {"ball.world_pos": np.array([1.0, 2.0, 3.0])})
        _rows(c, "ball.world_pos", 1)

        ws = WS[client_pkg]("127.0.0.1", srv.port + 1)
        try:
            # control plane: DumpMetadata over WS == over TCP
            ws.send_bytes(M.DumpMetadata().packet(7))
            (pkt,) = _read_packets(ws, M.TY_MSG)
            resp = M.DumpMetadataResp.decode(pkt.body)
            names = {m.name for m in resp.component_metadata}
            assert "ball.world_pos" in names

            # chunked send: a packet split across two WS messages must
            # reassemble (byte-stream semantics)
            raw = M.DumpMetadata().packet(9)
            ws.send_bytes(raw[:5])
            ws.send_bytes(raw[5:])
            (pkt2,) = _read_packets(ws, M.TY_MSG)
            assert M.DumpMetadataResp.decode(pkt2.body) is not None
        finally:
            ws.close()
    finally:
        srv.stop()


def test_ws_upgrade_refused_without_headers(tmp_path):
    import urllib.error
    import urllib.request

    srv = tdb.Server.start(str(tmp_path / "db"))
    try:
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port + 1}/ws", timeout = 5)
            raise AssertionError("expected 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
    finally:
        srv.stop()


def test_ws_upgrade_status_is_http11(tmp_path):
    """RFC 6455 requires the 101 on HTTP/1.1 — browsers reject an
    'HTTP/1.0 101' upgrade outright (BaseHTTPRequestHandler's default
    protocol_version is 1.0; a regression test)."""
    import base64
    import os as _os
    import socket

    srv = tdb.Server.start(str(tmp_path / "db"))
    try:
        sock = socket.create_connection(("127.0.0.1", srv.port + 1))
        try:
            key = base64.b64encode(_os.urandom(16)).decode()
            sock.sendall(
                (f"GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                 f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                 "Sec-WebSocket-Version: 13\r\n\r\n").encode())
            status = sock.makefile("rb").readline()
            assert status.startswith(b"HTTP/1.1 101"), status
        finally:
            sock.close()
    finally:
        srv.stop()


def test_read_frame_control_frames_mid_fragment():
    """RFC 6455 §5.4: PING/PONG may be interjected BETWEEN fragments of a
    message; reassembly must answer them via on_control and keep waiting
    for OP_CONT instead of raising."""
    import io

    from elodin_tpu_torch.db import ws as W

    def frame(fin, opcode, payload):
        head = bytearray([(0x80 if fin else 0) | opcode])
        head.append(len(payload))  # short payloads only, unmasked
        return bytes(head) + payload

    stream = io.BytesIO(
        frame(False, W.OP_BINARY, b"hello ")
        + frame(True, W.OP_PING, b"ping!")
        + frame(True, W.OP_PONG, b"")
        + frame(False, W.OP_CONT, b"world")
        + frame(True, W.OP_CONT, b"!")
    )
    controls = []
    op, payload = W.read_frame(stream, on_control=lambda o, p: controls.append((o, p)))
    assert op == W.OP_BINARY
    assert payload == b"hello world!"
    assert controls == [(W.OP_PING, b"ping!"), (W.OP_PONG, b"")]


def test_ws_bridge_answers_ping_mid_fragment(tmp_path):
    """End-to-end: a client that pings in the middle of a fragmented send
    gets a PONG and the bridged request still completes."""
    import socket

    from elodin_tpu_torch.db import ws as W

    srv = tdb.Server.start(str(tmp_path / "db"))
    try:
        ws = WsClient("127.0.0.1", srv.port + 1)
        try:
            raw = M.DumpMetadata().packet(3)

            def masked(fin, opcode, payload):
                import os as _os

                head = bytearray([(0x80 if fin else 0) | opcode])
                head.append(0x80 | len(payload))
                key = _os.urandom(4)
                head += key
                return bytes(head) + bytes(
                    b ^ key[i % 4] for i, b in enumerate(payload))

            ws.sock.sendall(
                masked(False, W.OP_BINARY, raw[:4])
                + masked(True, W.OP_PING, b"hb")
                + masked(True, W.OP_CONT, raw[4:]))
            # PONG must come back (possibly after data frames); then the
            # metadata response proves the fragmented packet reassembled
            got_pong = False
            deadline = 50
            buf = bytearray()
            ws.sock.settimeout(10.0)
            while deadline:
                deadline -= 1
                op, payload = W.read_frame(
                    ws._rfile,
                    on_control=lambda o, p: None,
                )
                if op == W.OP_PONG:
                    assert payload == b"hb"
                    got_pong = True
                elif op == W.OP_BINARY:
                    buf += payload
                    if len(buf) >= 4:
                        n = int.from_bytes(buf[:4], "little")
                        if len(buf) - 4 >= n:
                            pkt = M.parse_packet(bytes(buf[4:4 + n]))
                            if pkt.ty == M.TY_MSG and got_pong:
                                return  # both halves proven
                if op == W.OP_CLOSE:
                    break
            raise AssertionError(
                f"pong={got_pong}, response never completed")
        finally:
            ws.close()
    finally:
        srv.stop()


# -- scene math (tests/test_scenemath.py) --------------------------------------


# -- GLB construction helper --------------------------------------------------


def make_glb(gltf: dict, bin_chunk: bytes) -> bytes:
    js = json.dumps(gltf).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    bn = bin_chunk + b"\0" * ((4 - len(bin_chunk) % 4) % 4)
    total = 12 + 8 + len(js) + 8 + len(bn)
    out = struct.pack("<III", sm.GLB_MAGIC, 2, total)
    out += struct.pack("<II", len(js), sm.CH_JSON) + js
    out += struct.pack("<II", len(bn), sm.CH_BIN) + bn
    return out


def tri_glb(**node_extra) -> bytes:
    """One triangle in the z=0 plane, uint16 indices, red material."""
    pos = np.asarray([0, 0, 0, 1, 0, 0, 0, 1, 0], "<f4")
    idx = np.asarray([0, 1, 2], "<u2")
    bin_chunk = pos.tobytes() + idx.tobytes()
    gltf = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}],
        "nodes": [dict({"mesh": 0}, **node_extra)],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0}, "indices": 1, "material": 0}
        ]}],
        "materials": [{"pbrMetallicRoughness":
                       {"baseColorFactor": [1, 0, 0, 1]}}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 6},
        ],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    return make_glb(gltf, bin_chunk)


# -- parser -------------------------------------------------------------------


def test_parse_glb_triangle_with_material_and_flat_normals():
    prims = sm.parse_glb(tri_glb())
    assert len(prims) == 1
    p = prims[0]
    np.testing.assert_array_equal(
        p["pos"], np.asarray([0, 0, 0, 1, 0, 0, 0, 1, 0], np.float32))
    np.testing.assert_array_equal(p["idx"], [0, 1, 2])
    assert p["color"] == [1, 0, 0, 1]
    assert p["matrix"] == sm.m4ident()
    # flat normals: +z face normal accumulated at every vertex (normalized
    # in the shader, so direction is what's pinned)
    norm = p["norm"].reshape(3, 3)
    assert (norm[:, 2] > 0).all() and np.allclose(norm[:, :2], 0)


def test_parse_glb_rejects_non_glb():
    with pytest.raises(ValueError, match="not a GLB"):
        sm.parse_glb(b"\0" * 32)
    with pytest.raises(ValueError, match="no JSON chunk"):
        sm.parse_glb(struct.pack("<III", sm.GLB_MAGIC, 2, 12))


def test_parse_glb_node_trs_and_hierarchy():
    """Node matrices compose parent-to-child; TRS converts per glTF."""
    pos = np.asarray([0, 0, 0, 1, 0, 0, 0, 1, 0], "<f4")
    bin_chunk = pos.tobytes()
    gltf = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"children": [1], "translation": [10, 0, 0]},
            {"mesh": 0, "scale": [2, 2, 2], "translation": [0, 5, 0]},
        ],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3,
                       "type": "VEC3"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 36}],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    prims = sm.parse_glb(make_glb(gltf, bin_chunk))
    assert len(prims) == 1
    m = prims[0]["matrix"]
    # world = T(10,0,0) * (T(0,5,0) S(2)): translation column = (10, 5, 0)
    assert m[12] == 10 and m[13] == 5 and m[14] == 0
    assert m[0] == 2 and m[5] == 2 and m[10] == 2
    # explicit matrix field wins over TRS
    gltf["nodes"][1] = {"mesh": 0,
                        "matrix": [1, 0, 0, 0, 0, 1, 0, 0,
                                   0, 0, 1, 0, 7, 8, 9, 1]}
    prims = sm.parse_glb(make_glb(gltf, bin_chunk))
    m = prims[0]["matrix"]
    assert (m[12], m[13], m[14]) == (17, 8, 9)


def test_parse_glb_interleaved_accessor():
    """byteStride-interleaved POSITION/NORMAL gather element-by-element."""
    # layout per vertex: pos(3f) norm(3f), stride 24
    inter = np.zeros((3, 6), "<f4")
    inter[:, :3] = [[0, 0, 0], [1, 0, 0], [0, 1, 0]]
    inter[:, 3:] = [[0, 0, 1]] * 3
    bin_chunk = inter.tobytes()
    gltf = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0, "NORMAL": 1}}
        ]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3", "byteOffset": 0},
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3", "byteOffset": 12},
        ],
        "bufferViews": [{"buffer": 0, "byteOffset": 0,
                         "byteLength": len(bin_chunk), "byteStride": 24}],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    prims = sm.parse_glb(make_glb(gltf, bin_chunk))
    np.testing.assert_array_equal(
        prims[0]["pos"].reshape(3, 3), inter[:, :3])
    np.testing.assert_array_equal(
        prims[0]["norm"].reshape(3, 3), inter[:, 3:])


def test_parse_glb_uint8_indices_widened():
    """Non-u16/u32 index component types widen to uint32 (WebGL upload)."""
    pos = np.asarray([0, 0, 0, 1, 0, 0, 0, 1, 0], "<f4")
    idx = np.asarray([0, 1, 2], "u1")
    bin_chunk = pos.tobytes() + idx.tobytes()
    gltf = {
        "asset": {"version": "2.0"},
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": 0}, "indices": 1}
        ]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5121, "count": 3,
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 3},
        ],
        "buffers": [{"byteLength": len(bin_chunk)}],
    }
    prims = sm.parse_glb(make_glb(gltf, bin_chunk))
    assert prims[0]["idx"].dtype == np.uint32


def test_glb_to_json_b64_roundtrip():
    out = sm.glb_to_json(tri_glb())
    p = out["prims"][0]
    pos = np.frombuffer(base64.b64decode(p["pos_b64"]), "<f4")
    np.testing.assert_array_equal(pos, [0, 0, 0, 1, 0, 0, 0, 1, 0])
    idx = np.frombuffer(base64.b64decode(p["idx_b64"]),
                        "<u4" if p["idx_u32"] else "<u2")
    np.testing.assert_array_equal(idx, [0, 1, 2])
    json.dumps(out)  # JSON-serializable end to end


# -- matrix math --------------------------------------------------------------


def test_m4_quat_pos_scale_matches_numpy():
    rng = np.random.default_rng(7)
    v = rng.normal(size=4)
    v /= np.linalg.norm(v)
    q = {"x": v[0], "y": v[1], "z": v[2], "w": v[3]}
    m = np.asarray(sm.m4_from_quat_pos_scale(q, [1, 2, 3], [2, 2, 2]))
    m = m.reshape(4, 4).T  # column-major -> row-major
    # rotation part must be 2*orthonormal, translation exact
    r = m[:3, :3] / 2.0
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(m[:3, 3], [1, 2, 3])
    assert abs(np.linalg.det(r) - 1) < 1e-12


def test_m4mul_matches_numpy():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=16).tolist(), rng.normal(size=16).tolist()
    got = np.asarray(sm.m4mul(a, b)).reshape(4, 4, order="F")
    want = (np.asarray(a).reshape(4, 4, order="F")
            @ np.asarray(b).reshape(4, 4, order="F"))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_arrow_mats_layout():
    shaft, head = sm.arrow_mats({"shaft_length": 2.0, "shaft_diameter": 0.2,
                                 "head_length": 0.5, "head_diameter": 0.4})
    # shaft: unit cylinder (z axis) rotated to +x, centered at x = sl/2
    assert (shaft[12], shaft[13], shaft[14]) == (1.0, 0.0, 0.0)
    sh = np.asarray(shaft).reshape(4, 4, order="F")[:3, :3]
    # local z (third column) maps to +/-x with length sl
    np.testing.assert_allclose(np.abs(sh[:, 2]), [2, 0, 0], atol=1e-12)
    # head cone starts at the shaft tip
    assert (head[12], head[13], head[14]) == (2.0, 0.0, 0.0)
    hd = np.asarray(head).reshape(4, 4, order="F")[:3, :3]
    np.testing.assert_allclose(np.diag(hd), [0.5, 0.2, 0.2], atol=1e-12)


# -- draw list + framing -------------------------------------------------------


def _pose(x=0.0, y=0.0, z=0.0):
    return {"position": {"x": x, "y": y, "z": z},
            "orientation": {"x": 0, "y": 0, "z": 0, "w": 1}}


def test_build_draw_list_kinds_and_frame_transform():
    red = {"r": 1, "g": 0, "b": 0, "a": 1}
    scene = {
        "transforms": {"sat": _pose(10, 0, 0)},
        "entities": [
            {"frame_id": "sat", "spheres": [
                {"pose": _pose(1, 0, 0), "color": red,
                 "size": {"x": 2, "y": 2, "z": 2}}],
             "arrows": [
                {"pose": _pose(), "color": red, "shaft_length": 1.0,
                 "shaft_diameter": 0.1, "head_length": 0.2,
                 "head_diameter": 0.2}]},
            {"frame_id": "free", "cubes": [
                {"pose": _pose(0, 5, 0), "color": red,
                 "size": {"x": 1, "y": 1, "z": 1}}],
             "lines": [
                {"color": red,
                 "points": [{"x": 0, "y": 0, "z": 0},
                            {"x": 1, "y": 1, "z": 1}]}],
             "models": [
                {"pose": _pose(3, 0, 0), "url": "/assets/m.glb",
                 "override_color": True, "color": red,
                 "scale": {"x": 1, "y": 1, "z": 1}}]},
        ],
    }
    dl = sm.build_draw_list(scene)
    # arrow expands to cylinder + cone; sphere radius = size/2
    kinds = [s["kind"] for s in dl["solids"]]
    assert kinds == ["sphere", "cylinder", "cone", "cube"]
    sph = dl["solids"][0]
    # frame-locked: sat transform (x=10) premultiplies the local x=1 pose
    assert sph["mat"][12] == 11 and sph["mat"][0] == 1.0
    # entity without a registered transform renders at its own pose
    assert dl["solids"][3]["mat"][13] == 5
    assert dl["lines"][0]["pts"] == [0, 0, 0, 1, 1, 1]
    assert dl["glbs"][0]["color"] == red  # override_color passes through
    assert dl["glbs"][0]["url"] == "/assets/m.glb"

    # no override -> color None (client uses the GLB material)
    scene["entities"][1]["models"][0]["override_color"] = False
    assert sm.build_draw_list(scene)["glbs"][0]["color"] is None


def test_frame_scene_center_radius_and_empty():
    dl = {"solids": [{"mat": sm.m4_from_quat_pos_scale(
        {"x": 0, "y": 0, "z": 0, "w": 1}, [10, 0, 0], [1, 1, 1])}],
        "glbs": [], "lines": [{"pts": [-10, 0, 0]}]}
    fr = sm.frame_scene(dl)
    np.testing.assert_allclose(fr["center"], [0, 0, 0], atol=1e-12)
    assert abs(fr["radius"] - 10) < 1e-9
    assert sm.frame_scene({"solids": [], "glbs": [], "lines": []}) == {
        "center": [0.0, 0.0, 0.0], "radius": 10.0}


# -- unit geometry -------------------------------------------------------------


@pytest.mark.parametrize("name,geom", [
    ("cube", sm.geom_cube()),
    ("sphere", sm.geom_sphere(18, 28)),
    ("cylinder", sm.geom_cylinder(24)),
    ("cone", sm.geom_cone(24)),
])
def test_geom_invariants(name, geom):
    pos = geom["pos"].reshape(-1, 3)
    norm = geom["norm"].reshape(-1, 3)
    idx = geom["idx"]
    assert len(pos) == len(norm)
    assert idx.max() < len(pos) and idx.min() >= 0
    assert len(idx) % 3 == 0
    # winding: every face normal must agree with the vertex normals
    tri = idx.reshape(-1, 3).astype(int)
    fn = np.cross(pos[tri[:, 1]] - pos[tri[:, 0]],
                  pos[tri[:, 2]] - pos[tri[:, 0]])
    ok = (fn * norm[tri[:, 0]]).sum(axis=1) >= -1e-6
    assert ok.all(), f"{name}: {int((~ok).sum())} backwards faces"


def test_geom_shapes():
    cube = sm.geom_cube()["pos"].reshape(-1, 3)
    assert np.abs(cube).max() == 0.5
    sph = sm.geom_sphere(6, 8)
    np.testing.assert_allclose(
        np.linalg.norm(sph["pos"].reshape(-1, 3), axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(sph["pos"], sph["norm"], atol=1e-6)
    cyl = sm.geom_cylinder(8)["pos"].reshape(-1, 3)
    assert cyl[:, 2].min() == -0.5 and cyl[:, 2].max() == 0.5
    cone = sm.geom_cone(8)["pos"].reshape(-1, 3)
    assert cone[:, 0].min() == 0 and cone[:, 0].max() == 1


def test_geoms_to_json_decodable():
    gj = sm.geoms_to_json()
    assert set(gj) == {"cube", "sphere", "cylinder", "cone"}
    for g in gj.values():
        pos = np.frombuffer(base64.b64decode(g["pos_b64"]), "<f4")
        idx = np.frombuffer(base64.b64decode(g["idx_b64"]), "<u2")
        assert idx.max() < len(pos) // 3
    json.dumps(gj)


# -- the port against the JAX package --------------------------------------------


def _ws_time_series(ws, name, prim, shape, req_id=5):
    """``Client.time_series`` over the ``/ws`` bridge: one GetTimeSeries
    request, its reply decoded as the TCP client decodes it."""
    from elodin_tpu_torch.db.vtable import PRIM_NP, component_id_of

    msg = M.GetTimeSeries(b"\x00\x01", -(2**62), 2**62, component_id_of(name), None)
    ws.send_bytes(msg.packet(req_id))
    buf = bytearray()
    while True:
        buf += ws.recv_bytes()
        while len(buf) >= 4:
            n = int.from_bytes(buf[:4], "little")
            if len(buf) - 4 < n:
                break
            pkt = M.parse_packet(bytes(buf[4:4 + n]))
            del buf[:4 + n]
            if pkt.req_id != req_id:
                continue
            rows = int.from_bytes(pkt.body[:8], "little")
            ts = np.frombuffer(pkt.body[8:8 + rows * 8], dtype="<i8")
            vals = np.frombuffer(pkt.body[8 + rows * 8:], dtype=PRIM_NP[prim])
            return ts, vals.reshape((rows,) + tuple(shape))


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-server-{p[1]}-client")
def test_ws_time_series_is_the_tcp_clients(tmp_path, pair):
    """A ``time_series`` read through ``/ws`` is bitwise the TCP client's."""
    server_pkg, client_pkg = pair
    srv = PKG[server_pkg].Server.start(str(tmp_path / "db"))
    try:
        c = PKG[client_pkg].Client.connect(srv.addr)
        rng = np.random.default_rng(11)
        rows = rng.standard_normal((64, 7))
        with c.table_writer({"b0.world_pos": PKG[client_pkg].f64[7]}) as w:
            for i, row in enumerate(rows):
                w.write(1_000_000 + i * 16_667, {"b0.world_pos": row})
        _rows(c, "b0.world_pos", 64)
        ts, vals = c.time_series("b0.world_pos")
        ws = WS[client_pkg]("127.0.0.1", srv.port + 1)
        try:
            wts, wvals = _ws_time_series(ws, "b0.world_pos", "f64", (7,))
        finally:
            ws.close()
        assert np.array_equal(wts, ts) and np.array_equal(wvals, vals)
        assert np.array_equal(wvals, rows)
        c.close()
    finally:
        srv.stop()


def _viewer_db(path):
    """One database on disk holding what every route reads: two scalar and
    vector series (one with NaN and inf), a schematic with a trajectory, a
    sphere, an arrow and a GLB model, a text log and an H.264 log."""
    from test_db import _golomb_sps

    from elodin_tpu_torch.db.postcard import msg_id

    srv = tdb.Server.start(path)
    try:
        c = tdb.Client.connect(srv.addr)
        spec = tdb.f64[3].labeled("x", "y", "z")
        with c.table_writer({"ball.world_vel": spec}) as w:
            for i in range(100):
                w.write(1_000_000 + i * 1000,
                        {"ball.world_vel": np.array([i, 2.0 * i, -i]) / 7.0})
        with c.table_writer({"nan.x": tdb.f64}) as w:
            for i, v in enumerate([1.0, float("nan"), float("inf"), 3.0]):
                w.write(1_000_000 + i * 1000, {"nan.x": v})
        for i in range(5):
            c.send("sat.world_pos", np.array([0, 0, 0, 1, 1.0 + 0.5 * i, 2.0, 3.0]),
                   timestamp_us=1_000_000 + i * 10_000)
        _rows(c, "ball.world_vel", 100)
        _rows(c, "nan.x", 4)
        _rows(c, "sat.world_pos", 5)
        c.close()
        srv.db.assets.put("m.glb", tri_glb())
        srv.db.assets.put("schematic.kdl", b"""
line_3d sat.world_pos color=yellow
object_3d sat.world_pos {
    sphere radius=0.5 { material base_color=red }
}
object_3d sat.world_pos {
    glb path="m.glb"
}
vector_arrow "(1.0, 0.0, 0.0)" origin="sat.world_pos" name="x"
graph "ball.world_vel"
""")
        log = srv.db.msg_log(msg_id("sim.log"))
        log.set_metadata(M.MsgMetadata(1, "sim.log", {}))
        log.append(1_000_000, b"hello from the sim")
        log.append(2_000_000, bytes([0, 1, 2, 254, 255]))
        video = srv.db.msg_log(msg_id("video.cam0"))
        video.set_metadata(M.MsgMetadata(2, "video.cam0", {}))
        sc = b"\x00\x00\x00\x01"
        for i in range(8):
            payload = (sc + _golomb_sps() + sc + b"\x68\xce\x3c\x80" + sc + b"\x65"
                       + bytes(range(1, 40))) if i % 4 == 0 else (sc + b"\x41" + bytes(range(1, 24)))
            video.append(1_000_000 + i * 33_333, payload)
        srv.db.flush()
    finally:
        srv.stop()
    return msg_id("sim.log").hex(), msg_id("video.cam0").hex()


ROUTES = [
    "/", "/static/viewer.js", "/static/scene3d.js", "/healthz",
    "/api/info", "/api/components",
    "/api/series?name=ball.world_vel&max_points=20",
    "/api/series?name=ball.world_vel&start_us=1050000&stop_us=1060000",
    "/api/series?name=nan.x", "/api/latest?name=ball.world_vel",
    "/api/schematic", "/api/scene", "/api/scene?ts_us=1010000",
    "/api/drawlist", "/api/drawlist?ts_us=1000000",
    "/api/glb?url=/assets/m.glb", "/api/geoms",
    "/api/msg-logs", "/api/msgs?id={log}", "/api/videos", "/api/video?id={video}",
    "/api/sql?q=" + urllib.request.quote("select * from ball_world_vel"),
    "/assets/m.glb",
]


@pytest.fixture(scope="module")
def served_bodies(tmp_path_factory):
    """Every route's (status, content type, body), from each package's
    server in turn over the same database."""
    path = str(tmp_path_factory.mktemp("viewer") / "db")
    log, video = _viewer_db(path)
    out = {}
    for pkg in ("torch", "jax"):
        srv = PKG[pkg].Server.start(path)
        try:
            base = f"http://127.0.0.1:{srv.port + 1}"
            out[pkg] = {r: _get(base + r.format(log=log, video=video)) for r in ROUTES}
        finally:
            srv.stop()
    return out


@pytest.mark.parametrize("route", ROUTES)
def test_api_bodies_are_the_jax_packages(served_bodies, route):
    ours, ref = served_bodies["torch"][route], served_bodies["jax"][route]
    assert ours[0] == 200 and ours[2], (route, ours[:2])
    assert ours == ref, route


def _scene():
    red = {"r": 1, "g": 0, "b": 0, "a": 1}
    return {
        "transforms": {"sat": _pose(10, 0, 0)},
        "entities": [
            {"frame_id": "sat", "spheres": [
                {"pose": _pose(1, 0, 0), "color": red,
                 "size": {"x": 2, "y": 2, "z": 2}}],
             "arrows": [
                {"pose": _pose(), "color": red, "shaft_length": 1.0,
                 "shaft_diameter": 0.1, "head_length": 0.2,
                 "head_diameter": 0.2}]},
            {"frame_id": "free", "cubes": [
                {"pose": _pose(0, 5, 0), "color": red,
                 "size": {"x": 1, "y": 1, "z": 1}}],
             "cylinders": [
                {"pose": _pose(-3, 1, 2), "color": red,
                 "size": {"x": 0.5, "y": 0.5, "z": 4}}],
             "lines": [
                {"color": red,
                 "points": [{"x": 0, "y": 0, "z": 0},
                            {"x": 1, "y": 1, "z": 1}]}],
             "models": [
                {"pose": _pose(3, 0, 0), "url": "/assets/m.glb",
                 "override_color": True, "color": red,
                 "scale": {"x": 1, "y": 1, "z": 1}}]},
        ],
    }


def _same(a, b):
    """Bitwise equality through nested dicts, lists and arrays."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.tobytes() == b.tobytes())
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and (a == b or (a != a and b != b))


def test_scene_math_is_the_jax_packages():
    """The same GLBs and scene through both packages' scene math: the
    primitives, JSON, draw list, framing and unit geometry are bitwise
    equal."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    quat = {"x": q[0], "y": q[1], "z": q[2], "w": q[3]}
    glbs = [tri_glb(), tri_glb(translation=[1, 2, 3], scale=[2, 2, 2]),
            tri_glb(rotation=[quat[k] for k in "xyzw"])]
    for glb in glbs:
        assert _same(sm.parse_glb(glb), jsm.parse_glb(glb))
        assert json.dumps(sm.glb_to_json(glb)) == json.dumps(jsm.glb_to_json(glb))
    ours, ref = sm.build_draw_list(_scene()), jsm.build_draw_list(_scene())
    assert _same(ours, ref) and len(ours["solids"]) == 5
    assert _same(sm.frame_scene(ours), jsm.frame_scene(ref))
    assert _same(sm.m4_from_quat_pos_scale(quat, [1, 2, 3], [2, 3, 4]),
                 jsm.m4_from_quat_pos_scale(quat, [1, 2, 3], [2, 3, 4]))
    assert json.dumps(sm.geoms_to_json()) == json.dumps(jsm.geoms_to_json())
