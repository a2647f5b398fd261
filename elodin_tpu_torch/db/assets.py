"""Asset storage + HTTP server (parity: libs/db/src/assets_http.rs and the
StoreAsset message [224,40]).

Assets (KDL schematics, GLB models, skyboxes) are named blobs under
``<db_path>/assets``; the HTTP server exposes GET/PUT on
``http://<host>:<tcp_port + 1>/assets/<key>`` as the editor expects.

A host-only copy of ``elodin_tpu/db/assets.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

MAX_UPLOAD = 256 * 1024 * 1024


class AssetStore:
    def __init__(self, path: Path | None):
        self.path = Path(path) / "assets" if path else None
        self.mem: dict[str, bytes] = {}
        if self.path:
            self.path.mkdir(parents=True, exist_ok=True)

    def put(self, key: str, data: bytes) -> None:
        key = self._safe(key)
        if self.path:
            # disk-backed: don't ALSO pin every upload in RAM forever
            # (get() falls through to disk); evict a stale mem entry so a
            # re-upload is visible
            self.mem.pop(key, None)
            dest = self.path / key
            dest.parent.mkdir(parents=True, exist_ok=True)
            dest.write_bytes(data)
        else:
            self.mem[key] = bytes(data)

    def get(self, key: str) -> bytes | None:
        key = self._safe(key)
        if key in self.mem:
            return self.mem[key]
        if self.path and (self.path / key).is_file():
            return (self.path / key).read_bytes()
        return None

    def keys(self) -> list[str]:
        out = set(self.mem)
        if self.path:
            out.update(
                str(p.relative_to(self.path))
                for p in self.path.rglob("*")
                if p.is_file()
            )
        return sorted(out)

    @staticmethod
    def _safe(key: str) -> str:
        key = key.lstrip("/")
        if ".." in key.split("/"):
            raise ValueError("invalid asset path")
        return key


class AssetHttpServer:
    """GET/PUT /assets/<key>; port defaults to tcp_port + 1
    (assets_http.rs assets_http_addr)."""

    def __init__(self, store: AssetStore, port: int = 0,
                 host: str = "127.0.0.1", db=None, ws_tcp_port=None):
        self.store = store
        self.db = db  # optional Database for /healthz and /metrics
        # GET /ws upgrades to a WebSocket carrying the FULL DB wire
        # protocol, bridged to the TCP server at this loopback port
        # (reference: the impeller2 ws transport, libs/db/src/lib.rs)
        self.ws_tcp_port = ws_tcp_port
        # extensible GET routes: prefix -> fn(path, query) -> (status, ctype,
        # body); the web UI (db/webui.py) registers /api/* and / here
        self.routes: dict[str, object] = {}
        if db is not None:
            try:
                from .webui import register_routes

                register_routes(self.routes, db)
            except Exception as e:  # noqa: BLE001
                import sys as _sys

                # never silently: every /api/* request would 404 with no
                # hint that the viewer failed to register
                print(f"warning: web viewer unavailable: {e}",
                      file=_sys.stderr)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # RFC 6455 requires the 101 upgrade on HTTP/1.1 — browsers
            # reject an 'HTTP/1.0 101' status line outright (the default
            # protocol_version here is 1.0).  Every handler path sets
            # Content-Length (or replies 204), so 1.1 keep-alive is safe.
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse

                parsed = urlparse(self.path)
                if parsed.path == "/ws" and outer.ws_tcp_port is not None:
                    from . import ws as _ws

                    fields = _ws.handshake_fields(self.headers)
                    if fields is None:
                        self.send_response(400)
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    self.send_response(101)
                    for k, v in fields.items():
                        self.send_header(k, v)
                    self.end_headers()
                    self.wfile.flush()
                    try:
                        # occupies this handler thread for the connection
                        _ws.serve_bridge(self.rfile, self.connection,
                                         outer.ws_tcp_port)
                    finally:
                        self.close_connection = True
                    return
                route = None
                for prefix in sorted(outer.routes, key=len, reverse=True):
                    if parsed.path == prefix or (
                        len(prefix) > 1 and prefix.endswith("/")
                        and parsed.path.startswith(prefix)
                    ):
                        route = outer.routes[prefix]
                        break
                if route is not None:
                    query = {
                        k: v[-1] for k, v in parse_qs(parsed.query).items()
                    }
                    try:
                        status, ctype, body = route(parsed.path, query)
                    except Exception as e:  # surface handler errors as 500s
                        status, ctype = 500, "text/plain"
                        body = str(e).encode()
                    if status == 200:
                        self._ok(body, ctype)
                    else:
                        # error text goes in the BODY only — send_error would
                        # echo it into the status line, and route errors can
                        # contain user-controlled text (response splitting)
                        self.send_response(status)
                        self.send_header("Content-Type", "text/plain")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    return
                if self.path == "/healthz":
                    self._ok(b"ok", "text/plain")
                    return
                if self.path == "/metrics" and outer.db is not None:
                    # Prometheus-style text exposition of store stats
                    import time as _time

                    lines = []
                    with outer.db.lock:
                        comps = list(outer.db.components.values())
                        n_msgs = sum(
                            len(m.entries)
                            for m in outer.db.msg_logs.values()
                        )
                    lines.append(
                        f"elodin_db_components {len(comps)}"
                    )
                    lines.append(
                        "elodin_db_rows_total "
                        f"{sum(c.len for c in comps)}"
                    )
                    lines.append(f"elodin_db_msgs_total {n_msgs}")
                    latest = max(
                        (int(c.timestamps[c.len - 1]) for c in comps if c.len),
                        default=0,
                    )
                    lines.append(f"elodin_db_latest_timestamp_us {latest}")
                    lines.append(
                        f"elodin_db_scrape_time_us {int(_time.time() * 1e6)}"
                    )
                    self._ok(("\n".join(lines) + "\n").encode(), "text/plain")
                    return
                if self.path == "/assets" or self.path == "/assets/":
                    body = "\n".join(outer.store.keys()).encode()
                    self._ok(body, "text/plain")
                    return
                if not self.path.startswith("/assets/"):
                    self.send_error(404)
                    return
                from urllib.parse import unquote, urlparse

                # strip query strings and percent-decoding like the route
                # dispatch above — '/assets/foo.glb?v=2' and keys with
                # spaces must resolve
                key = unquote(urlparse(self.path).path[len("/assets/"):])
                try:
                    data = outer.store.get(key)
                except (ValueError, OSError):  # NUL bytes, bad paths
                    data = None
                if data is None:
                    self.send_error(404)
                    return
                ctype = (
                    "model/gltf-binary" if key.endswith(".glb")
                    else "text/plain" if key.endswith(".kdl")
                    else "application/octet-stream"
                )
                self._ok(data, ctype)

            def do_PUT(self):
                if not self.path.startswith("/assets/"):
                    self.send_error(404)
                    return
                from urllib.parse import unquote, urlparse

                # mirror do_GET's key derivation (percent-decode, strip
                # query) or PUT-then-GET of the same URL 404s
                key = unquote(urlparse(self.path).path[len("/assets/"):])
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self.send_error(400)
                    return
                if n < 0 or not key or "\x00" in key:
                    self.send_error(400)
                    return
                if n > MAX_UPLOAD:
                    self.send_error(413)
                    return
                data = self.rfile.read(n)
                try:
                    outer.store.put(key, data)
                except (ValueError, OSError):
                    self.send_error(400)
                    return
                self.send_response(204)
                self.end_headers()

            def _ok(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
