"""Asset storage + HTTP server (parity: libs/db/src/assets_http.rs and the
StoreAsset message [224,40]).

Assets (KDL schematics, GLB models, skyboxes) are named blobs under
``<db_path>/assets``; the HTTP server exposes GET/PUT on
``http://<host>:<tcp_port + 1>/assets/<key>`` as the editor expects.

A host-only copy of ``elodin_tpu/db/assets.py``:
the port imports nothing of the JAX package.  The web viewer's ``/api/*``
routes (``webui.py``) and the ``/ws`` bridge (``ws.py``) belong to the
database's second half (ROADMAP.md §1 item 6) and are not served yet.
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
                 host: str = "127.0.0.1", db=None):
        self.store = store
        self.db = db  # optional Database for /healthz and /metrics
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # Every handler path sets Content-Length (or replies 204), so
            # HTTP/1.1 keep-alive is safe.
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_GET(self):
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
