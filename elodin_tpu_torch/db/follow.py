"""DB -> DB follow replication (parity: libs/db/src/follow.rs).

A follower database subscribes to a leader's real-time stream and mirrors
every component row (and message) into its own store — used in the
reference for ground-station mirroring of a flight DB.

A host-only copy of ``elodin_tpu/db/follow.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import threading


from . import msgs as M
from .client import _Conn
from .storage import Database


class Follower:
    """Mirrors a leader database: metadata, schemas, FULL history, and
    live rows, over one FollowStream subscription (follow.rs unified
    replication; wire shape msgs.rs FollowStream [224,37])."""

    def __init__(self, db: Database, leader_addr: str, server=None):
        self.db = db
        self.server = server  # optional local Server to notify for fan-out
        self._conn = _Conn(leader_addr)
        self._vtables: dict[bytes, object] = {}
        self._id_names: dict[int, str] = {}
        self._stop = threading.Event()
        self.rows_mirrored = 0
        self._conn.add_stream_handler(self._on_packet)
        req_id = self._conn.next_req_id()
        self._conn.send_bytes(M.FollowStream(1500).packet(req_id))

    def _on_packet(self, pkt: M.Packet) -> None:
        if self._stop.is_set():
            return
        if pkt.ty == M.TY_MSG and pkt.id == M.VTableMsg.ID:
            vtm = M.VTableMsg.decode(pkt.body)
            self._vtables[vtm.id] = vtm.vtable
            return
        if pkt.ty == M.TY_MSG and pkt.id == M.ComponentMetadata.ID:
            cm = M.ComponentMetadata.decode(pkt.body)
            self._id_names[cm.component_id] = cm.name
            store = self.db.components.get(cm.component_id)
            if store is not None:
                store.set_metadata(name=cm.name, metadata=cm.metadata)
            return
        if pkt.ty == M.TY_MSG and pkt.id == M.DumpSchemaResp.ID:
            return  # schemas arrive implicitly with each table's vtable
        if pkt.ty == M.TY_TABLE:
            vt = self._vtables.get(pkt.id)
            if vt is None:
                return
            touched = []
            ts_fallback = None
            for f in vt.realize_fields(pkt.body):
                cid = f["component_id"]
                if cid is None or f["ty"] is None:
                    continue
                store = self.db.get_or_create(
                    cid, f["ty"], f["shape"], self._id_names.get(cid)
                )
                ts = f["timestamp"]
                if ts is None:
                    from .storage import now_timestamp_us

                    # explicit None check: a legitimate timestamp of 0
                    # (epoch / sim-relative bases) is not "missing"
                    ts = (
                        ts_fallback if ts_fallback is not None
                        else now_timestamp_us()
                    )
                ts_fallback = ts
                store.append(ts, f["data"])
                touched.append(cid)
                self.rows_mirrored += 1
            if touched and self.server is not None:
                self.server.notify_table(
                    touched, ts_fallback if ts_fallback is not None else 0
                )
        elif pkt.ty == M.TY_MSG_WITH_TIMESTAMP:
            ts = int.from_bytes(pkt.body[:8], "little", signed=True)
            self.db.msg_log(pkt.id).append(ts, pkt.body[8:])

    def stop(self) -> None:
        self._stop.set()
        self._conn.close()


def follow(leader_addr: str, path: str | None = None,
           server=None) -> Follower:
    db = server.db if server is not None else Database(path)
    return Follower(db, leader_addr, server)
