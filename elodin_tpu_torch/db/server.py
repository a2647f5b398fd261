"""elodin-db server: TCP telemetry store + message bus
(parity: libs/db/src/lib.rs — Server::run :1673, handle_conn :1701, message
dispatch :1985+).

asyncio-based (one task per connection) over the shared ``Database``.  The
reference runs a single-threaded io_uring executor (stellarator); the
contract preserved here is the same one SURVEY §1 L5 calls out: telemetry IO
never blocks the simulation step loop — the sim thread appends to the store
under a lock and subscribers drain on their own tasks.

A host-only copy of ``elodin_tpu/db/server.py``:
the port imports nothing of the JAX package.  A real-time stream lays out a
store's rows' packets with numpy and sends a batch's packets in chunks
(``_STREAM_CHUNK``), not a send a packet: the same bytes in the same
order.
"""

from __future__ import annotations

import asyncio
import threading

import numpy as np

from . import msgs as M
from .storage import Database, now_timestamp_us
from .vtable import VTable, build_table_vtable

_STREAM_CHUNK = 1 << 18  # bytes of a real-time batch sent at once


class Connection:
    def __init__(self, server: "Server", reader, writer):
        self.server = server
        self.db = server.db
        self.reader = reader
        self.writer = writer
        self.vtables: dict[bytes, VTable] = {}
        self.stream_tasks: list[asyncio.Task] = []
        self.sub_queues: list[asyncio.Queue] = []
        # per-CONNECTION replay-stream states: ids are client-chosen (each
        # client counts 1..255), so a server-global dict would let one
        # connection's SetStreamState seek another's replay
        self.stream_states: dict[int, dict] = {}
        self.msg_subs: set[bytes] = set()
        self.send_lock = asyncio.Lock()
        self.silent = False  # ConnectionSettings{silent}: suppress replies

    async def send(self, data: bytes) -> None:
        if self.silent:
            return
        async with self.send_lock:
            self.writer.write(data)
            await self.writer.drain()

    async def run(self) -> None:
        try:
            buf = bytearray()
            while True:
                chunk = await self.reader.read(1 << 16)
                if not chunk:
                    break
                buf += chunk
                # drain every complete packet in the buffer; consecutive
                # data-plane table packets with the same vtable batch into
                # one vectorized store append (high-rate ingest path)
                pending_tables: list[M.Packet] = []
                pos = 0
                while len(buf) - pos >= 4:
                    n = int.from_bytes(buf[pos : pos + 4], "little")
                    if len(buf) - pos - 4 < n:
                        break
                    raw_pkt = bytes(buf[pos + 4 : pos + 4 + n])
                    pos += 4 + n
                    pkt = None
                    try:
                        # parse INSIDE the guard: a runt frame (n < header
                        # size) must not tear down the whole connection
                        pkt = M.parse_packet(raw_pkt)
                        if pkt.ty == M.TY_TABLE:
                            if pending_tables and pending_tables[0].id != pkt.id:
                                self.handle_table_batch(pending_tables)
                                pending_tables = []
                            pending_tables.append(pkt)
                            continue
                        if pending_tables:
                            self.handle_table_batch(pending_tables)
                            pending_tables = []
                        await self.handle(pkt)
                    except (asyncio.CancelledError, ConnectionError):
                        raise
                    except Exception as e:  # noqa: BLE001
                        # one malformed packet (bad vtable, bogus msg body)
                        # must not silently kill the whole connection task —
                        # report and keep serving
                        try:
                            await self.send(
                                M.ErrorResponse(str(e)).packet(
                                    pkt.req_id if pkt is not None else 0
                                )
                            )
                        except Exception:  # noqa: BLE001
                            pass
                if pending_tables:
                    try:
                        self.handle_table_batch(pending_tables)
                    except Exception as e:  # noqa: BLE001
                        try:
                            await self.send(M.ErrorResponse(str(e)).packet(0))
                        except Exception:  # noqa: BLE001
                            pass
                del buf[:pos]
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            for t in self.stream_tasks:
                t.cancel()
            for q in self.sub_queues:
                self.server.remove_subscriber(q)
            for subs in self.server.vtable_stream_subs.values():
                for s in subs:
                    if getattr(s[0], "owner", None) is self:
                        getattr(s[0], "close", lambda: None)()
                subs[:] = [
                    s for s in subs
                    if s[0] is not self
                    and getattr(s[0], "owner", None) is not self
                ]
            self.server.follow_all_msgs[:] = [
                s for s in self.server.follow_all_msgs if s[0] is not self
            ]
            for subs in self.server.msg_subscribers.values():
                subs[:] = [s for s in subs if s[0] is not self]
            self.server.last_updated_subs[:] = [
                s for s in self.server.last_updated_subs if s[0] is not self
            ]
            self.writer.close()

    # -- dispatch (libs/db/src/lib.rs:1985+) ------------------------------

    async def handle(self, pkt: M.Packet) -> None:
        if pkt.ty == M.TY_TABLE:
            self.handle_table(pkt)
            return
        if pkt.ty == M.TY_MSG_WITH_TIMESTAMP:
            ts = int.from_bytes(pkt.body[:8], "little", signed=True)
            self.db.msg_log(pkt.id).append(ts, pkt.body[8:])
            self.server.notify_msg(pkt.id, ts, pkt.body[8:])
            return
        if pkt.ty != M.TY_MSG:
            return

        cls = M.MSG_TYPES.get(pkt.id)
        if cls is None:
            # user message -> append to log
            ts = now_timestamp_us()
            self.db.msg_log(pkt.id).append(ts, pkt.body)
            self.server.notify_msg(pkt.id, ts, pkt.body)
            return

        msg = cls.decode(pkt.body)
        handler = getattr(self, f"on_{cls.__name__}", None)
        if handler is not None:
            await handler(msg, pkt.req_id)

    def handle_table(self, pkt: M.Packet) -> None:
        vt = self.vtables.get(pkt.id) or self.db.vtables.get(pkt.id)
        if vt is None:
            return
        default_ts = now_timestamp_us()
        touched = []
        max_ts = None
        with self.db.lock:  # readers (SQL sync, exports) slice under it
            for f in vt.realize_fields(pkt.body):
                cid = f["component_id"]
                if cid is None or f["ty"] is None:
                    continue
                store = self.db.get_or_create(cid, f["ty"], f["shape"])
                ts = f["timestamp"] if f["timestamp"] is not None else default_ts
                store.append(ts, f["data"])
                max_ts = ts if max_ts is None else max(max_ts, ts)
                touched.append(cid)
        if touched:
            self.server.notify_table(touched, max_ts if max_ts is not None else default_ts)
            if self.server.on_external_write is not None:
                self.server.on_external_write(touched)
        self.server.forward_vtable_stream(pkt, vt)

    def handle_table_batch(self, pkts: list[M.Packet]) -> None:
        """Vectorized ingest of consecutive same-vtable table packets:
        one numpy slice + one store.append_batch per field instead of a
        Python parse per row."""
        if len(pkts) == 1:
            self.handle_table(pkts[0])
            return
        vt = self.vtables.get(pkts[0].id) or self.db.vtables.get(pkts[0].id)
        if vt is None:
            return
        layout = vt.static_layout()
        row_len = len(pkts[0].body)
        if (
            layout is None
            or len(pkts) < 4
            or any(len(p.body) != row_len for p in pkts)
        ):
            for p in pkts:
                self.handle_table(p)
            return
        import numpy as _np

        mat = _np.frombuffer(
            b"".join(p.body for p in pkts), dtype=_np.uint8
        ).reshape(len(pkts), row_len)
        default_ts = now_timestamp_us()
        touched = []
        max_ts = None
        from .vtable import PRIM_NP

        with self.db.lock:
          for fld in layout:
            cid, ty = fld["component_id"], fld["ty"]
            if cid is None or ty is None:
                continue
            store = self.db.get_or_create(cid, ty, fld["shape"])
            if fld["ts_offset"] is not None:
                ts = (
                    _np.ascontiguousarray(
                        mat[:, fld["ts_offset"] : fld["ts_offset"] + 8]
                    )
                    .view("<i8")
                    .reshape(-1)
                )
                if fld["ts_div"] != 1:
                    ts = ts // fld["ts_div"]
            else:
                ts = _np.full(len(pkts), default_ts, dtype=_np.int64)
            vals = (
                _np.ascontiguousarray(
                    mat[:, fld["offset"] : fld["offset"] + fld["len"]]
                )
                .view(PRIM_NP[ty])
                .reshape(len(pkts), -1)
            )
            store.append_batch(ts, vals)
            m = int(ts[-1])
            max_ts = m if max_ts is None else max(max_ts, m)
            touched.append(cid)
        if touched:
            self.server.notify_table(
                touched, max_ts if max_ts is not None else default_ts
            )
            if self.server.on_external_write is not None:
                self.server.on_external_write(touched)
        if self.server.vtable_stream_subs.get(pkts[0].id):
            for p in pkts:
                self.server.forward_vtable_stream(p, vt)

    # -- message handlers --------------------------------------------------

    async def on_VTableMsg(self, msg: M.VTableMsg, req_id: int) -> None:
        try:
            msg.vtable.validate_alignment()
        except ValueError as e:
            await self.send(M.ErrorResponse(str(e)).packet(req_id))
            return
        self.vtables[msg.id] = msg.vtable
        self.db.vtables[msg.id] = msg.vtable

    async def on_Stream(self, msg: M.Stream, req_id: int) -> None:
        if isinstance(msg.behavior, M.FixedRateBehavior):
            state = {
                "playing": True,
                "timestamp": None,
                "timestep_ns": msg.behavior.timestep,
                "frequency": msg.behavior.frequency,
                "initial": msg.behavior.initial_timestamp,
            }
            self.stream_states[msg.id] = state
            task = asyncio.ensure_future(
                self._replay_loop(msg, state, req_id)
            )
            self.stream_tasks.append(task)
            return
        # one queue per stream: asyncio.Queue delivers each item to exactly
        # one getter, so concurrent stream loops must not share a queue
        queue: asyncio.Queue = asyncio.Queue(maxsize=1024)
        self.server.add_subscriber(queue)
        self.sub_queues.append(queue)
        task = asyncio.ensure_future(self._stream_loop(msg, req_id, queue))
        self.stream_tasks.append(task)

    async def _replay_loop(self, msg: M.Stream, state: dict, req_id: int) -> None:
        """Fixed-rate historical replay with SetStreamState control
        (libs/db/src/vtable_stream.rs fixed-rate path + SetStreamState
        dispatch)."""
        if state["initial"] == "latest":
            with self.db.lock:
                ts = max(
                    (int(s.timestamps[s.len - 1])
                     for s in self.db.components.values() if s.len),
                    default=0,
                )
        elif isinstance(state["initial"], int):
            ts = state["initial"]
        else:
            ts = self.db.earliest_timestamp()
        sent_layout = None
        while True:
            period = 1.0 / max(state["frequency"], 1)
            if not state["playing"]:
                await asyncio.sleep(period)
                continue
            if state["timestamp"] is not None:
                ts = state["timestamp"]
                state["timestamp"] = None  # consume the seek, keep the key
            with self.db.lock:
                rows = []
                for c in self.db.components.values():
                    if c.len == 0:
                        continue
                    idx = int(np.searchsorted(c.timestamps[: c.len], ts, "right")) - 1
                    if idx >= 0:
                        rows.append((c, c.values[idx]))
            if rows:
                layout_key = tuple(c.component_id for c, _ in rows)
                if layout_key != sent_layout:
                    vt_id = bytes([3, msg.id & 0xFF])
                    fields = []
                    offset = 8
                    for c, _ in rows:
                        pad = (-offset) % c.dtype.itemsize
                        offset += pad
                        fields.append(
                            (c.name or f"{c.component_id:016x}", c.prim,
                             c.shape, offset, c.row_nbytes)
                        )
                        offset += c.row_nbytes
                    vt = build_table_vtable(fields, timestamp_offset=0)
                    await self.send(M.VTableMsg(vt_id, vt).packet(req_id))
                    sent_layout = layout_key
                    # loop-local cache: a second replay stream on this
                    # connection must not overwrite our layout
                    replay_vt_id, replay_fields = vt_id, fields
                body = bytearray(np.int64(ts).tobytes())
                for (c, row), f in zip(rows, replay_fields):
                    pad = f[3] - len(body)
                    if pad > 0:
                        body += b"\x00" * pad
                    body += row.tobytes()
                await self.send(
                    M.frame(M.TY_TABLE, replay_vt_id, bytes(body), req_id)
                )
                await self.send(
                    M.StreamTimestamp(ts, msg.id).packet(req_id)
                )
            ts += state["timestep_ns"] // 1000
            await asyncio.sleep(period)

    async def on_SetStreamState(self, msg: M.SetStreamState, req_id: int) -> None:
        state = self.stream_states.get(msg.id)
        if state is None:
            return
        if msg.playing is not None:
            state["playing"] = msg.playing
        if msg.timestamp is not None:
            state["timestamp"] = msg.timestamp
        if msg.time_step_ns is not None:
            state["timestep_ns"] = msg.time_step_ns
        if msg.frequency is not None:
            state["frequency"] = msg.frequency

    async def on_SubscribeLastUpdated(self, msg, req_id: int) -> None:
        self.server.last_updated_subs.append((self, req_id))
        with self.db.lock:
            ts = max(
                (int(s.timestamps[s.len - 1])
                 for s in self.db.components.values() if s.len),
                default=0,
            )
        await self.send(M.LastUpdated(ts).packet(req_id))

    async def on_SetDbConfig(self, msg: M.SetDbConfig, req_id: int) -> None:
        if msg.recording is not None:
            self.db.recording = msg.recording

    async def on_GetDbSettings(self, msg, req_id: int) -> None:
        await self.send(M.DbConfig(self.db.recording).packet(req_id))

    async def on_UdpUnicast(self, msg: M.UdpUnicast, req_id: int) -> None:
        """Mirror the real-time stream to a UDP address
        (libs/db UdpVTableStream / udp mirror)."""
        import socket as _socket

        host, _, port = msg.addr.rpartition(":")
        sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        q: asyncio.Queue = asyncio.Queue(maxsize=256)
        self.server.add_subscriber(q)

        async def pump():
            try:
                while True:
                    component_ids, ts = await q.get()
                    with self.db.lock:
                        rows = [
                            (c, c.latest())
                            for cid in component_ids
                            if (c := self.db.components.get(cid)) and c.len
                        ]
                    for c, (row_ts, row) in rows:
                        body = np.int64(row_ts).tobytes() + row.tobytes()
                        sock.sendto(
                            M.frame(M.TY_TABLE, bytes([4, 0]), body),
                            (host or "127.0.0.1", int(port)),
                        )
            except asyncio.CancelledError:
                self.server.remove_subscriber(q)
                sock.close()
                raise

        self.stream_tasks.append(asyncio.ensure_future(pump()))

    async def _stream_loop(self, msg: M.Stream, req_id: int,
                           queue: asyncio.Queue,
                           initial_sent: dict | None = None,
                           follow_all: bool = False) -> None:
        """Real-time: push EVERY row committed after the subscribe point,
        per component, each packet preceded (once) by that component's
        vtable (libs/db/src/vtable_stream.rs — the reference streams the
        time series, it does not coalesce to latest-value).

        ``initial_sent`` overrides the watermark per component —
        FollowStream passes the exact row counts its history replay
        covered so no commit in between is lost or duplicated."""
        sent_vts: dict[int, bytes] = {}  # cid -> vtable id
        vt_owner: dict[int, int] = {}  # vt low byte -> cid (reuse eviction)
        sent_len: dict[int, int] = dict(initial_sent or {})
        if not follow_all:
            # start from "now": only rows committed after subscribing
            # (FollowStream instead replicates EVERY component from row 0
            # unless its watermark says otherwise — a component created
            # during the history replay must not lose its first rows)
            with self.db.lock:
                for cid, c in self.db.components.items():
                    sent_len.setdefault(cid, c.len)
        while True:
            component_ids, ts = await queue.get()
            # the batch's packets go out in chunks of ~256 KiB, in order: a
            # send a packet released the interpreter lock a row, which on a
            # many-core host hands it to the subscriber's threads every time
            out: list[bytes] = []
            size = 0
            for cid in component_ids:
                if size >= _STREAM_CHUNK:
                    await self.send(b"".join(out))
                    out, size = [], 0
                with self.db.lock:
                    c = self.db.components.get(cid)
                    if c is None:
                        continue
                    start = sent_len.get(cid, 0)
                    n = c.len
                    if n <= start:
                        continue
                    ts_rows = c.timestamps[start:n].copy()
                    val_rows = c.values[start:n].copy()
                    sent_len[cid] = n
                vt_id = sent_vts.get(cid)
                if vt_id is None:
                    self._vt_counter = getattr(self, "_vt_counter", 0) + 1
                    low = self._vt_counter & 0xFF
                    # the wire id space is one byte: when the counter wraps
                    # past 256 live components, evict the previous owner of
                    # this id so its next row re-registers a fresh vtable
                    # instead of the receiver misdecoding it
                    prev = vt_owner.get(low)
                    if prev is not None and prev != cid:
                        sent_vts.pop(prev, None)
                    vt_owner[low] = cid
                    vt_id = bytes([2, low])
                    pad = (-8) % c.dtype.itemsize
                    vt = build_table_vtable(
                        [(c.name or f"{cid:016x}", c.prim, c.shape,
                          8 + pad, c.row_nbytes)],
                        timestamp_offset=0,
                    )
                    pkt = M.VTableMsg(vt_id, vt).packet(req_id)
                    out.append(pkt)
                    size += len(pkt)
                    sent_vts[cid] = vt_id
                pad = (-8) % c.dtype.itemsize
                # every row's packet at once: its header, the i64
                # timestamp, the pad and the row, as M.frame lays one out
                n_rows = len(ts_rows)
                row = np.ascontiguousarray(val_rows).reshape(n_rows, -1).view(np.uint8)
                body_len = 8 + pad + row.shape[1]
                pkts = np.zeros((n_rows, 4 + M.PACKET_HEADER_LEN + body_len), np.uint8)
                pkts[:, :8] = np.frombuffer(
                    (M.PACKET_HEADER_LEN + body_len).to_bytes(4, "little")
                    + bytes([M.TY_TABLE]) + vt_id + bytes([req_id]), np.uint8)
                pkts[:, 8:16] = np.ascontiguousarray(ts_rows, "<i8").view(np.uint8).reshape(
                    n_rows, 8)
                pkts[:, 16 + pad:] = row
                out.append(pkts.tobytes())
                size += pkts.nbytes
            if out:
                await self.send(b"".join(out))

    async def on_GetTimeSeries(self, msg: M.GetTimeSeries, req_id: int) -> None:
        store = self.db.components.get(msg.component_id)
        if store is None:
            await self.send(
                M.ErrorResponse(
                    f"component {msg.component_id:#x} not found"
                ).packet(req_id)
            )
            return
        with self.db.lock:  # _grow() resizes arrays on the writer thread
            ts, values = store.range(msg.start, msg.stop, msg.limit)
            ts, values = np.asarray(ts).copy(), np.asarray(values).copy()
        body = (
            np.uint64(len(ts)).tobytes()
            + np.ascontiguousarray(ts, dtype="<i8").tobytes()
            + np.ascontiguousarray(values, dtype=store.dtype).tobytes()
        )
        await self.send(M.frame(M.TY_TIME_SERIES, msg.id, body, req_id))

    async def on_GetSchema(self, msg: M.GetSchema, req_id: int) -> None:
        store = self.db.components.get(msg.component_id)
        if store is None:
            await self.send(M.ErrorResponse("component not found").packet(req_id))
            return
        await self.send(M.SchemaMsg(store.prim, store.shape).packet(req_id))

    async def on_GetComponentMetadata(self, msg, req_id: int) -> None:
        store = self.db.components.get(msg.component_id)
        if store is None:
            await self.send(M.ErrorResponse("component not found").packet(req_id))
            return
        await self.send(
            M.ComponentMetadata(
                store.component_id, store.name or "", store.metadata
            ).packet(req_id)
        )

    async def on_SetComponentMetadata(self, msg, req_id: int) -> None:
        store = self.db.components.get(msg.component_id)
        if store is not None:
            store.set_metadata(name=msg.name, metadata=msg.metadata)
        else:
            self.server.pending_metadata[msg.component_id] = (
                msg.name,
                dict(msg.metadata),
            )

    async def on_DumpMetadata(self, msg, req_id: int) -> None:
        with self.db.lock:  # get_or_create inserts from other threads
            comps = [
                M.ComponentMetadata(s.component_id, s.name or "", s.metadata)
                for s in self.db.components.values()
            ]
            msg_meta = [
                log.metadata
                for log in self.db.msg_logs.values()
                if isinstance(log.metadata, M.MsgMetadata)
            ]
        await self.send(M.DumpMetadataResp(comps, msg_meta, {}).packet(req_id))

    async def on_DumpSchema(self, msg, req_id: int) -> None:
        with self.db.lock:
            schemas = {
                s.component_id: M.SchemaMsg(s.prim, s.shape)
                for s in self.db.components.values()
            }
        await self.send(M.DumpSchemaResp(schemas).packet(req_id))

    async def on_GetEarliestTimestamp(self, msg, req_id: int) -> None:
        await self.send(
            M.EarliestTimestamp(self.db.earliest_timestamp()).packet(req_id)
        )

    async def on_SetMsgMetadata(self, msg: M.SetMsgMetadata, req_id: int) -> None:
        self.db.msg_log(msg.id).set_metadata(msg.metadata)

    async def on_MsgStream(self, msg: M.MsgStream, req_id: int) -> None:
        self.msg_subs.add(msg.msg_id)
        self.server.msg_subscribers.setdefault(msg.msg_id, []).append(
            (self, req_id)
        )

    async def on_GetMsgs(self, msg: M.GetMsgs, req_id: int) -> None:
        log = self.db.msg_log(msg.msg_id)
        batch = log.range(msg.start, msg.stop, msg.limit)
        await self.send(M.MsgBatch(batch).packet(req_id))

    async def on_SQLQuery(self, msg: M.SQLQuery, req_id: int) -> None:
        try:
            # off the event loop: a full-table query would otherwise stall
            # ingest and every live stream for all connections
            table = await asyncio.to_thread(self.server.sql, msg.query)
            import pyarrow as pa
            import pyarrow.ipc as ipc
            import io

            sink = io.BytesIO()
            with ipc.new_stream(sink, table.schema) as w:
                w.write_table(table)
            await self.send(M.ArrowIPC(sink.getvalue()).packet(req_id))
            await self.send(M.ArrowIPC(None).packet(req_id))
        except Exception as e:  # noqa: BLE001
            await self.send(M.ErrorResponse(str(e)).packet(req_id))

    async def on_StoreAsset(self, msg: M.StoreAsset, req_id: int) -> None:
        self.db.assets.put(msg.key, msg.data)

    async def on_NewConnection(self, msg, req_id: int) -> None:
        pass  # connection hello; no reply (msgs.rs:434)

    async def on_ConnectionSettings(self, msg: M.ConnectionSettings, req_id: int) -> None:
        self.silent = msg.silent

    async def on_GetMsgMetadata(self, msg: M.GetMsgMetadata, req_id: int) -> None:
        log = self.db.msg_logs.get(msg.msg_id)
        meta = getattr(log, "metadata", None) if log is not None else None
        if meta is None:
            await self.send(M.ErrorResponse("msg metadata not found").packet(req_id))
            return
        await self.send(meta.packet(req_id))

    async def on_UdpVTableStream(self, msg: M.UdpVTableStream, req_id: int) -> None:
        """Mirror raw tables of one vtable id to a UDP address
        (msgs.rs:733; udp mirror at libs/db)."""
        import socket as _socket

        host, _, port = msg.addr.rpartition(":")
        sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        dest = (host or "127.0.0.1", int(port))
        conn = self

        class _UdpSink:
            # owner marks the connection so the disconnect cleanup (which
            # filters on the Connection identity) removes this sink and
            # closes its socket instead of leaking both forever
            owner = conn

            async def send(self, data: bytes) -> None:
                sock.sendto(data, dest)

            def close(self) -> None:
                sock.close()

        self.server.vtable_stream_subs.setdefault(msg.id, []).append(
            (_UdpSink(), req_id, {})
        )

    # -- editor-facing stream/query surface --------------------------------

    async def on_VTableStream(self, msg: M.VTableStream, req_id: int) -> None:
        """Forward raw tables tagged with one vtable id as they arrive
        (libs/db/src/lib.rs:2558, vtable_stream.rs).  The vtable itself is
        sent first when known; MeanOp ext ops are applied server-side."""
        vt = self.db.vtables.get(msg.id)
        if vt is not None:
            await self.send(M.VTableMsg(msg.id, vt).packet(req_id))
        self.server.vtable_stream_subs.setdefault(msg.id, []).append(
            (self, req_id, {})
        )

    async def on_SparklineQuery(self, msg: M.SparklineQuery, req_id: int) -> None:
        """LTTB-downsampled series as Arrow IPC (msgs.rs:549-563)."""
        from .downsample import lttb
        from .sql import sanitize_sql_table_name

        store = None
        with self.db.lock:
            for s in self.db.components.values():
                if sanitize_sql_table_name(s.name or "") == msg.table_name:
                    store = s
                    break
        if store is None:
            await self.send(
                M.ErrorResponse(f"table {msg.table_name!r} not found").packet(req_id)
            )
            return
        import io

        import numpy as np
        import pyarrow as pa
        import pyarrow.ipc as ipc

        with self.db.lock:
            n = store.len
            ts = store.timestamps[:n].copy()
            vals = store.values[:n, 0].astype(np.float64)
        idx = lttb(ts.astype(np.float64), vals, msg.max_points)
        table = pa.table(
            {
                "time": pa.array(ts[idx], type=pa.timestamp("us")),
                msg.table_name: pa.array(vals[idx]),
            }
        )
        sink = io.BytesIO()
        with ipc.new_stream(sink, table.schema) as w:
            w.write_table(table)
        await self.send(M.ArrowIPC(sink.getvalue()).packet(req_id))
        await self.send(M.ArrowIPC(None).packet(req_id))

    async def on_PlotOverviewQuery(self, msg: M.PlotOverviewQuery, req_id: int) -> None:
        """Downsampled historical window, replied as a time-series packet
        keyed by msg.id (msgs.rs:565-590)."""
        from .downsample import lttb

        import numpy as np

        store = self.db.components.get(msg.component_id)
        if store is None:
            await self.send(
                M.ErrorResponse(
                    f"component {msg.component_id:#x} not found"
                ).packet(req_id)
            )
            return
        if msg.element_index >= store.elem_count:
            await self.send(
                M.ErrorResponse(
                    "PlotOverviewQuery element_index out of bounds"
                ).packet(req_id)
            )
            return
        with self.db.lock:  # _grow() resizes arrays on the writer thread
            ts, values = store.range(msg.start, msg.stop, None)
            ts, values = np.asarray(ts).copy(), np.asarray(values).copy()
        vals = np.asarray(values)[:, msg.element_index].astype(np.float64)
        idx = lttb(np.asarray(ts, dtype=np.float64), vals, msg.max_points)
        body = (
            np.uint64(len(idx)).tobytes()
            + np.ascontiguousarray(np.asarray(ts)[idx], dtype="<i8").tobytes()
            + np.ascontiguousarray(
                vals[idx], dtype=store.dtype
            ).tobytes()
        )
        await self.send(M.frame(M.TY_TIME_SERIES, msg.id, body, req_id))

    async def on_FixedRateMsgStream(self, msg: M.FixedRateMsgStream, req_id: int) -> None:
        """Fixed-rate replay of a message log (msgs.rs:680-688): each tick
        sends the latest message at-or-before the replay cursor."""
        b = msg.fixed_rate.behavior
        state = {
            "playing": True,
            "timestamp": None,
            "timestep_ns": b.timestep,
            "frequency": b.frequency,
            "initial": b.initial_timestamp,
        }
        self.stream_states[msg.fixed_rate.stream_id] = state
        task = asyncio.ensure_future(
            self._msg_replay_loop(msg.msg_id, state, req_id)
        )
        self.stream_tasks.append(task)

    async def _msg_replay_loop(self, msg_id: bytes, state: dict, req_id: int) -> None:
        log = self.db.msg_log(msg_id)
        if state["initial"] == "latest":
            ts = log.entries[-1][0] if log.entries else 0
        elif isinstance(state["initial"], int):
            ts = state["initial"]
        else:
            ts = log.entries[0][0] if log.entries else 0
        last_sent = None
        while True:
            period = 1.0 / max(state["frequency"], 1)
            if not state["playing"]:
                await asyncio.sleep(period)
                continue
            if state["timestamp"] is not None:
                ts = state["timestamp"]
                state["timestamp"] = None  # consume the seek, keep the key
            row = None
            for t, data in reversed(log.entries):
                if t <= ts:
                    row = (t, data)
                    break
            if row is not None and row != last_sent:
                await self.send(
                    M.frame(M.TY_MSG_WITH_TIMESTAMP, msg_id,
                            int(row[0]).to_bytes(8, "little", signed=True)
                            + row[1], req_id)
                )
                last_sent = row
            ts += state["timestep_ns"] // 1000
            await asyncio.sleep(period)

    async def on_TimestampedMsgStream(self, msg: M.TimestampedMsgStream, req_id: int) -> None:
        """MsgStream variant preserving source timestamps (msgs.rs:786-795);
        subscribers get MsgWithTimestamp packets."""
        self.msg_subs.add(msg.msg_id)
        self.server.msg_subscribers.setdefault(msg.msg_id, []).append(
            (self, req_id)
        )

    async def on_FollowStream(self, msg: M.FollowStream, req_id: int) -> None:
        """Unified replication (msgs.rs:760-775): metadata + schemas +
        component history + message history, then live subscription."""
        # subscribe FIRST: rows committed while the (multi-await) history
        # send runs must land in our queue, or they are only delivered if
        # that component happens to be written again later
        queue: asyncio.Queue = asyncio.Queue(maxsize=4096)
        self.server.add_subscriber(queue)
        self.sub_queues.append(queue)
        # metadata + schemas up front
        for s in list(self.db.components.values()):
            await self.send(
                M.ComponentMetadata(
                    s.component_id, s.name or "", s.metadata
                ).packet(req_id)
            )
        with self.db.lock:
            schemas = {
                s.component_id: M.SchemaMsg(s.prim, s.shape)
                for s in self.db.components.values()
            }
        await self.send(M.DumpSchemaResp(schemas).packet(req_id))
        # historical component rows as one vtable + table per component;
        # record the exact watermark so the live stream resumes where the
        # replay stopped (no loss, no duplication)
        import numpy as np

        watermark: dict[int, int] = {}
        for s in list(self.db.components.values()):
            with self.db.lock:
                n = s.len
                ts = s.timestamps[:n].copy()
                vals = s.values[:n].copy()
            watermark[s.component_id] = n
            if n == 0:
                continue
            vt_id = bytes([5, s.component_id & 0xFF])
            fields = [(s.name or f"{s.component_id:016x}", s.prim, s.shape,
                       8, s.row_nbytes)]
            vt = build_table_vtable(fields, timestamp_offset=0)
            await self.send(M.VTableMsg(vt_id, vt).packet(req_id))
            for i in range(n):
                body = np.int64(ts[i]).tobytes() + vals[i].tobytes()
                await self.send(M.frame(M.TY_TABLE, vt_id, body, req_id))
        # historical messages with timestamps
        for mid, log in list(self.db.msg_logs.items()):
            for t, data in list(log.entries):
                await self.send(
                    M.frame(M.TY_MSG_WITH_TIMESTAMP, mid,
                            int(t).to_bytes(8, "little", signed=True) + data,
                            req_id)
                )
        # live from here on, resuming at the per-component watermark;
        # follow_all=True so components created during the history send
        # replicate from row 0 instead of "now"
        task = asyncio.ensure_future(
            self._stream_loop(
                M.Stream("real-time", id=req_id), req_id, queue,
                initial_sent=watermark, follow_all=True,
            )
        )
        self.stream_tasks.append(task)
        self.server.follow_all_msgs.append((self, req_id))

    async def on_SaveArchive(self, msg: M.SaveArchive, req_id: int) -> None:
        try:
            # disk-heavy: run off the event-loop thread
            await asyncio.to_thread(self.server.save_archive, msg.path, msg.format)
            await self.send(M.ArchiveSaved(msg.path).packet(req_id))
        except Exception as e:  # noqa: BLE001
            await self.send(M.ErrorResponse(str(e)).packet(req_id))


class _UdpIngest(asyncio.DatagramProtocol):
    """Datagram data-plane: each datagram carries one or more
    length-prefixed packets, dispatched like a write-only connection."""

    def __init__(self, server: "Server"):
        self.server = server
        # a synthetic connection shared by all datagram senders: vtable
        # registrations over UDP apply to subsequent UDP tables
        self.conn = Connection(server, None, None)

    def datagram_received(self, data: bytes, addr) -> None:
        pos = 0
        tables: list[M.Packet] = []
        while pos + 4 <= len(data):
            n = int.from_bytes(data[pos : pos + 4], "little")
            frame_body = data[pos + 4 : pos + 4 + n]
            pos += 4 + n
            if len(frame_body) < M.PACKET_HEADER_LEN:
                continue
            try:
                pkt = M.parse_packet(frame_body)
                if pkt.ty == M.TY_TABLE:
                    # batch runs of same-vtable tables like the TCP path
                    if tables and tables[0].id != pkt.id:
                        self.conn.handle_table_batch(tables)
                        tables = []
                    tables.append(pkt)
                    continue
                # non-table packet: flush pending tables FIRST so wire
                # order holds — a VTableMsg re-registering a layout must
                # not apply to tables that preceded it in the datagram
                if tables:
                    self.conn.handle_table_batch(tables)
                    tables = []
                if pkt.ty == M.TY_MSG_WITH_TIMESTAMP:
                    ts = int.from_bytes(pkt.body[:8], "little", signed=True)
                    self.server.db.msg_log(pkt.id).append(ts, pkt.body[8:])
                    self.server.notify_msg(pkt.id, ts, pkt.body[8:])
                elif pkt.ty == M.TY_MSG and pkt.id == M.VTableMsg.ID:
                    vtm = M.VTableMsg.decode(pkt.body)
                    self.conn.vtables[vtm.id] = vtm.vtable
                    self.server.db.vtables[vtm.id] = vtm.vtable
                elif pkt.ty == M.TY_MSG and pkt.id == M.SetComponentMetadata.ID:
                    msg = M.SetComponentMetadata.decode(pkt.body)
                    store = self.server.db.components.get(msg.component_id)
                    if store is not None:
                        store.set_metadata(name=msg.name, metadata=msg.metadata)
                    else:
                        self.server.pending_metadata[msg.component_id] = (
                            msg.name, dict(msg.metadata),
                        )
                elif pkt.ty == M.TY_MSG and pkt.id not in M.MSG_TYPES:
                    # control-plane msgs need the TCP reply path; only user
                    # messages are logged from datagrams
                    ts = now_timestamp_us()
                    self.server.db.msg_log(pkt.id).append(ts, pkt.body)
                    self.server.notify_msg(pkt.id, ts, pkt.body)
            except Exception:
                pass  # malformed datagrams are dropped, never fatal
        if tables:
            try:
                self.conn.handle_table_batch(tables)
            except Exception:
                pass


class Server:
    """TCP server wrapper with its own event-loop thread."""

    def __init__(self, db: Database, addr: str = "127.0.0.1:0"):
        self.db = db
        self.addr = addr
        self.subscribers: list[asyncio.Queue] = []
        self.msg_subscribers: dict[bytes, list] = {}
        self.last_updated_subs: list = []
        self.pending_metadata: dict[int, tuple] = {}
        # VTableStream subscribers: vtable id -> [(conn, req_id, mean_state)]
        self.vtable_stream_subs: dict[bytes, list] = {}
        # FollowStream connections receive every message id
        self.follow_all_msgs: list = []
        # serve_exec hook: wire writes into external_control components
        # re-enter the attached sim (copy_db_to_world)
        self.on_external_write = None
        self.loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server = None
        self.port: int | None = None
        self._started = threading.Event()

    # -- pub/sub ---------------------------------------------------------

    def add_subscriber(self, q: asyncio.Queue) -> None:
        self.subscribers.append(q)

    def remove_subscriber(self, q: asyncio.Queue) -> None:
        if q in self.subscribers:
            self.subscribers.remove(q)

    def notify_table(self, component_ids, ts) -> None:
        # apply deferred metadata
        for cid in component_ids:
            pend = self.pending_metadata.pop(cid, None)
            if pend is not None:
                store = self.db.components.get(cid)
                if store is not None:
                    store.set_metadata(name=pend[0], metadata=pend[1])
        if self.loop is None:
            return
        for q in list(self.subscribers):
            self.loop.call_soon_threadsafe(self._offer, q, (component_ids, ts))
        if self.last_updated_subs:
            pkt_by_req = {}
            for conn, req_id in list(self.last_updated_subs):
                pkt = pkt_by_req.setdefault(
                    req_id, M.LastUpdated(int(ts)).packet(req_id)
                )
                fut = asyncio.run_coroutine_threadsafe(conn.send(pkt), self.loop)
                fut.add_done_callback(lambda f: f.exception())

    @staticmethod
    def _offer(q: asyncio.Queue, item) -> None:
        try:
            q.put_nowait(item)
        except asyncio.QueueFull:
            pass

    def notify_msg(self, msg_id: bytes, ts: int, data: bytes) -> None:
        subs = list(self.msg_subscribers.get(msg_id, ())) + list(
            self.follow_all_msgs
        )
        if not subs or self.loop is None:
            return
        body = np.int64(ts).tobytes() + data
        for conn, req_id in subs:
            pkt = M.frame(M.TY_MSG_WITH_TIMESTAMP, msg_id, body, req_id)
            fut = asyncio.run_coroutine_threadsafe(conn.send(pkt), self.loop)
            fut.add_done_callback(lambda f: f.exception())

    def forward_vtable_stream(self, pkt: M.Packet, vt: VTable) -> None:
        """Fan a raw ingested table out to VTableStream subscribers,
        applying any MeanOp ext stages in the vtable
        (db/src/vtable_stream.rs mean stage)."""
        subs = self.vtable_stream_subs.get(pkt.id)
        if not subs or self.loop is None:
            return
        has_mean = any(
            f.get("mean_window") for f in vt.realize_fields(pkt.body)
        )
        for conn, req_id, mean_state in list(subs):
            body = pkt.body
            if has_mean:
                body = bytearray(body)
                import numpy as _np

                for i, f in enumerate(vt.realize_fields(bytes(body))):
                    win = f.get("mean_window")
                    if not win or f["ty"] is None:
                        continue
                    from .vtable import PRIM_NP

                    dt = PRIM_NP[f["ty"]]
                    vals = _np.frombuffer(f["data"], dtype=dt).astype(
                        _np.float64
                    )
                    hist = mean_state.setdefault(i, [])
                    hist.append(vals)
                    if len(hist) > win:
                        hist.pop(0)
                    mean = _np.mean(hist, axis=0).astype(dt)
                    body[f["offset"] : f["offset"] + f["len"]] = mean.tobytes()
                body = bytes(body)
            out = M.frame(M.TY_TABLE, pkt.id, body, req_id)
            fut = asyncio.run_coroutine_threadsafe(conn.send(out), self.loop)
            fut.add_done_callback(lambda f: f.exception())

    # -- sql / export ------------------------------------------------------

    def sql(self, query: str):
        from .sql import run_sql

        return run_sql(self.db, query)

    def save_archive(self, path: str, fmt: str) -> None:
        from .export import save_archive

        save_archive(self.db, path, fmt)

    # -- lifecycle ---------------------------------------------------------

    async def _bind(self) -> None:
        host, _, port = self.addr.rpartition(":")
        host = host.strip("[]") or "127.0.0.1"
        if host == "::":
            host = None
        self._server = await asyncio.start_server(
            self._on_conn, host, int(port)
        )
        self.port = self._server.sockets[0].getsockname()[1]
        # UDP ingest on the same port (libs/db/src/lib.rs:1649-1699): the
        # data plane (tables, msgs, vtable registrations) accepted over
        # datagrams, fire-and-forget — no reply path
        try:
            loop = asyncio.get_running_loop()
            self._udp_transport, _ = await loop.create_datagram_endpoint(
                lambda: _UdpIngest(self),
                local_addr=(host or "127.0.0.1", self.port),
            )
        except OSError:
            self._udp_transport = None
        self._started.set()

    async def _on_conn(self, reader, writer) -> None:
        conn = Connection(self, reader, writer)
        await conn.run()

    def start(self) -> "Server":
        def run():
            self.loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self.loop)
            try:
                self.loop.run_until_complete(self._bind())
            except Exception:
                self._started.set()
                return
            try:
                self.loop.run_forever()
            finally:
                for task in asyncio.all_tasks(self.loop):
                    task.cancel()
                try:
                    self.loop.run_until_complete(
                        self.loop.shutdown_asyncgens()
                    )
                except Exception:
                    pass
                self.loop.close()

        self._thread = threading.Thread(target=run, daemon=True, name="elodin-db")
        self._thread.start()
        self._started.wait(timeout=10)
        # assets HTTP server at tcp_port + 1 (assets_http.rs assets_http_addr)
        self.assets_http = None
        try:
            from .assets import AssetHttpServer

            if self.port is not None:
                self.assets_http = AssetHttpServer(
                    self.db.assets, port=self.port + 1, db=self.db,
                    ws_tcp_port=self.port,
                )
        except OSError:
            self.assets_http = None
        return self

    def stop(self) -> None:
        if getattr(self, "assets_http", None) is not None:
            self.assets_http.stop()
        if self.loop is not None and self.loop.is_running():
            if self._server is not None:
                self.loop.call_soon_threadsafe(self._server.close)
            if getattr(self, "_udp_transport", None) is not None:
                self.loop.call_soon_threadsafe(self._udp_transport.close)
            self.loop.call_soon_threadsafe(self.loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.db.flush()


def serve_exec(exec_, addr: str = "127.0.0.1:2240", resume: bool = False) -> Server:
    """Attach a DB server to a running Exec: every telemetry batch is
    mirrored into the store off the device loop (mirrors
    commit_world_head_unified, libs/nox-py/src/impeller2_server.rs:390).

    ``exec_`` is the port's ``Exec``: its writer thread makes every
    device-to-host copy and calls the tap with host numpy, the seed below
    copies the columns through ``interop.columns_to_numpy`` (u64 columns
    are int64 on the device), and writes from the server's threads go
    through ``Exec.write_component``, which queues them as host numpy.  No
    code on the server's threads touches a device tensor."""
    if getattr(exec_, "mesh", None) is not None:
        raise NotImplementedError(
            "serve_exec of an Exec on a mesh across processes (ROADMAP.md §3)")
    from ..interop import columns_to_numpy

    db = Database(getattr(exec_, "db_path", None))
    server = Server(db, addr).start()
    meta = exec_.meta

    from .vtable import component_id_of, store_name

    # precompute per-(entity, component) store descriptors; the stores of
    # external_control components take the writes a client sends back
    plan = []
    control = {}
    for comp_name, ids in meta.comp_entities.items():
        comp = meta.components[comp_name]
        external = str(comp.metadata.get("external_control", "")).lower() == "true"
        for i, eid in enumerate(ids):
            qual = store_name(meta, comp_name, eid)
            cid = component_id_of(qual)
            store = db.get_or_create(cid, comp.ty.ty.value, comp.ty.shape, qual)
            store.set_metadata(metadata=comp.metadata)
            plan.append((comp_name, i, cid, store))
            if external:
                control[cid] = (qual, store)

    def commit_batch(ts_us: np.ndarray, stacked: dict) -> None:
        touched = []
        with db.lock:
            for comp_name, row, cid, store in plan:
                col = stacked.get(comp_name)
                if col is None:
                    continue
                store.append_batch(ts_us, col[:, row])
                touched.append(cid)
        server.notify_table(touched, int(ts_us[-1]))

    exec_.on_commit_batch = commit_batch

    if resume:
        # the DB is the checkpoint: copy the latest stored rows back into
        # device state before the first batch (must run before the initial
        # seed below, which would otherwise mask the prior run's tail)
        n = exec_.restore_from_db(db)
        if n:
            print(f"resumed {n} components from {db.path} at tick {exec_.tick()}")

    # reverse path — copy_db_to_world (impeller2_server.rs:320): rows a
    # client writes into an external_control component over the wire
    # (handle_table / UDP ingest; never the sim's own commits) flow back
    # into the device state before the next batch
    if control:

        def on_external_write(component_ids) -> None:
            for cid in component_ids:
                entry = control.get(cid)
                if entry is None:
                    continue
                qual, store = entry
                if store.len:
                    _row_ts, row_vals = store.latest()
                    try:
                        exec_.write_component(qual, row_vals)
                    except Exception as e:  # noqa: BLE001
                        import warnings

                        warnings.warn(
                            f"external control write {qual!r} failed: {e}",
                            stacklevel=1,
                        )

        server.on_external_write = on_external_write
    schematic = getattr(exec_, "schematic_content", None)
    if schematic:
        db.assets.put("schematic.kdl", schematic.encode())
    # seed initial state (init_db, impeller2_server.rs:229)
    if getattr(exec_, "cols", None):
        ts0 = np.asarray([int(
            exec_._history.start_timestamp.timestamp() * 1e6
        )], dtype=np.int64)
        init = {k: v[None] for k, v in columns_to_numpy(exec_.cols, meta).items()}
        commit_batch(ts0, init)
    return server
