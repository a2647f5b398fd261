"""The port's telemetry codec (``elodin_tpu_torch.db``: postcard, vtable,
msgs, framing) against the JAX package's ``elodin_tpu.db``, on the CPU.

* Every message type of ``msgs.MSG_TYPES``, with field values drawn from
  a numpy seed: the port's body and packet bytes are the JAX package's,
  and each package decodes the other's bytes to its own message.
* Postcard varints, zigzags, strings and options byte for byte; a table
  vtable and its realized fields; ``component_id_of`` and ``msg_id`` over
  a few hundred seeded names.
* COBS and the shared-memory ring as ``tests/test_db.py`` tests them, and
  COBS frames across the packages.
"""

import os
import string
import subprocess
import sys

import numpy as np
import pytest

from elodin_tpu.db import framing as jframing
from elodin_tpu.db import msgs as JM
from elodin_tpu.db import postcard as jpc
from elodin_tpu.db import vtable as jvt
from elodin_tpu_torch.db import framing as tframing
from elodin_tpu_torch.db import msgs as TM
from elodin_tpu_torch.db import postcard as tpc
from elodin_tpu_torch.db import vtable as tvt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (JM, jpc, jvt), "torch": (TM, tpc, tvt)}


class _Draw:
    """Seeded field values; two draws from one seed are equal."""

    def __init__(self, seed: int):
        self.r = np.random.default_rng(seed)

    def u(self, bits=40):
        return int(self.r.integers(0, 2**bits, dtype=np.uint64))

    def s(self, bits=40):
        return int(self.r.integers(-(2**bits), 2**bits))

    def opt(self, fn):
        return None if self.r.random() < 0.3 else fn()

    def b(self, n=None):
        n = int(self.r.integers(0, 40)) if n is None else n
        return bytes(self.r.integers(0, 256, n, dtype=np.uint8))

    def text(self):
        n = int(self.r.integers(0, 24))
        chars = string.ascii_letters + string.digits + "._- /é"
        return "".join(chars[i] for i in self.r.integers(0, len(chars), n))

    def bool(self):
        return bool(self.r.integers(0, 2))

    def meta(self):
        return {self.text(): self.text() for _ in range(int(self.r.integers(0, 4)))}

    def pick(self, seq):
        return seq[int(self.r.integers(0, len(seq)))]


def _behavior(M, d):
    return M.FixedRateBehavior(d.pick(["earliest", "latest", d.s()]), d.u(), d.u(16))


def _vtable(vt, d):
    prims = vt.PRIM_TYPES
    fields, offset = [], 8
    for i in range(int(d.r.integers(1, 4))):
        prim = d.pick(prims)
        shape = tuple(int(x) for x in d.r.integers(1, 4, int(d.r.integers(0, 3))))
        size = vt.PRIM_NP[prim].itemsize
        offset += (-offset) % size
        nbytes = size * int(np.prod(shape)) if shape else size
        fields.append((f"e{i}.{d.text()}", prim, shape, offset, nbytes))
        offset += nbytes
    return vt.build_table_vtable(fields, timestamp_offset=d.pick([None, 0]))


# message name -> its seeded instance in one package's modules
MESSAGES = {
    "VTableMsg": lambda M, vt, d: M.VTableMsg(d.b(2), _vtable(vt, d)),
    "Stream": lambda M, vt, d: M.Stream(d.pick(["real-time", _behavior(M, d), "unified"]), d.u()),
    "FixedRateOp": lambda M, vt, d: M.FixedRateOp(d.u(), _behavior(M, d)),
    "SetStreamState": lambda M, vt, d: M.SetStreamState(
        d.u(), d.opt(d.bool), d.opt(d.s), d.opt(d.u), d.opt(d.u)),
    "GetTimeSeries": lambda M, vt, d: M.GetTimeSeries(d.b(2), d.s(), d.s(), d.u(64), d.opt(d.u)),
    "SchemaMsg": lambda M, vt, d: M.SchemaMsg(
        d.pick(vt.PRIM_TYPES), tuple(int(x) for x in d.r.integers(0, 9, int(d.r.integers(0, 4))))),
    "GetSchema": lambda M, vt, d: M.GetSchema(d.u(64)),
    "ComponentMetadata": lambda M, vt, d: M.ComponentMetadata(d.u(64), d.text(), d.meta()),
    "GetComponentMetadata": lambda M, vt, d: M.GetComponentMetadata(d.u(64)),
    "SetComponentMetadata": lambda M, vt, d: M.SetComponentMetadata(d.u(64), d.text(), d.meta()),
    "DumpMetadata": lambda M, vt, d: M.DumpMetadata(),
    "DumpMetadataResp": lambda M, vt, d: M.DumpMetadataResp(
        [M.ComponentMetadata(d.u(64), d.text(), d.meta()) for _ in range(int(d.r.integers(0, 3)))],
        [M.MsgMetadata(d.u(), d.text(), d.meta()) for _ in range(int(d.r.integers(0, 3)))],
        {"recording": d.bool(), "default_stream_time_step": d.u()}),
    "GetEarliestTimestamp": lambda M, vt, d: M.GetEarliestTimestamp(),
    "EarliestTimestamp": lambda M, vt, d: M.EarliestTimestamp(d.u(62)),
    "DumpSchema": lambda M, vt, d: M.DumpSchema(),
    "DumpSchemaResp": lambda M, vt, d: M.DumpSchemaResp(
        {d.u(64): M.SchemaMsg(d.pick(vt.PRIM_TYPES), (d.u(4),)) for _ in range(3)}),
    "StreamTimestamp": lambda M, vt, d: M.StreamTimestamp(d.u(62), d.u()),
    "SQLQuery": lambda M, vt, d: M.SQLQuery(d.text()),
    "ArrowIPC": lambda M, vt, d: M.ArrowIPC(d.opt(d.b)),
    "ErrorResponse": lambda M, vt, d: M.ErrorResponse(d.text()),
    "MsgMetadata": lambda M, vt, d: M.MsgMetadata(d.u(), d.text(), d.meta()),
    "SetMsgMetadata": lambda M, vt, d: M.SetMsgMetadata(
        d.b(2), M.MsgMetadata(d.u(), d.text(), d.meta())),
    "MsgStream": lambda M, vt, d: M.MsgStream(d.b(2)),
    "GetMsgs": lambda M, vt, d: M.GetMsgs(d.b(2), d.s(), d.s(), d.opt(d.u)),
    "MsgBatch": lambda M, vt, d: M.MsgBatch([(d.s(), d.b()) for _ in range(int(d.r.integers(0, 4)))]),
    "SaveArchive": lambda M, vt, d: M.SaveArchive(d.text(), d.pick(["arrow_ipc", "parquet", "csv"])),
    "StoreAsset": lambda M, vt, d: M.StoreAsset(d.text(), d.b()),
    "SubscribeLastUpdated": lambda M, vt, d: M.SubscribeLastUpdated(),
    "LastUpdated": lambda M, vt, d: M.LastUpdated(d.u(62)),
    "SetDbConfig": lambda M, vt, d: M.SetDbConfig(d.opt(d.bool)),
    "GetDbSettings": lambda M, vt, d: M.GetDbSettings(),
    "DbConfig": lambda M, vt, d: M.DbConfig(d.bool(), d.u(), d.meta()),
    "ArchiveSaved": lambda M, vt, d: M.ArchiveSaved(d.text()),
    "UdpUnicast": lambda M, vt, d: M.UdpUnicast(
        M.Stream(d.pick(["real-time", _behavior(M, d)]), d.u()), d.text()),
    "LogEntry": lambda M, vt, d: M.LogEntry(d.u(2), d.text()),
    "VTableStream": lambda M, vt, d: M.VTableStream(d.b(2)),
    "SparklineQuery": lambda M, vt, d: M.SparklineQuery(d.text(), d.u(16)),
    "PlotOverviewQuery": lambda M, vt, d: M.PlotOverviewQuery(
        d.b(2), d.u(64), d.s(), d.s(), d.u(16), d.u(4)),
    "FixedRateMsgStream": lambda M, vt, d: M.FixedRateMsgStream(
        d.b(2), M.FixedRateOp(d.u(), _behavior(M, d))),
    "TimestampedMsgStream": lambda M, vt, d: M.TimestampedMsgStream(d.b(2)),
    "FollowStream": lambda M, vt, d: M.FollowStream(d.u(16)),
    "NewConnection": lambda M, vt, d: M.NewConnection(),
    "ConnectionSettings": lambda M, vt, d: M.ConnectionSettings(d.bool()),
    "GetMsgMetadata": lambda M, vt, d: M.GetMsgMetadata(d.b(2)),
    "UdpVTableStream": lambda M, vt, d: M.UdpVTableStream(d.b(2), d.text()),
    "MeanOp": lambda M, vt, d: M.MeanOp(d.u(16)),
}


def test_every_message_type_is_covered():
    names = sorted(cls.__name__ for cls in JM.MSG_TYPES.values())
    assert names == sorted(cls.__name__ for cls in TM.MSG_TYPES.values())
    assert names == sorted(MESSAGES)
    assert {k: v.__name__ for k, v in JM.MSG_TYPES.items()} == {
        k: v.__name__ for k, v in TM.MSG_TYPES.items()}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_message_bytes_match_and_cross_decode(name, seed):
    made = {k: MESSAGES[name](M, vt, _Draw(seed * 7919 + len(name)))
            for k, (M, _pc, vt) in PACKAGES.items()}
    jmsg, tmsg = made["jax"], made["torch"]
    assert type(jmsg).ID == type(tmsg).ID
    assert tmsg.encode() == jmsg.encode()
    assert tmsg.packet(req_id=seed) == jmsg.packet(req_id=seed)
    assert type(jmsg).decode(tmsg.encode()) == jmsg
    assert type(tmsg).decode(jmsg.encode()) == tmsg
    # a packet (after its 4-byte length) parsed by the other package names
    # the same message
    jpkt = JM.parse_packet(tmsg.packet(3)[JM.PACKET_HEADER_LEN:])
    tpkt = TM.parse_packet(jmsg.packet(3)[TM.PACKET_HEADER_LEN:])
    assert (jpkt.ty, jpkt.id, jpkt.req_id, jpkt.body) == (tpkt.ty, tpkt.id, tpkt.req_id, tpkt.body)
    assert JM.MSG_TYPES[jpkt.id].__name__ == TM.MSG_TYPES[tpkt.id].__name__ == name


@pytest.mark.parametrize("seed", range(3))
def test_postcard_writer_bytes_and_cross_read(seed):
    def write(pc, d):
        w = pc.Writer()
        for _ in range(20):
            w.varint(d.u(63)).zigzag(d.s(62)).string(d.text()).bytes_(d.b())
            w.option(d.opt(d.u), lambda w, v: w.varint(v)).bool(d.bool())
        return w.bytes()

    jb, tb = write(jpc, _Draw(seed)), write(tpc, _Draw(seed))
    assert jb == tb
    d = _Draw(seed)
    jr, tr = jpc.Reader(tb), tpc.Reader(jb)
    for _ in range(20):
        want = (d.u(63), d.s(62), d.text(), d.b())
        assert (jr.varint(), jr.zigzag(), jr.string(), jr.bytes_()) == want
        assert (tr.varint(), tr.zigzag(), tr.string(), tr.bytes_()) == want
        opt, flag = d.opt(d.u), d.bool()
        assert jr.option(lambda r: r.varint()) == opt == tr.option(lambda r: r.varint())
        assert jr.bool() == flag == tr.bool()


@pytest.mark.parametrize("seed", range(3))
def test_table_vtable_bytes_and_realized_fields(seed):
    vts = {k: _vtable(vt, _Draw(seed)) for k, (_M, _pc, vt) in PACKAGES.items()}
    raw = {}
    for k, (_M, pc, _vt) in PACKAGES.items():
        w = pc.Writer()
        vts[k].write(w)
        raw[k] = w.bytes()
    assert raw["jax"] == raw["torch"]
    body = _Draw(seed + 100).b(512)
    jfields = list(jvt.VTable.read(jpc.Reader(raw["torch"])).realize_fields(body))
    tfields = list(tvt.VTable.read(tpc.Reader(raw["jax"])).realize_fields(body))
    assert jfields == tfields and jfields


def test_ids_of_seeded_names():
    d = _Draw(11)
    names = [d.text() + "." + d.text() for _ in range(300)] + ["", "a", "x" * 40]
    for name in names:
        assert tvt.component_id_of(name) == jvt.component_id_of(name)
        assert tpc.msg_id(name) == jpc.msg_id(name)
        assert tpc.msg_id(name)[0] != 224
        assert tpc.auto_msg_id(name) == jpc.auto_msg_id(name)
    assert tvt.component_id_of("") == 0xCBF29CE484222325


@pytest.mark.parametrize("seed", range(3))
def test_cobs_frames_across_packages(seed):
    d = _Draw(seed)
    payloads = [b"", b"\x00", b"\x00" * 300, b"\x01" * 600, bytes(range(256)) * 2] + [
        d.b(int(d.r.integers(0, 700))) for _ in range(20)]
    for p in payloads:
        enc = tframing.cobs_encode(p)
        assert enc == jframing.cobs_encode(p)
        assert b"\x00" not in enc[:-1] and enc[-1] == 0
        assert jframing.cobs_decode(enc) == p == tframing.cobs_decode(enc)
    wire = b"".join(jframing.cobs_encode(p) for p in payloads)
    stream = tframing.CobsStream()
    got = []
    for i in range(0, len(wire), 37):
        got.extend(stream.feed(wire[i:i + 37]))
    assert got == payloads


def test_shm_ring_cross_process(tmp_path):
    """A producer process (the JAX package's ring) pushes, the port's ring
    pops, as ``tests/test_db.py::test_shm_ring_cross_process`` does within
    one package."""
    path = str(tmp_path / "ring.shm")
    ring = tframing.ShmRing(path, capacity=1 << 16)
    code = (f"from elodin_tpu.db.framing import ShmRing\n"
            f"ring = ShmRing({path!r}, capacity=1 << 16, create=False)\n"
            f"for i in range(100):\n"
            f"    assert ring.push(f'frame-{{i}}'.encode())\n"
            f"ring.close()\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=60)
    assert proc.returncode == 0, proc.stderr
    got = []
    while (f := ring.pop()) is not None:
        got.append(f)
    assert got == [f"frame-{i}".encode() for i in range(100)]
    ring.close()


@pytest.mark.parametrize("writer,reader", [(tframing, jframing), (jframing, tframing)])
def test_shm_ring_wraparound_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "r2.shm")
    w = writer.ShmRing(path, capacity=256)
    r = reader.ShmRing(path, capacity=256, create=False)
    payload = b"x" * 40
    for round_ in range(50):
        assert w.push(payload + str(round_ % 10).encode())
        assert r.pop() == payload + str(round_ % 10).encode()
    assert r.pop() is None
    w.close()
    r.close()
