"""The port's editor-side mirror and interleaving checker
(``elodin_tpu_torch.db.mirror``, ``elodin_tpu_torch.testing``), on the CPU,
held to the JAX package's.

* Every case of ``tests/test_interleave.py`` on the port's ``Interleaver``,
  ``explore``, ``ShmRing`` and ``Database``; one seed gives the JAX
  package's schedule, step for step.
* Every case of ``tests/test_mirror.py``.  The cases that need a server run
  three ways: the port's ``MirrorWorld`` on the port's server, the port's
  ``MirrorWorld`` on the JAX package's server, and the JAX package's
  ``MirrorWorld`` on the port's server.  Waits poll what they wait for
  (rows stored, a component listed); none sleeps and hopes.
* The real-time stream a mirror drains: both packages' servers, given the
  same stores and one batch of rows, send a raw subscriber the same bytes
  (the port lays the packets out with numpy and sends them in chunks).
* A served n-body (``build_nbody(8, seed=2)``, the kernel path's plain
  version, f64): a ``MirrorWorld`` of each package subscribes before
  ``Exec.run``; ``value_at`` of every body's ``world_pos`` and
  ``world_vel`` at every stored timestamp is bitwise the ``Exec``'s
  history, rows from the live sink and from backfill alike.

Tolerance: bitwise for every stored row and every schedule.
"""

import socket
import threading
import time

import numpy as np
import pytest

import elodin_tpu.db as jdb
import elodin_tpu_torch.db as tdb
from elodin_tpu.db import mirror as jmirror
from elodin_tpu.testing import Interleaver as JInterleaver
from elodin_tpu_torch.db.mirror import MirrorWorld, SeriesCache, TelemetryCache
from elodin_tpu_torch.db.server import serve_exec
from elodin_tpu_torch.models import nbody as tnb
from elodin_tpu_torch.testing import Interleaver, explore
from elodin_tpu_torch.testing.interleave import InterleaveError
from torch_port_util import float_policy

PKG = {"jax": jdb, "torch": tdb}
MIRROR = {"jax": jmirror.MirrorWorld, "torch": MirrorWorld}
PAIRS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]  # (server, mirror)
WAIT_S = 30.0


def _until(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while True:
        try:
            if cond():
                return
        except RuntimeError:  # a store the server has not made yet
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


@pytest.fixture(params=PAIRS, ids=lambda p: f"{p[0]}-server-{p[1]}-mirror")
def server(request, tmp_path):
    """(server, the mirror's package, its MirrorWorld class)."""
    server_pkg, mirror_pkg = request.param
    srv = PKG[server_pkg].Server.start(str(tmp_path / "db"))
    yield srv, PKG[mirror_pkg], MIRROR[mirror_pkg]
    srv.stop()


# -- the interleaving checker (tests/test_interleave.py) ----------------------


def test_checker_catches_a_lost_update():
    """Sanity: a two-line read-modify-write race across two threads MUST
    lose an update under some schedule — if the checker can't find a
    planted race, its exploration is broken."""
    lost = False
    for seed in range(40):
        state = {"x": 0}

        def inc():
            for _ in range(3):
                t = state["x"]
                state["x"] = t + 1

        Interleaver(inc, inc, seed=seed).run()
        assert 3 <= state["x"] <= 6
        if state["x"] != 6:
            lost = True
            break
    assert lost, "planted race never hit in 40 schedules"


def _make_rmw(state):
    def a():
        for _ in range(4):
            t = state["x"]
            state["x"] = t + 1

    def b():
        for _ in range(4):
            t = state["x"]
            state["x"] = t * 2

    return a, b


def test_same_seed_replays_same_schedule():
    results = []
    schedules = []
    for _ in range(2):
        state = {"x": 1}
        iv = Interleaver(*_make_rmw(state), seed=1234).run()
        results.append(state["x"])
        schedules.append(iv.schedule)
    assert results[0] == results[1]
    assert schedules[0] == schedules[1]


@pytest.mark.parametrize("seed", [0, 1234, 99991])
def test_schedule_is_the_jax_packages(seed):
    """One seed, one schedule, in either package: the same bodies under the
    port's and the JAX package's ``Interleaver`` interleave step for step
    alike and end in the same state."""
    ours, ref = {"x": 1}, {"x": 1}
    iv = Interleaver(*_make_rmw(ours), seed=seed).run()
    jv = JInterleaver(*_make_rmw(ref), seed=seed).run()
    assert iv.schedule == jv.schedule and len(iv.schedule) > 8
    assert ours == ref


def test_worker_exception_propagates():
    def boom():
        raise ValueError("planted")

    with pytest.raises(ValueError, match="planted"):
        Interleaver(boom, seed=0).run()


def test_step_budget_catches_livelock():
    def spin():
        while True:
            pass

    with pytest.raises(InterleaveError, match="budget"):
        Interleaver(spin, seed=0, max_steps=500).run()


def test_blocking_primitive_falls_back():
    """A real lock held across yield points must not deadlock the
    scheduler: the holder is eventually re-granted and releases."""
    lock = threading.Lock()
    order = []

    def a():
        with lock:
            order.append("a-in")
            x = 1 + 1  # a yield point while holding the lock
            order.append(("a-out", x))

    def b():
        with lock:
            order.append("b-in")

    Interleaver(a, b, seed=3, block_timeout=0.02).run()
    assert len(order) == 3


def _ring_frames():
    # sizes chosen to force wraps and skip markers in a 512-byte ring
    return [bytes([i % 251]) * ((i * 37) % 180 + 1) for i in range(24)]


def test_shm_ring_spsc_under_adversarial_schedules(tmp_path):
    """The SPSC ring (``db/framing.py``): producer and consumer on two
    attached instances of the same file must deliver every frame exactly
    once, in order, untorn, under every explored preemption pattern."""
    from elodin_tpu_torch.db.framing import ShmRing

    frames = _ring_frames()
    n_case = [0]

    def make():
        path = str(tmp_path / f"ring{n_case[0]}.shm")
        n_case[0] += 1
        prod = ShmRing(path, capacity=512)
        cons = ShmRing(path, create=False)
        got: list[bytes] = []

        def producer():
            i = 0
            spins = 0
            while i < len(frames):
                if prod.push(frames[i]):
                    i += 1
                else:
                    spins += 1
                    assert spins < 100_000

        def consumer():
            spins = 0
            while len(got) < len(frames):
                f = cons.pop()
                if f is not None:
                    got.append(f)
                else:
                    spins += 1
                    assert spins < 100_000

        def check():
            assert got == frames, (
                f"delivered {len(got)}/{len(frames)}; first divergence at "
                f"{next((k for k, (a, b) in enumerate(zip(got, frames)) if a != b), None)}"
            )
            prod.close()
            cons.close()

        return [producer, consumer], check

    explored = explore(make, seeds=range(25), yield_every=2)
    assert explored == 25


def test_checker_catches_early_publish_ring_bug(tmp_path):
    """Teeth check: a ring that publishes write_pos BEFORE copying the
    payload (the classic SPSC ordering bug) must be caught."""
    import struct

    from elodin_tpu_torch.db.framing import _RING_HEADER, ShmRing

    class EarlyPublishRing(ShmRing):
        def push(self, frame: bytes) -> bool:
            need = 4 + len(frame)
            if need + 4 > self._free():
                return False
            w = self.write_pos
            if w + need > self.capacity:
                if self.capacity - w >= 4:
                    struct.pack_into("<I", self.map, _RING_HEADER + w,
                                     self.SKIP)
                w = 0
                if need + 4 > (self.read_pos - 1) % self.capacity:
                    return False
            struct.pack_into("<I", self.map, _RING_HEADER + w, len(frame))
            self._store(0, (w + need) % self.capacity)  # BUG: early publish
            self.map[_RING_HEADER + w + 4:
                     _RING_HEADER + w + 4 + len(frame)] = frame
            return True

    frames = _ring_frames()
    n_case = [0]

    def make():
        path = str(tmp_path / f"bad{n_case[0]}.shm")
        n_case[0] += 1
        prod = EarlyPublishRing(path, capacity=512)
        cons = ShmRing(path, create=False)
        got: list[bytes] = []

        def producer():
            i = 0
            while i < len(frames):
                if prod.push(frames[i]):
                    i += 1

        def consumer():
            spins = 0
            while len(got) < len(frames) and spins < 100_000:
                f = cons.pop()
                if f is not None:
                    got.append(f)
                else:
                    spins += 1

        def check():
            assert got == frames

        return [producer, consumer], check

    with pytest.raises(AssertionError, match="seed="):
        explore(make, seeds=range(25), yield_every=2)


def test_storage_concurrent_append_and_read(tmp_path):
    """Lock-based Database storage: a writer appending rows races a
    reader calling range(); the reader must always observe a clean prefix
    (monotonic timestamps, untorn rows where every element equals the row
    index)."""
    from elodin_tpu_torch.db.storage import Database
    from elodin_tpu_torch.db.vtable import component_id_of

    n_case = [0]

    def make():
        db = Database(str(tmp_path / f"db{n_case[0]}"))
        n_case[0] += 1
        store = db.get_or_create(component_id_of("t.x"), "f64", (3,), "t.x")
        seen: list = []

        def writer():
            for i in range(6):
                store.append(1_000_000 + i, np.full(3, float(i)))

        def reader():
            for _ in range(6):
                ts, vals = store.range(0, 2**62)
                seen.append((np.asarray(ts).copy(), np.asarray(vals).copy()))

        def check():
            for ts, vals in seen:
                assert list(ts) == sorted(ts)
                for k, row in enumerate(np.asarray(vals)):
                    assert (row == row[0]).all(), "torn row"
                    assert row[0] == float(ts[k] - 1_000_000)

        return [writer, reader], check

    explored = explore(make, seeds=range(8), block_timeout=0.02)
    assert explored == 8


# -- SeriesCache / TelemetryCache (tests/test_mirror.py) -----------------------


def test_series_insert_ordering_and_scrub():
    s = SeriesCache()
    s.insert(30, np.array([3.0]))
    s.insert(10, np.array([1.0]))   # out of order (backfill racing live)
    s.insert(20, np.array([2.0]))
    s.insert(20, np.array([2.5]))   # duplicate ts keeps latest write
    assert len(s) == 3
    assert s.get_at_or_before(9) is None
    ts, v = s.get_at_or_before(25)
    assert ts == 20 and v[0] == 2.5
    ts, v = s.get_at_or_before(10**9)
    assert ts == 30 and v[0] == 3.0
    ts_arr, vals = s.range(10, 20)
    assert list(ts_arr) == [10, 20]
    assert vals.shape == (2, 1)


def test_coverage_merge_and_gaps():
    s = SeriesCache()
    s.mark_covered(0, 10)
    s.mark_covered(20, 30)
    assert s.is_covered(0, 10)
    assert s.is_covered(5, 8)
    assert not s.is_covered(5, 25)
    assert s.uncovered(0, 30) == [(11, 19)]
    # touching intervals merge (11 touches [0,10])
    s.mark_covered(11, 19)
    assert s.is_covered(0, 30)
    assert s.uncovered(0, 40) == [(31, 40)]
    # fully-before and fully-after queries
    assert s.uncovered(50, 60) == [(50, 60)]
    assert not s.is_covered(50, 60)


def test_series_cache_is_the_jax_packages():
    """The same inserts and coverage marks, in the same order, leave both
    packages' caches with the same samples, intervals and answers."""
    rng = np.random.default_rng(7)
    ours, ref = SeriesCache(), jmirror.SeriesCache()
    for _ in range(300):
        ts = int(rng.integers(0, 1000))
        v = rng.standard_normal(3)
        ours.insert(ts, v)
        ref.insert(ts, v.copy())
        lo = int(rng.integers(0, 1000))
        hi = lo + int(rng.integers(0, 40))
        ours.mark_covered(lo, hi)
        ref.mark_covered(lo, hi)
    assert ours._ts == ref._ts and ours._covered == ref._covered
    for a, b in zip(ours._values, ref._values):
        assert np.array_equal(a, b)
    for q in range(0, 1100, 37):
        assert ours.uncovered(q, q + 90) == ref.uncovered(q, q + 90)
        assert ours.is_covered(q, q + 5) == ref.is_covered(q, q + 5)
        a, b = ours.get_at_or_before(q), ref.get_at_or_before(q)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0] == b[0] and np.array_equal(a[1], b[1])


def test_cache_generation_bumps():
    c = TelemetryCache()
    g0 = c.generation
    c.insert("a.x", 1, np.array(1.0))
    assert c.generation == g0 + 1
    c.insert("a.x", 2, np.array(2.0))
    assert c.generation == g0 + 2
    assert c.get_at_or_before("a.x", 5)[1] == 2.0
    assert c.get_at_or_before("b.y", 5) is None


def test_concurrent_insert_and_scrub_stay_consistent():
    """The sink thread and a backfilling caller insert into the SAME
    SeriesCache concurrently (the documented contract): under the per-
    series lock, timestamps stay sorted and paired with their values."""
    s = SeriesCache()
    N = 4000

    def live():  # ascending inserts (the sink)
        for i in range(0, N, 2):
            s.insert(i, np.asarray([float(i)]))

    def backfill():  # out-of-order inserts (history fetch)
        for i in range(N - 1, 0, -2):
            s.insert(i, np.asarray([float(i)]))

    ts = [threading.Thread(target=live), threading.Thread(target=backfill)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(s) == N
    assert s._ts == sorted(s._ts)
    for k in (0, 1, N // 2, N - 1):
        got = s.get_at_or_before(k)
        assert got is not None and got[0] == k and float(got[1][0]) == float(k)


# -- live sync against a server -----------------------------------------------


def test_mirror_live_sink_and_entity_tree(server):
    srv, pkg, Mirror = server
    writer_client = pkg.Client.connect(srv.addr)
    writer = writer_client.table_writer(
        {"ball.world_pos": pkg.f64[3], "ball.mass": pkg.f64}
    )
    writer.write(timestamp_us=1_000, values={
        "ball.world_pos": [0.0, 0.0, 1.0], "ball.mass": 2.0})
    _until(lambda: {"ball.world_pos", "ball.mass"} <= set(writer_client.components()),
           "the first row's components")

    with Mirror.connect(srv.addr) as m:
        writer.write(timestamp_us=2_000, values={
            "ball.world_pos": [0.0, 0.0, 2.0], "ball.mass": 2.0})
        assert m.wait_for("ball.world_pos")
        ts, pos = m.latest("ball.world_pos")
        np.testing.assert_array_equal(np.ravel(pos), [0.0, 0.0, 2.0])
        ents = m.entities()
        assert "ball" in ents
        assert set(ents["ball"]) >= {"world_pos", "mass"}
    writer.close()
    writer_client.close()


def test_mirror_backfill_cold_history(server):
    srv, pkg, Mirror = server
    writer_client = pkg.Client.connect(srv.addr)
    writer = writer_client.table_writer({"craft.alt": pkg.f64})
    t0 = 5_000_000
    for i in range(20):
        writer.write(timestamp_us=t0 + i * 1_000, values={"craft.alt": float(i)})
    _until(lambda: len(writer_client.time_series("craft.alt")[0]) == 20, "20 stored rows")

    # connect AFTER the data landed: the live stream never saw it, so a
    # timeline scrub must backfill from the DB's time-series store
    with Mirror.connect(srv.addr) as m:
        v = m.value_at("craft.alt", t0 + 10_500, backfill_window_us=50_000)
        assert v is not None and float(np.ravel(v)[0]) == 10.0
        # the fetched range is now covered: scrubbing again is cache-only
        s = m.cache.series("craft.alt")
        assert s.is_covered(t0, t0 + 10_500)
        v2 = m.value_at("craft.alt", t0 + 3_000)
        assert float(np.ravel(v2)[0]) == 3.0
    writer.close()
    writer_client.close()


def test_mirror_edit_writes_back(server):
    srv, pkg, Mirror = server
    with Mirror.connect(srv.addr) as m:
        m.set("cfg.gain", [1.5, 2.5], timestamp_us=1_000)
        reader = pkg.Client.connect(srv.addr)
        _until(lambda: len(reader.time_series("cfg.gain", 0, 10_000)[0]) == 1,
               "the edit stored")
        ts, vals = reader.time_series("cfg.gain", 0, 10_000)
        assert len(ts) == 1
        np.testing.assert_array_equal(vals[0], [1.5, 2.5])
        reader.close()


def test_mirror_on_update_callback(server):
    srv, pkg, Mirror = server
    writer_client = pkg.Client.connect(srv.addr)
    writer = writer_client.table_writer({"imu.gyro": pkg.f64[3]})
    seen = []
    with Mirror.connect(srv.addr) as m:
        m.on_update(lambda name, ts, v: seen.append((name, ts)))
        writer.write(timestamp_us=42, values={"imu.gyro": [0.1, 0.2, 0.3]})
        assert m.wait_for("imu.gyro")
    assert any(name == "imu.gyro" for name, _ in seen)
    writer.close()
    writer_client.close()


def test_query_miss_creates_no_phantom_series(server):
    """Probing a nonexistent name (typo) through latest/value_at/wait_for
    must not pollute the mirror's component set with empty series."""
    srv, _pkg, Mirror = server
    with Mirror.connect(srv.addr) as m:
        assert m.latest("ball.world_poss") is None
        assert m.value_at("ball.world_poss", 10_000_000) is None
        assert not m.wait_for("ball.world_poss", timeout=0.05)
        assert "ball.world_poss" not in m.cache.component_names()


def test_live_contiguous_coverage_stays_compact(server):
    """The real-time stream delivers every ingested row, so the sink grows
    ONE coverage interval per component instead of one per sample."""
    srv, pkg, Mirror = server
    writer = pkg.Client.connect(srv.addr)
    spec = pkg.f64[1].labeled("v")
    with Mirror.connect(srv.addr) as m:
        with writer.table_writer({"craft.x": spec}) as w:
            for i in range(50):
                w.write(1_000_000 + i * 10_000, {"craft.x": np.asarray([float(i)])})
        _until(lambda: m.cache.peek("craft.x") is not None
               and len(m.cache.peek("craft.x")) >= 50, "50 live rows")
        s = m.cache.peek("craft.x")
        assert len(s._covered) <= 3, s._covered[:5]
    writer.close()


# -- a served n-body, mirrored --------------------------------------------------


@pytest.mark.parametrize("mirror_pkg", ["torch", "jax"])
def test_served_nbody_mirrored_bitwise(tmp_path, mirror_pkg):
    """The CPU rehearsal of ``chip_smoke.py`` phase 40 (a): a mirror
    subscribes to every body's ``world_pos`` and ``world_vel`` of a served
    n-body between two runs; after a flush its ``value_at`` at every stored
    timestamp is bitwise the ``Exec``'s history (the first run's rows by
    backfill, the second's by the live sink)."""
    n, first, ticks = 8, 5, 20
    with float_policy("f64"):
        exec_ = tnb.build_nbody(n, seed=2).build(
            tnb.build_system(60.0, use_kernel=True), simulation_rate=60.0,
            db_path=str(tmp_path / "db"), device="cpu")
        srv = serve_exec(exec_, "127.0.0.1:0")
        try:
            exec_.run(first)
            exec_.flush_telemetry()
            names = [q for q in exec_._history.column_names()
                     if q.endswith((".world_pos", ".world_vel"))]
            assert len(names) == 2 * n
            live = {}

            def count(name, _ts, _v):
                live[name] = live.get(name, 0) + 1

            with MIRROR[mirror_pkg].connect(f"127.0.0.1:{srv.port}", names) as m:
                m.on_update(count)
                exec_.run(ticks)
                exec_.flush_telemetry()
                start = exec_._history.start_timestamp.timestamp()
                times = np.asarray(exec_._history.times)
                want_ts = np.concatenate([[int(start * 1e6)],
                                          ((start + times[1:]) * 1e6).astype(np.int64)])
                assert len(want_ts) == first + ticks + 1
                _until(lambda: all(live.get(q, 0) >= ticks for q in names), "the live rows")
                for q in names:
                    comp, row = exec_._history.resolve(q)
                    hist = exec_._history.series(comp)[:, row]
                    backfilled = m.backfill(q, int(want_ts[0]), int(want_ts[-1]))
                    assert backfilled == first + 1, (q, backfilled)
                    for k, t in enumerate(want_ts):
                        v = m.value_at(q, int(t))
                        assert v is not None and np.array_equal(np.ravel(v), hist[k]), (q, k)
                    assert m.cache.peek(q).latest()[0] == want_ts[-1]
        finally:
            srv.stop()
            exec_.on_commit_batch = None


def _packets(buf):
    """The number of whole packets at the head of ``buf`` and their bytes."""
    pos = count = 0
    while len(buf) - pos >= 4:
        n = int.from_bytes(buf[pos:pos + 4], "little")
        if len(buf) - pos - 4 < n:
            break
        pos += 4 + n
        count += 1
    return count, pos


def _stream_bytes(pkg, path, stores, rows):
    """The raw bytes a real-time subscriber of ``pkg``'s server receives
    for one batch: every store's rows appended, then one notify.  A
    sentinel store's rows, notified until one arrives, show the
    subscription live first; its packets are left out."""
    from elodin_tpu_torch.db.vtable import PRIM_NP, component_id_of

    srv = PKG[pkg].Server.start(path)
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=WAIT_S)
    try:
        made = [(component_id_of(name), srv.db.get_or_create(
            component_id_of(name), prim, shape, name)) for name, prim, shape in stores]
        warm_id = component_id_of("warm.x")
        warm = srv.db.get_or_create(warm_id, "f64", (), "warm.x")
        sock.sendall(tdb.msgs.Stream("real-time", id=9).packet(9))
        buf = bytearray()
        sock.settimeout(0.1)
        deadline = time.monotonic() + WAIT_S
        while not _packets(buf)[0]:
            assert time.monotonic() < deadline, "the subscription never went live"
            warm.append_batch(np.array([warm.len], np.int64), np.zeros(1))
            srv._server.notify_table([warm_id], warm.len)
            try:
                buf += sock.recv(1 << 16)
            except TimeoutError:
                pass
        sock.settimeout(0.2)  # the sentinel's last packets: until 0.2 s pass quiet
        try:
            while True:
                buf += sock.recv(1 << 16)
        except TimeoutError:
            pass
        sock.settimeout(WAIT_S)
        skip = _packets(buf)[1]
        del buf[:skip]
        ts = np.arange(rows, dtype=np.int64) * 16_667 + 1_000_000
        rng = np.random.default_rng(3)
        for (cid, store), (_name, prim, shape) in zip(made, stores):
            store.append_batch(ts, (rng.standard_normal((rows, *shape)) * 1e3).astype(PRIM_NP[prim]))
        srv._server.notify_table([cid for cid, _ in made], int(ts[-1]))
        want = len(stores) * (1 + rows)  # a vtable and the rows, a store
        while _packets(buf)[0] < want:
            buf += sock.recv(1 << 16)
        return bytes(buf[:_packets(buf)[1]])
    finally:
        sock.close()
        srv.stop()


def test_real_time_stream_bytes_are_the_jax_servers(tmp_path):
    stores = [(f"b{i}.world_pos", "f64", (7,)) for i in range(5)] + [
        ("Globals.tick", "u64", ()), ("b0.mass", "f32", ())]
    ours = _stream_bytes("torch", str(tmp_path / "ours"), stores, 40)
    ref = _stream_bytes("jax", str(tmp_path / "ref"), stores, 40)
    assert len(ours) > 40 * 7 * 8 * 5
    assert ours == ref
