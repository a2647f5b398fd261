"""The port's MCAP and MP4 export (``elodin_tpu_torch.db.export_mcap``,
``video``, ``db export --format mcap`` and ``db export-videos``), on the
CPU, held to the JAX package's.

* Every case of ``tests/test_mcap_export.py`` on the port (the reference's
  integration suite, libs/db/tests_query/mcap_export.rs: a small database
  of a pose, scalars, vectors, a message log, a schematic and a GLB asset,
  exported and read back).
* The same database exported by both packages, with each option set:
  the MCAP file and the Foxglove layout are byte for byte the same.  The
  writers stamp no wall time and no random id (every log time is a
  stored row's timestamp), so no field is excepted.
* The same H.264 access units muxed by both packages' ``Mp4Writer``, and
  ``db export-videos`` of the video-stream example's frames in both
  packages: the MP4s are byte for byte the same, one sample a frame.
* A served n-body's database through ``db export --format mcap`` in
  process: one message a stored row of each exported component, its
  values equal to the store's.

Tolerance: bitwise (byte for byte) in every cross-package case.
"""

import json
import math
import os
import struct

import numpy as np
import pytest

from elodin_tpu.db import export_mcap as jexport
from elodin_tpu.db import video as jvideo
from elodin_tpu.db.storage import Database as JDatabase
from elodin_tpu_torch.db import msgs as M
from elodin_tpu_torch.db import video
from elodin_tpu_torch.db.export_mcap import export_mcap, read_mcap_full
from elodin_tpu_torch.db.storage import Database
from elodin_tpu_torch.db.vtable import component_id_of

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TS_BASE = 1_700_000_000_000_000  # µs epoch
TS_STEP = 10_000  # 100 Hz
NUM_ROWS = 25

SCHEMATIC = """tabs {
    hsplit name=Viewport {
        viewport name=Viewport pos="drone.world_pos + (0,0,0,0, 2,2,2)" look_at=drone.world_pos show_grid=#true active=#true
        vsplit share=0.4 {
            graph drone.gyro name=Gyro
            graph "drone.world_pos.q0, drone.thrust"
        }
    }
    vsplit name="Monitors" {
        component_monitor component_name=drone.gyro
    }
}
vector_arrow "(1, 0, 0)" origin=drone.world_pos name="Drone X" body_frame=#true {
    color white
}
vector_arrow "drone.world_vel[3],drone.world_vel[4],drone.world_vel[5]" origin=drone.world_pos scale=1.0 name="Velocity" {
    color white
}
object_3d drone.world_pos {
    glb path=db:drone.glb
}"""


def _glb_bytes() -> bytes:
    # tiny valid-enough GLB payload (magic + version + length header only)
    return b"glTF" + struct.pack("<II", 2, 12)


def _spec_components(db: Database):
    specs = [
        ("drone.world_pos", "f64", (7,), "q0,q1,q2,q3,x,y,z"),
        ("drone.world_vel", "f64", (6,), "wx,wy,wz,vx,vy,vz"),
        ("drone.gyro", "f64", (3,), "x,y,z"),
        ("drone.thrust", "f64", (), None),
        ("Globals.tick", "u64", (), None),
    ]
    out = {}
    for name, prim, shape, element_names in specs:
        store = db.get_or_create(component_id_of(name), prim, shape, name)
        if element_names:
            store.set_metadata(metadata={"element_names": element_names})
        out[name] = store
    return out


def build_fixture(path) -> Database:
    db = Database(str(path))
    stores = _spec_components(db)
    for step in range(NUM_ROWS):
        ts = TS_BASE + TS_STEP * step
        t = float(step)
        stores["drone.world_pos"].append(
            ts, np.array([0.0, 0.0, 0.0, 1.0, t * 0.1, t * 0.2, 2.0])
        )
        # angular part deliberately huge: if the exporter reads elements
        # 0..3 instead of [3],[4],[5], the arrow length blows up
        stores["drone.world_vel"].append(
            ts, np.array([9.0, 9.0, 9.0, 2.0, 0.0, 0.0])
        )
        stores["drone.gyro"].append(ts, np.array([t, -t, 0.5 * t]))
        stores["drone.thrust"].append(ts, np.array([t * 0.25]))
        stores["Globals.tick"].append(
            ts, np.array([step], dtype=np.uint64)
        )

    log = db.msg_log(b"\x10\x20")
    log.set_metadata(M.MsgMetadata(
        msg_id=0x2010, name="fsw.log", metadata={"schema": "LogEntry"},
    ))
    for step in range(3):
        log.append(
            TS_BASE + TS_STEP * step,
            json.dumps({"level": 2, "message": f"log line {step}"}).encode(),
        )

    db.assets.put("drone.glb", _glb_bytes())
    db.assets.put("schematics/main.kdl", SCHEMATIC.encode())
    db.set_active_schematic("schematics/main.kdl")
    db.flush()
    return db


def _export(db, tmp_path, **opts):
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    mcap_path = out / "db.mcap"
    export_mcap(db, str(mcap_path), **opts)
    return mcap_path, out / "db.foxglove-layout.json"


def test_mcap_export_roundtrip(tmp_path):
    db = build_fixture(tmp_path / "db")
    mcap_path, layout_path = _export(db, tmp_path)
    f = read_mcap_full(str(mcap_path))

    # --- channels --------------------------------------------------------
    topics = {c["topic"] for c in f.channels.values()}
    for expected in [
        "/drone/world_pos", "/drone/gyro", "/drone/thrust", "/Globals/tick",
        "/tf", "/scene/drone-model", "/scene/drone-arrows",
        "/scene_dynamic/Velocity", "/log/fsw.log",
    ]:
        assert expected in topics, f"missing topic {expected}: {topics}"

    by_topic = {c["topic"]: (cid, c) for cid, c in f.channels.items()}
    tf_channel = by_topic["/tf"][1]
    assert tf_channel["schema"]["name"] == "foxglove.FrameTransforms"
    assert tf_channel["encoding"] == "json"

    # SceneUpdate must carry the FULL official foxglove schema: Foxglove only
    # base64-decodes bytes fields the schema declares with contentEncoding
    scene_channel = by_topic["/scene/drone-model"][1]
    scene_schema = json.loads(scene_channel["schema"]["data"])
    assert (
        scene_schema["properties"]["entities"]["items"]["properties"]
        ["models"]["items"]["properties"]["data"]["contentEncoding"]
        == "base64"
    )
    assert by_topic["/log/fsw.log"][1]["schema"]["name"] == "foxglove.Log"

    # --- messages: counts, monotonic log_time, JSON content --------------
    counts: dict[str, int] = {}
    last_log_time = 0
    first: dict[str, dict] = {}
    for cid, log_time, data in f.messages:
        topic = f.channels[cid]["topic"]
        assert log_time >= last_log_time, f"log_time went backwards on {topic}"
        last_log_time = log_time
        counts[topic] = counts.get(topic, 0) + 1
        if topic not in first:
            first[topic] = json.loads(data)
    assert counts["/drone/world_pos"] == NUM_ROWS
    assert counts["/tf"] == NUM_ROWS
    assert counts["/drone/thrust"] == NUM_ROWS
    assert counts["/log/fsw.log"] == 3
    # per-entity scene topics: exactly one message each
    assert counts["/scene/drone-model"] == 1
    assert counts["/scene/drone-arrows"] == 1

    world_pos = first["/drone/world_pos"]
    assert world_pos["q3"] == 1.0 and world_pos["z"] == 2.0
    tf = first["/tf"]["transforms"][0]
    assert tf["child_frame_id"] == "drone"
    assert tf["translation"]["z"] == 2.0
    assert tf["rotation"]["w"] == 1.0

    # foxglove.Log requires file/line alongside timestamp/level/message/name
    log = first["/log/fsw.log"]
    assert log["message"] == "log line 0"
    assert log["file"] == "" and log["line"] == 0

    # scene entities carry every schema-required primitive array
    scene_entity = first["/scene/drone-model"]["entities"][0]
    for key in ("metadata", "arrows", "cubes", "spheres", "cylinders",
                "lines", "triangles", "texts", "models"):
        assert isinstance(scene_entity[key], list), f"missing array {key}"
    model = scene_entity["models"][0]
    import base64 as b64
    assert b64.b64decode(model["data"]) == _glb_bytes()

    # the dynamic arrow reads the schematic's [3],[4],[5] elements (linear
    # velocity (2,0,0)), not 0..3 (angular, (9,9,9)); world-frame arrows use
    # frame_id=world with absolute origin so attitude can't rotate them
    arrow_entity = first["/scene_dynamic/Velocity"]["entities"][0]
    assert arrow_entity["frame_id"] == "world"
    arrow = arrow_entity["arrows"][0]
    assert arrow["pose"]["position"]["z"] == 2.0
    assert abs(arrow["shaft_length"] - 2.0 * 0.8) < 1e-9, (
        "shaft_length should come from |(2,0,0)| * scale 1.0 * 0.8"
    )
    # direction +X -> identity quaternion
    assert abs(arrow["pose"]["orientation"]["w"] - 1.0) < 1e-9

    # the body-frame arrow rides the drone TF at the entity origin
    body_arrow = first["/scene/drone-arrows"]["entities"][0]
    assert body_arrow["frame_id"] == "drone"
    assert body_arrow["arrows"][0]["pose"]["position"]["x"] == 0.0

    # --- attachments: schematic + referenced GLB -------------------------
    attachment_names = [a["name"] for a in f.attachments]
    assert "schematics/main.kdl" in attachment_names
    assert "drone.glb" in attachment_names
    index_names = [a["name"] for a in f.attachment_indexes]
    assert "schematics/main.kdl" in index_names
    assert "drone.glb" in index_names

    # --- metadata records ------------------------------------------------
    metadata_names = [m["name"] for m in f.metadata]
    assert "elodin.db_state" in metadata_names
    assert "elodin.components" in metadata_names
    assert [m["name"] for m in f.metadata_indexes] == metadata_names

    # --- statistics (summary section) ------------------------------------
    assert f.statistics is not None
    assert f.statistics["message_count"] == len(f.messages)
    assert f.statistics["attachment_count"] == len(f.attachments)

    # --- layout ----------------------------------------------------------
    layout = json.loads(layout_path.read_text())
    config_by_id = layout["configById"]
    root = layout["layout"]
    assert root.startswith("Tab!")
    tabs = config_by_id[root]["tabs"]
    assert [t["title"] for t in tabs] == ["Viewport", "Monitors"]

    # a 3D panel following the drone, with every scene topic enabled
    three_d = next(v for v in config_by_id.values() if "followTf" in v)
    assert three_d["followTf"] == "drone"
    assert three_d["topics"]["/scene/drone-model"]["visible"] is True
    assert three_d["topics"]["/scene/drone-arrows"]["visible"] is True
    # camera from the viewport pos offset (2,2,2), in DEGREES — Foxglove's
    # 3D panel reads phi/thetaOffset/fovy as degrees
    camera = three_d["cameraState"]
    assert abs(camera["distance"] - math.sqrt(12.0)) < 1e-6
    assert abs(camera["phi"] - 54.7356) < 1e-3
    assert abs(camera["thetaOffset"] - 45.0) < 1e-6
    assert camera["fovy"] == 45.0

    # plot series resolved from EQL, including explicit element access
    plots = [v for v in config_by_id.values() if "paths" in v]
    assert len(plots) == 2
    all_paths = [
        s["value"] for p in plots for s in p["paths"]
    ]
    assert "/drone/gyro.x" in all_paths
    assert "/drone/world_pos.q0" in all_paths
    assert "/drone/thrust.value" in all_paths

    # raw messages panel on the monitored component
    raw = next(v for v in config_by_id.values() if "topicPath" in v)
    assert raw["topicPath"] == "/drone/gyro"


def test_mcap_export_pattern_filters_components(tmp_path):
    db = build_fixture(tmp_path / "db")
    # uppercase on purpose: matching is case-insensitive
    mcap_path, _ = _export(db, tmp_path, pattern="Drone.*")
    f = read_mcap_full(str(mcap_path))
    topics = [c["topic"] for c in f.channels.values()]
    assert "/drone/gyro" in topics
    assert "/Globals/tick" not in topics


def _alt_only_db(path, timestamps):
    db = Database(str(path))
    store = db.get_or_create(component_id_of("sat.alt"), "f64", (), "sat.alt")
    for i, ts in enumerate(timestamps):
        store.append(ts, np.array([float(i) * 100.0]))
    db.flush()
    return db


def test_mcap_export_epoch_offset_auto(tmp_path):
    db = _alt_only_db(
        tmp_path / "db", [-100_000 + i * 10_000 for i in range(10)]
    )
    mcap_path, _ = _export(db, tmp_path)
    f = read_mcap_full(str(mcap_path))
    assert min(t for _, t, _ in f.messages) == 0, (
        "auto-rebased earliest should be 0 ns"
    )
    assert any(m["name"] == "elodin.db_state" for m in f.metadata)


def test_mcap_export_epoch_offset_zero_still_rebases_pre1970(tmp_path):
    # explicit --epoch-offset-us 0 must not clamp every pre-1970 sample to
    # log_time 0 (destroying playback ordering for Apollo-style DBs)
    db = _alt_only_db(
        tmp_path / "db", [-100_000 + i * 10_000 for i in range(5)]
    )
    mcap_path, _ = _export(db, tmp_path, epoch_offset_us=0)
    f = read_mcap_full(str(mcap_path))
    by_topic = {c["topic"]: cid for cid, c in f.channels.items()}
    log_times = [
        t for cid, t, _ in f.messages if cid == by_topic["/sat/alt"]
    ]
    assert len(log_times) == 5
    assert log_times[0] == 0, "earliest should rebase to 0"
    for a, b in zip(log_times, log_times[1:]):
        assert b > a, f"log_time must stay strictly increasing: {log_times}"
    assert log_times[1] - log_times[0] == 10_000 * 1000


def test_mcap_export_epoch_offset_manual(tmp_path):
    db = _alt_only_db(tmp_path / "db", [1000 + i * 1000 for i in range(5)])
    manual = 500_000
    mcap_path, _ = _export(db, tmp_path, epoch_offset_us=manual)
    f = read_mcap_full(str(mcap_path))
    assert f.messages[0][1] == (1000 + manual) * 1000
    # the offset is recorded in the db_state metadata for provenance
    db_state = next(
        m for m in f.metadata if m["name"] == "elodin.db_state"
    )
    assert db_state["metadata"]["elodin.time_offset_us"] == str(manual)


def test_mcap_export_oversized_glb_attached_not_embedded(tmp_path):
    """A GLB over the embed limit is attached to the MCAP but omitted from
    SceneUpdate entirely — no empty-data model primitive
    (export_mcap.rs:3414 oversized_glb_omits_model_not_empty_data)."""
    db = build_fixture(tmp_path / "db")
    # make the mesh entity NOT the follow target by removing its follow
    # force: shrink the embed cap below the GLB size on a non-followed obj
    db.assets.put("big.glb", b"glTF" + struct.pack("<II", 2, 12) + b"x" * 64)
    sch = SCHEMATIC + '\nobject_3d "(0,0,0,1, 5,5,5)" {\n    glb path=db:big.glb\n}'
    db.assets.put("schematics/main.kdl", sch.encode())
    mcap_path, _ = _export(db, tmp_path, max_embed_mb=0)
    f = read_mcap_full(str(mcap_path))
    # drone-model still embedded (follow entity forces embed)
    topics = [c["topic"] for c in f.channels.values()]
    assert "/scene/drone-model" in topics
    # the literal-pose model is attached but not in the scene
    assert "big.glb" in [a["name"] for a in f.attachments]
    assert not any("literal" in t for t in topics)


def test_mcap_cli_export(tmp_path):
    """`python -m elodin_tpu_torch db export --format mcap` writes
    <dbname>.mcap + layout."""
    import subprocess
    import sys

    build_fixture(tmp_path / "mydb")
    out = tmp_path / "exported"
    r = subprocess.run(
        [sys.executable, "-m", "elodin_tpu_torch", "db", "export",
         str(tmp_path / "mydb"), "--output", str(out), "--format", "mcap"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr
    assert (out / "mydb.mcap").is_file()
    assert (out / "mydb.foxglove-layout.json").is_file()
    f = read_mcap_full(str(out / "mydb.mcap"))
    assert len(f.messages) > 0


def test_mcap_export_leaf_nested_name_collision(tmp_path):
    """element_names mixing a leaf and a nested path under the same key
    ("q,q.w") must not abort the export (regression: KeyError in
    _component_json_schema)."""
    db = build_fixture(tmp_path / "db")
    store = db.get_or_create(
        component_id_of("drone.weird"), "f64", (2,), "drone.weird"
    )
    store.set_metadata(metadata={"element_names": "q,q.w"})
    store.append(TS_BASE, np.array([1.0, 2.0]))
    db.flush()
    mcap_path, _ = _export(db, tmp_path)
    f = read_mcap_full(str(mcap_path))
    assert any(c["topic"].endswith("drone/weird")
               for c in f.channels.values())


def test_config_json_non_dict_tolerated(tmp_path):
    """A config.json holding valid-but-non-dict JSON must not brick
    Database open (regression: AttributeError on cfg.get)."""
    p = tmp_path / "db"
    build_fixture(p)
    (p / "config.json").write_text("null")
    db2 = Database(str(p))
    assert db2.active_schematic is None


def test_schematic_frame_props_accepted():
    """viewport frame= and line_3d frame= are part of the vocabulary the
    exporter consumes; the typed layer must accept them at load time."""
    from elodin_tpu_torch import schematic as S

    sch = S.load(
        'tabs {\n viewport name=V frame=NED\n}\n'
        'line_3d drone.world_pos frame=ENU color=red'
    )
    assert sch.lines[0].props.get("frame") == "ENU"


def test_mcap_duplicate_line_topics_across_window_schematics(tmp_path):
    """The same line entity in the primary AND a window schematic must get
    distinct /scene topics (the uniquifier counts across schematics)."""
    db = build_fixture(tmp_path / "db")
    db.assets.put(
        "schematics/main.kdl",
        (SCHEMATIC
         + '\nline_3d drone.world_pos color=red'
         + '\nwindow path="schematics/win.kdl"').encode(),
    )
    db.assets.put(
        "schematics/win.kdl",
        b'tabs {\n viewport name=W\n}\nline_3d drone.world_pos color=blue',
    )
    mcap_path, _ = _export(db, tmp_path)
    f = read_mcap_full(str(mcap_path))
    line_topics = [c["topic"] for c in f.channels.values()
                   if "-line" in c["topic"]]
    assert len(line_topics) == len(set(line_topics)) == 2, line_topics


def test_mcap_duplicate_line_topics_uniquified(tmp_path):
    """Two line_3d nodes resolving to the same entity get distinct
    /scene topics (Foxglove backfills one message per topic)."""
    db = build_fixture(tmp_path / "db")
    sch = SCHEMATIC + (
        '\nline_3d drone.world_pos color=red'
        '\nline_3d drone.world_pos color=blue'
    )
    db.assets.put("schematics/main.kdl", sch.encode())
    mcap_path, _ = _export(db, tmp_path)
    f = read_mcap_full(str(mcap_path))
    line_topics = [c["topic"] for c in f.channels.values()
                   if "-line" in c["topic"]]
    assert len(line_topics) == len(set(line_topics)) == 2


# -- the port against the JAX package ---------------------------------------------


@pytest.mark.parametrize("opts", [
    {}, {"pattern": "Drone.*"}, {"epoch_offset_us": 500_000},
    {"max_embed_mb": 0}, {"include_private": True, "all_assets": True},
], ids=["default", "pattern", "epoch_offset", "no_embed", "private_all_assets"])
def test_mcap_bytes_are_the_jax_packages(tmp_path, opts):
    build_fixture(tmp_path / "db")
    outs = {}
    for name, db_cls, export in (("torch", Database, export_mcap),
                                 ("jax", JDatabase, jexport.export_mcap)):
        out = tmp_path / name
        out.mkdir()
        n = export(db_cls(str(tmp_path / "db")), str(out / "db.mcap"), **opts)
        outs[name] = (n, (out / "db.mcap").read_bytes(),
                      (out / "db.foxglove-layout.json").read_bytes())
    assert outs["torch"][0] > 0
    assert outs["torch"] == outs["jax"]


def _stsz_count(mp4: bytes) -> int:
    """The sample count of an MP4's one track (its stsz box)."""
    at = mp4.index(b"stsz")
    return struct.unpack_from(">I", mp4, at + 12)[0]


def test_mp4_bytes_are_the_jax_packages(tmp_path):
    """One log of Annex-B access units (SPS, PPS and IDR every 4th frame,
    a non-IDR slice between) muxed by each package: the same MP4 bytes
    and stats, one sample a frame."""
    from elodin_tpu_torch.examples.video_stream.main import _sps

    sc = b"\x00\x00\x00\x01"
    sps = _sps(640, 480, 30.0)
    entries = []
    for i in range(24):
        body = bytes((i * 7 + k) % 251 + 1 for k in range(40 + i))
        payload = (sc + sps + sc + b"\x68\xce\x3c\x80" + sc + b"\x65" + body
                   if i % 4 == 0 else sc + b"\x41" + body)
        entries.append((1_000_000 + i * 33_333 + (i % 3), payload))
    ours = video.export_h264_log(entries, "cam", tmp_path / "ours.mp4")
    ref = jvideo.export_h264_log(entries, "cam", tmp_path / "ref.mp4")
    assert ours == ref and ours["frames"] == 24
    assert (ours["width"], ours["height"]) == (640, 480)
    data = (tmp_path / "ours.mp4").read_bytes()
    assert data == (tmp_path / "ref.mp4").read_bytes()
    assert _stsz_count(data) == 24
    for i, (_, payload) in enumerate(entries):
        assert video.annexb_to_avcc(payload) == jvideo.annexb_to_avcc(payload), i


def _video_db(path, frames):
    """The video-stream example's frames, as H.264, in one message log."""
    from elodin_tpu_torch.db.postcard import msg_id
    from elodin_tpu_torch.examples.video_stream import main as vs

    db = Database(str(path))
    log = db.msg_log(msg_id(vs.STREAM_NAME))
    log.set_metadata(M.MsgMetadata(int.from_bytes(msg_id(vs.STREAM_NAME), "little"),
                                   vs.STREAM_NAME, {}))
    for i in range(frames):
        log.append(1_000_000 + i * int(1e6 / vs.FRAME_HZ), vs.make_h264_frame(i))
    text = db.msg_log(msg_id("fsw_log"))
    text.set_metadata(M.MsgMetadata(1, "fsw_log", {}))
    text.append(1_000_000, b"not a video")
    db.flush()


def test_export_videos_of_the_video_stream_frames(tmp_path, capsys):
    """``db export-videos`` of the video-stream example's frames, in
    process in each package: one MP4 with a sample a frame, and the same
    bytes from both."""
    from elodin_tpu.db.__main__ import main as jmain
    from elodin_tpu_torch.db.__main__ import main as tmain
    from elodin_tpu_torch.examples.video_stream import main as vs

    frames = 45
    _video_db(tmp_path / "db", frames)
    for name, run in (("torch", tmain), ("jax", jmain)):
        run(["export-videos", str(tmp_path / "db"), "--output", str(tmp_path / name)])
    out = capsys.readouterr().out
    assert "exported 1 video logs" in out
    files = sorted(os.listdir(tmp_path / "torch"))
    assert files == [vs.STREAM_NAME + ".mp4"] == sorted(os.listdir(tmp_path / "jax"))
    data = (tmp_path / "torch" / files[0]).read_bytes()
    assert data == (tmp_path / "jax" / files[0]).read_bytes()
    assert _stsz_count(data) == frames


def test_db_cli_mcap_in_process_is_the_jax_packages(tmp_path, capsys):
    from elodin_tpu.db.__main__ import main as jmain
    from elodin_tpu_torch.db.__main__ import main as tmain

    build_fixture(tmp_path / "mydb")
    for name, run in (("torch", tmain), ("jax", jmain)):
        run(["export", str(tmp_path / "mydb"), "--output", str(tmp_path / name),
             "--format", "mcap"])
    for f in ("mydb.mcap", "mydb.foxglove-layout.json"):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    assert capsys.readouterr().out.count("exported") == 2


def test_export_mcap_wrapper_and_cli_no_longer_raise(tmp_path):
    from elodin_tpu_torch.db import export

    build_fixture(tmp_path / "db")
    n = export.export_mcap(Database(str(tmp_path / "db")), str(tmp_path / "x.mcap"))
    assert n == len(read_mcap_full(str(tmp_path / "x.mcap")).messages) > 0


def test_served_nbody_database_exports_a_message_a_row(tmp_path, capsys):
    """The CPU rehearsal of ``chip_smoke.py`` phase 40 (c): a served
    n-body's database through ``db export --format mcap`` in process; each
    exported component's channel holds one message a stored row, in order,
    its values the store's."""
    from elodin_tpu_torch.__main__ import main as cli
    from elodin_tpu_torch.db.server import serve_exec
    from elodin_tpu_torch.models import nbody as tnb
    from torch_port_util import float_policy

    with float_policy("f64"):
        exec_ = tnb.build_nbody(6, seed=2).build(
            tnb.build_system(60.0, use_kernel=True), simulation_rate=60.0,
            db_path=str(tmp_path / "db"), device="cpu")
        srv = serve_exec(exec_, "127.0.0.1:0")
        try:
            exec_.run(15)
            exec_.flush_telemetry()
        finally:
            srv.stop()
            exec_.on_commit_batch = None
    cli(["db", "export", str(tmp_path / "db"), "--output", str(tmp_path / "out"),
         "--format", "mcap", "--pattern", "b*"])
    assert "exported" in capsys.readouterr().out
    f = read_mcap_full(str(tmp_path / "out" / "db.mcap"))
    db = Database(str(tmp_path / "db"))
    by_topic = {c["topic"]: cid for cid, c in f.channels.items()}
    msgs = {}
    for cid, log_time, data in f.messages:
        msgs.setdefault(cid, []).append((log_time, data))
    stores = [s for s in db.components.values() if s.name.startswith("b")]
    assert len(stores) == 6 * 5 and all(s.len == 16 for s in stores)
    for s in stores:
        got = msgs[by_topic["/" + s.name.replace(".", "/")]]
        assert len(got) == s.len, s.name
        for k, (log_time, data) in enumerate(got):
            assert log_time == int(s.timestamps[k]) * 1000  # no offset after 1970
            flat = np.asarray(_leaves(json.loads(data)), dtype=np.float64)
            assert np.array_equal(flat, np.asarray(s.values[k], dtype=np.float64).ravel()), s.name


def _leaves(obj):
    """A message's numbers in element order (objects nest at '.')."""
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _leaves(v)]
    if isinstance(obj, list):
        return [x for v in obj for x in _leaves(v)]
    return [obj]
