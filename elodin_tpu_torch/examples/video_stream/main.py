"""Video streaming into elodin-db in torch (counterpart of
``examples/video-stream/main.py``; parity: the reference's
examples/video-stream/main.py — the reference pushes GStreamer / OBS-SRT
H.264 into the DB as OpaqueBytes message streams displayed by the editor;
GStreamer and the GPU decode path are editor-side, so this example keeps the
*data plane*: a rolling-ball sim serves telemetry while a frame producer
pushes timestamped opaque video-chunk messages onto a msg stream, and a
consumer tails them live — exactly the path a real encoder would use).

Run headless (the sim's own CLI arguments follow; the card unless
``--device`` says otherwise):
    ELODIN_MAX_TICKS=600 python -m elodin_tpu_torch.examples.video_stream.main run 127.0.0.1:2240
then:  python -m elodin_tpu_torch db repl 127.0.0.1:2240
    >>> client.get_msgs("video.test_pattern")

Beside the JAX example's opaque frames, ``make_h264_frame`` wraps the same
test pattern in an H.264 Annex-B access unit (a parameter set on the first
frame, one slice NAL a frame), so the log is one that ``db export-videos``
and the web viewer's ``/api/video`` mux to MP4 (``stream_frames(h264=True)``).
The slices carry the pattern, not coded macroblocks: the stream is muxed,
never decoded.  (This module defines ``@el.system`` functions, so it must
not use postponed annotations.)
"""

import os
import sys
import threading
import time
import typing as ty
from dataclasses import field

import numpy as np
import torch

import elodin_tpu_torch as el
from elodin_tpu_torch.cli import serve_addr

SIM_TIME_STEP = 1.0 / 120.0
BALL_RADIUS = 0.3
BOUNDARY = 4.0
FRAME_HZ = 30.0
STREAM_NAME = "video.test_pattern"
FRAME_W, FRAME_H = 32, 18

WindPhase = ty.Annotated[torch.Tensor, el.Component("wind_phase", el.ComponentType.F64)]


@el.dataclass
class Ball(el.Archetype):
    wind_phase: WindPhase = field(default_factory=lambda: np.float64(0.0))


@el.system
def rolling_wind(
    tick: el.Query[el.SimulationTick],
    ts: el.Query[el.SimulationTimeStep],
    q: el.Query[WindPhase, el.WorldPos, el.WorldVel],
) -> el.Query[el.WorldVel]:
    """Rotating wind pushes the ball; walls reflect it (reference wind +
    bounce systems)."""
    t = tick[0] * ts[0]

    def one(phase, pos, vel):
        a = 0.4 * t + phase
        wind = 2.0 * torch.stack([torch.cos(a), torch.sin(a), torch.zeros_like(a)])
        v = vel.linear() + wind * SIM_TIME_STEP
        p = pos.linear()
        hit = (torch.abs(p[:2]) > BOUNDARY) & (torch.sign(v[:2]) == torch.sign(p[:2]))
        v = torch.cat([torch.where(hit, -v[:2], v[:2]), v[2:]])
        return el.SpatialMotion(angular=vel.angular(), linear=v)

    return q.map(el.WorldVel, one)


def make_frame(seq: int, width: int = FRAME_W, height: int = FRAME_H) -> bytes:
    """Synthetic "encoded frame": a moving test-pattern payload with a tiny
    header, standing in for an H.264 NAL unit (OpaqueBytes contract)."""
    x = (np.arange(width) + seq) % 256
    y = (np.arange(height) * 7 + seq * 3) % 256
    frame = (x[None, :] ^ y[:, None]).astype(np.uint8)
    return b"FRM" + seq.to_bytes(4, "little") + frame.tobytes()


def _emulation_prevent(rbsp: bytes) -> bytes:
    """00 00 {00,01,02,03} -> 00 00 03 xx, so no start code hides in a NAL."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def _sps(width: int, height: int, fps: float) -> bytes:
    """A baseline-profile SPS NAL for a width x height picture at fps."""
    bits = []

    def u(v, n):
        bits.extend((v >> i) & 1 for i in range(n - 1, -1, -1))

    def ue(v):
        k = v + 1
        u(0, k.bit_length() - 1)
        u(k, k.bit_length())

    wmb, hmb = -(-width // 16), -(-height // 16)
    crop_r, crop_b = (wmb * 16 - width) // 2, (hmb * 16 - height) // 2
    u(66, 8)                      # profile_idc: baseline
    u(0, 8)                       # constraint flags
    u(30, 8)                      # level_idc
    ue(0)                         # seq_parameter_set_id
    ue(0)                         # log2_max_frame_num_minus4
    ue(2)                         # pic_order_cnt_type
    ue(0)                         # max_num_ref_frames
    u(0, 1)                       # gaps_in_frame_num_value_allowed
    ue(wmb - 1)
    ue(hmb - 1)
    u(1, 1)                       # frame_mbs_only
    u(0, 1)                       # direct_8x8_inference
    u(1 if crop_r or crop_b else 0, 1)
    if crop_r or crop_b:
        ue(0), ue(crop_r), ue(0), ue(crop_b)
    u(1, 1)                       # vui_parameters_present
    u(0, 1), u(0, 1), u(0, 1), u(0, 1)
    u(1, 1)                       # timing_info_present
    u(1, 32)                      # num_units_in_tick
    u(int(round(2 * fps)), 32)    # time_scale
    u(0, 1)                       # fixed_frame_rate
    u(0, 1), u(0, 1), u(0, 1), u(0, 1)
    u(1, 1)                       # rbsp_stop_one_bit
    while len(bits) % 8:
        bits.append(0)
    rbsp = bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))
    return b"\x67" + _emulation_prevent(rbsp)


_PPS = b"\x68\xce\x3c\x80"  # pps_id 0, sps_id 0, CAVLC, one slice group
_START = b"\x00\x00\x00\x01"


def make_h264_frame(seq: int, width: int = FRAME_W, height: int = FRAME_H,
                    fps: float = FRAME_HZ) -> bytes:
    """``make_frame(seq)`` as an H.264 Annex-B access unit: SPS, PPS and an
    IDR slice on frame 0, a non-IDR slice after it."""
    body = _emulation_prevent(make_frame(seq, width, height))
    if seq == 0:
        return (_START + _sps(width, height, fps) + _START + _PPS
                + _START + b"\x65" + body)
    return _START + b"\x41" + body


def stream_frames(addr: str, n_frames: int = 60, retries: int = 40,
                  h264: bool = False) -> int:
    """Producer: push timestamped opaque frames (the gstreamer bridge role,
    stream-video.sh -> impeller2 MsgStream with OpaqueBytes schema)."""
    from ...db import Client

    client = None
    for _ in range(retries):
        try:
            client = Client.connect(addr)
            break
        except OSError:
            time.sleep(0.25)
    if client is None:
        raise SystemExit(f"no db at {addr}")
    make = make_h264_frame if h264 else make_frame
    t0 = time.time_ns() // 1000
    period_us = int(1_000_000 / FRAME_HZ)
    for i in range(n_frames):
        client.send_msg(STREAM_NAME, make(i), timestamp_us=t0 + i * period_us)
        # pace at FRAME_HZ like a real encoder — a burst would defeat the
        # live-tail path the example demonstrates
        if not os.environ.get("ELODIN_SKIP_RUN"):
            time.sleep(1.0 / FRAME_HZ)
    client.close()
    return n_frames


def tail_frames(addr: str, n_frames: int = 10) -> int:
    """Consumer: tail the live frame stream (the editor's video pane role)
    via a TimestampedMsgStream subscription."""
    from ...db import Client

    client = Client.connect(addr)
    got = 0
    try:
        with client.timestamped_msg_stream(STREAM_NAME) as stream:
            for _ts, data in stream:
                got += 1
                print(f"frame {got}: {len(data)} bytes", flush=True)
                if got >= n_frames:
                    break
    finally:
        client.close()
    return got


def world() -> el.World:
    w = el.World()
    w.spawn(
        [
            el.Body(
                world_pos=el.SpatialTransform(linear=torch.tensor(
                    [0.0, 0.0, BALL_RADIUS], dtype=torch.float64)),
                world_vel=el.SpatialMotion(linear=torch.tensor(
                    [1.5, 0.7, 0.0], dtype=torch.float64)),
                inertia=el.SpatialInertia(mass=0.5),
            ),
            Ball(),
        ],
        name="Ball",
    )
    w.schematic(
        """
        tabs {
            viewport name=Viewport look_at="ball.world_pos" show_grid=#true
            video_stream name="Test Pattern" msg_name="video.test_pattern"
            video_stream name="OBS" msg_name="video.obs" waiting=#true
        }
        """
    )
    return w


def system() -> el.System:
    return rolling_wind | el.six_dof(sys=())


if __name__ == "__main__":
    addr = serve_addr(sys.argv[1:])
    threading.Thread(target=stream_frames, args=(addr,), daemon=True).start()

    def _tail():
        time.sleep(1.0)  # wait for serve + producer attach
        try:
            tail_frames(addr)
        except Exception:  # headless runs may exit before frames arrive
            pass

    threading.Thread(target=_tail, daemon=True).start()
    world().run(system(), simulation_rate=1.0 / SIM_TIME_STEP)
