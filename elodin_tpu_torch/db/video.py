"""H.264 Annex-B parsing and MP4 (ISO BMFF) muxing, dependency-free.

Parity: libs/db/src/export_videos.rs — the reference reads H.264 Annex-B NAL
units from message logs, parses the SPS for resolution/frame-rate, and muxes
frames into MP4 via the `muxide` crate (openh264 re-encodes raw sensor-camera
RGBA logs first).  This rebuild keeps the same CLI surface with a pure
Python muxer: Annex-B → AVCC length-prefixed samples inside a single `mdat`,
`moov` with avcC/stts/stss/stsz/stsc/stco built from the log's timestamps.
The RGBA re-encode path needs an H.264 encoder, which is not bundled; those logs are exported as-is alongside a `.rgba.json` shape sidecar.

A host-only copy of ``elodin_tpu/db/video.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

START_CODE_4 = b"\x00\x00\x00\x01"
START_CODE_3 = b"\x00\x00\x01"

NAL_SPS = 7
NAL_PPS = 8
NAL_IDR = 5
NAL_AUD = 9


def iter_nals(payload: bytes):
    """Yield NAL-unit byte ranges (without start codes) from Annex-B data.

    Scans with ``bytes.find`` (C speed) — the byte-by-byte Python loop this
    replaces allocated two slices per input byte, turning a few hundred MB
    of footage into minutes of CPU."""
    n = len(payload)
    starts = []
    i = payload.find(START_CODE_3)
    while i != -1:
        # a 4-byte 00 00 00 01 code contains the 3-byte 00 00 01 at i+1;
        # either way the NAL payload begins after the 00 00 01
        starts.append(i + 3)
        i = payload.find(START_CODE_3, i + 3)
    for k, s in enumerate(starts):
        e = n
        if k + 1 < len(starts):
            e = starts[k + 1] - 3
            # strip a leading zero of a 4-byte start code from the tail
            if e > s and payload[e - 1] == 0:
                e -= 1
        nal = payload[s:e]
        if nal:
            yield nal


def find_nal(payload: bytes, nal_type: int) -> bytes | None:
    for nal in iter_nals(payload):
        if nal[0] & 0x1F == nal_type:
            return nal
    return None


def is_keyframe(payload: bytes) -> bool:
    """True if the access unit contains an IDR slice
    (muxide's is_h264_keyframe equivalent)."""
    return find_nal(payload, NAL_IDR) is not None


def strip_emulation_prevention(rbsp: bytes) -> bytes:
    """Remove 0x000003 emulation-prevention bytes from an RBSP."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b == 0x03:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            bit = (byte >> (7 - (self.pos & 7))) & 1
            v = (v << 1) | bit
            self.pos += 1
        return v

    def ue(self) -> int:
        """Unsigned exp-Golomb."""
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("bad exp-Golomb code")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        """Signed exp-Golomb."""
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


@dataclass
class SpsInfo:
    profile_idc: int
    level_idc: int
    width: int
    height: int
    fps: float | None  # from VUI timing_info when present


def parse_sps(sps_nal: bytes) -> SpsInfo:
    """Parse width/height (+ VUI frame rate) from an SPS NAL unit
    (reference: scuffle_h264::Sps::parse_with_emulation_prevention usage at
    export_videos.rs:186-194)."""
    rbsp = strip_emulation_prevention(sps_nal[1:])  # skip NAL header byte
    r = _BitReader(rbsp)
    profile_idc = r.u(8)
    r.u(8)  # constraint flags + reserved
    level_idc = r.u(8)
    r.ue()  # sps_id
    chroma_format_idc = 1
    if profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135):
        chroma_format_idc = r.ue()
        if chroma_format_idc == 3:
            r.u(1)  # separate_colour_plane
        r.ue()  # bit_depth_luma_minus8
        r.ue()  # bit_depth_chroma_minus8
        r.u(1)  # qpprime_y_zero_transform_bypass
        if r.u(1):  # seq_scaling_matrix_present
            count = 8 if chroma_format_idc != 3 else 12
            for i in range(count):
                if r.u(1):  # seq_scaling_list_present[i]
                    size = 16 if i < 6 else 64
                    last, nxt = 8, 8
                    for _ in range(size):
                        if nxt != 0:
                            nxt = (last + r.se() + 256) % 256
                        last = nxt if nxt else last
    r.ue()  # log2_max_frame_num_minus4
    poc_type = r.ue()
    if poc_type == 0:
        r.ue()  # log2_max_pic_order_cnt_lsb_minus4
    elif poc_type == 1:
        r.u(1)  # delta_pic_order_always_zero
        r.se()  # offset_for_non_ref_pic
        r.se()  # offset_for_top_to_bottom_field
        for _ in range(r.ue()):
            r.se()
    r.ue()  # max_num_ref_frames
    r.u(1)  # gaps_in_frame_num_value_allowed
    pic_width_in_mbs = r.ue() + 1
    pic_height_in_map_units = r.ue() + 1
    frame_mbs_only = r.u(1)
    if not frame_mbs_only:
        r.u(1)  # mb_adaptive_frame_field
    r.u(1)  # direct_8x8_inference
    crop_l = crop_r = crop_t = crop_b = 0
    if r.u(1):  # frame_cropping
        crop_l, crop_r, crop_t, crop_b = r.ue(), r.ue(), r.ue(), r.ue()
    fps = None
    if r.u(1):  # vui_parameters_present
        if r.u(1):  # aspect_ratio_info_present
            if r.u(8) == 255:  # Extended_SAR
                r.u(32)
        if r.u(1):  # overscan_info_present
            r.u(1)
        if r.u(1):  # video_signal_type_present
            r.u(4)  # format + full_range
            if r.u(1):  # colour_description_present
                r.u(24)
        if r.u(1):  # chroma_loc_info_present
            r.ue()
            r.ue()
        if r.u(1):  # timing_info_present
            num_units_in_tick = r.u(32)
            time_scale = r.u(32)
            if num_units_in_tick:
                # field-rate convention: fps = time_scale / (2 * num_units)
                fps = time_scale / (2.0 * num_units_in_tick)
    # crop units (frame_mbs_only, chroma 4:2:0 → x2 horizontal/vertical)
    sub_w = 2 if chroma_format_idc in (1, 2) else 1
    sub_h = 2 if chroma_format_idc == 1 else 1
    width = pic_width_in_mbs * 16 - (crop_l + crop_r) * sub_w
    height = (2 - frame_mbs_only) * pic_height_in_map_units * 16 - (
        crop_t + crop_b
    ) * sub_h * (2 - frame_mbs_only)
    return SpsInfo(profile_idc, level_idc, width, height, fps)


def annexb_to_avcc(payload: bytes) -> tuple[bytes, bytes | None, bytes | None]:
    """Convert one Annex-B access unit to a length-prefixed AVCC sample.
    Returns (sample, sps, pps); SPS/PPS/AUD NALs are lifted out of the sample
    (they live in the avcC box)."""
    sample = bytearray()
    sps = pps = None
    for nal in iter_nals(payload):
        t = nal[0] & 0x1F
        if t == NAL_SPS:
            sps = nal
        elif t == NAL_PPS:
            pps = nal
        elif t == NAL_AUD:
            continue
        else:
            sample += struct.pack(">I", len(nal)) + nal
    return bytes(sample), sps, pps


def _box(fourcc: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + fourcc + payload


def _full_box(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(fourcc, struct.pack(">I", (version << 24) | flags) + payload)


class Mp4Writer:
    """Minimal single-video-track MP4 muxer (moov-at-end layout).

    Samples are buffered with microsecond pts and written as one contiguous
    chunk in `mdat`; `finish()` emits the `moov` with per-sample durations
    (stts run-length encoded), sync-sample table, and 90 kHz media timescale.
    """

    TIMESCALE = 90_000

    def __init__(self, path, width: int, height: int, sps: bytes, pps: bytes,
                 default_fps: float = 30.0):
        self.path = path
        self.width = width
        self.height = height
        self.sps = sps
        self.pps = pps
        self.default_fps = max(1e-3, float(default_fps))
        self.samples: list[bytes] = []
        self.pts_us: list[int] = []
        self.keyframes: list[bool] = []

    def write_video(self, pts_us: int, sample: bytes, keyframe: bool) -> None:
        self.samples.append(sample)
        self.pts_us.append(int(pts_us))
        self.keyframes.append(bool(keyframe))

    # -- box builders ---------------------------------------------------

    def _avcc(self) -> bytes:
        sps, pps = self.sps, self.pps
        body = bytes(
            [1, sps[1], sps[2], sps[3], 0xFF, 0xE1]
        ) + struct.pack(">H", len(sps)) + sps + b"\x01" + struct.pack(
            ">H", len(pps)
        ) + pps
        return _box(b"avcC", body)

    def _stsd(self) -> bytes:
        avc1 = _box(
            b"avc1",
            struct.pack(">6xH", 1)  # reserved + data_reference_index
            + struct.pack(">16x")  # pre_defined/reserved
            + struct.pack(">HH", self.width, self.height)
            + struct.pack(">II", 0x0048_0000, 0x0048_0000)  # 72 dpi
            + struct.pack(">I", 0)
            + struct.pack(">H", 1)  # frame_count
            + b"\x00" * 32  # compressorname
            + struct.pack(">Hh", 0x18, -1)  # depth, pre_defined
            + self._avcc(),
        )
        return _full_box(b"stsd", 0, 0, struct.pack(">I", 1) + avc1)

    def _durations(self) -> list[int]:
        """Per-sample durations in media timescale ticks."""
        n = len(self.samples)
        if n == 0:
            return []
        fallback = max(1, int(round(self.TIMESCALE / self.default_fps)))
        if n > 1 and self.pts_us[-1] <= self.pts_us[0]:
            # degenerate timestamps (all equal / non-monotonic): fall back to
            # the requested frame rate instead of 1-tick durations
            return [fallback] * n
        ticks = [
            int(round(t * self.TIMESCALE / 1_000_000)) for t in self.pts_us
        ]
        durs = [max(1, ticks[i + 1] - ticks[i]) for i in range(n - 1)]
        durs.append(durs[-1] if durs else fallback)
        return durs

    def _stts(self, durs: list[int]) -> bytes:
        runs: list[tuple[int, int]] = []
        for d in durs:
            if runs and runs[-1][1] == d:
                runs[-1] = (runs[-1][0] + 1, d)
            else:
                runs.append((1, d))
        body = struct.pack(">I", len(runs)) + b"".join(
            struct.pack(">II", c, d) for c, d in runs
        )
        return _full_box(b"stts", 0, 0, body)

    def finish(self) -> dict:
        n = len(self.samples)
        durs = self._durations()
        duration = sum(durs)
        mdat_payload = b"".join(self.samples)
        ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2avc1mp41")
        # chunk offset = ftyp + mdat header
        chunk_offset = len(ftyp) + 8
        stbl = _box(
            b"stbl",
            self._stsd()
            + self._stts(durs)
            # stss omitted entirely when no keyframes were detected: an
            # EMPTY stss means "no sync samples" per ISO BMFF and makes
            # the file unseekable in strict players; absence means every
            # sample is a sync point
            + (
                _full_box(
                    b"stss",
                    0,
                    0,
                    struct.pack(">I", sum(self.keyframes))
                    + b"".join(
                        struct.pack(">I", i + 1)
                        for i, k in enumerate(self.keyframes)
                        if k
                    ),
                )
                if any(self.keyframes)
                else b""
            )
            + _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
            + _full_box(
                b"stsz",
                0,
                0,
                struct.pack(">II", 0, n)
                + b"".join(struct.pack(">I", len(s)) for s in self.samples),
            )
            + _full_box(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset)),
        )
        minf = _box(
            b"minf",
            _full_box(b"vmhd", 0, 1, struct.pack(">8x"))
            + _box(
                b"dinf",
                _full_box(
                    b"dref", 0, 0,
                    struct.pack(">I", 1) + _full_box(b"url ", 0, 1, b""),
                ),
            )
            + stbl,
        )
        mdia = _box(
            b"mdia",
            _full_box(
                b"mdhd", 0, 0,
                struct.pack(">IIIIHH", 0, 0, self.TIMESCALE, duration, 0x55C4, 0),
            )
            + _full_box(
                b"hdlr", 0, 0,
                struct.pack(">4x") + b"vide" + b"\x00" * 12 + b"VideoHandler\x00",
            )
            + minf,
        )
        tkhd = _full_box(
            b"tkhd", 0, 7,
            struct.pack(">III4xI", 0, 0, 1, duration)
            + struct.pack(">8x")
            + struct.pack(">HHHH", 0, 0, 0x0100, 0)
            + struct.pack(
                ">9I", 0x0001_0000, 0, 0, 0, 0x0001_0000, 0, 0, 0, 0x4000_0000
            )
            + struct.pack(">II", self.width << 16, self.height << 16),
        )
        trak = _box(b"trak", tkhd + mdia)
        mvhd = _full_box(
            b"mvhd", 0, 0,
            struct.pack(">IIII", 0, 0, self.TIMESCALE, duration)
            + struct.pack(">IH2x", 0x0001_0000, 0x0100)
            + struct.pack(">8x")
            + struct.pack(
                ">9I", 0x0001_0000, 0, 0, 0, 0x0001_0000, 0, 0, 0, 0x4000_0000
            )
            + struct.pack(">24x")
            + struct.pack(">I", 2),  # next_track_id
        )
        moov = _box(b"moov", mvhd + trak)
        with open(self.path, "wb") as f:
            f.write(ftyp)
            f.write(_box(b"mdat", mdat_payload))
            f.write(moov)
        return {
            "frames": n,
            "duration_s": duration / self.TIMESCALE,
            "bytes": len(ftyp) + 8 + len(mdat_payload) + len(moov),
        }


def export_h264_log(entries, name: str, out_path, default_fps: float = 30.0):
    """Mux one msg log's (timestamp_us, annexb_payload) entries into an MP4.
    Returns the stats dict, or None when no SPS is found in the first frames
    (reference: export_one_h264, export_videos.rs:157-247)."""
    if not entries:
        return None
    sps = pps = None
    for _, payload in entries[:20]:
        sps = sps or find_nal(payload, NAL_SPS)
        pps = pps or find_nal(payload, NAL_PPS)
        if sps and pps:
            break
    if sps is None or pps is None:
        return None
    info = parse_sps(sps)
    writer = Mp4Writer(out_path, info.width, info.height, sps, pps,
                       default_fps=info.fps or default_fps)
    t0 = entries[0][0]
    for ts, payload in entries:
        sample, _, _ = annexb_to_avcc(payload)
        if sample:
            writer.write_video(ts - t0, sample, is_keyframe(payload))
    if not writer.samples:
        # SPS/PPS only, no slice NALs: an MP4 with zero samples would have
        # a malformed stsc/stss — report nothing exported instead
        return None
    stats = writer.finish()
    stats.update(width=info.width, height=info.height,
                 fps=info.fps or default_fps)
    return stats
