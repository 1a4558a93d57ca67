"""Minimal WebM (Matroska subset) demuxer + muxer for VP8 streams.

The roles of the reference's vendored containers: nestegg (demux,
nestegg/src/nestegg.c — vpxdec's WebM input path, vpxdec.c webm_guess) and
libmkv (mux, libmkv/EbmlWriter.c + WebMElement.c — vpxenc's WebM output,
vpxenc.c:590-621). Supports one VP8 video track, SimpleBlocks and
Block-in-BlockGroup, which covers vpxenc-style files.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

# EBML element IDs (raw, including length descriptor bits)
EBML = 0x1A45DFA3
SEGMENT = 0x18538067
INFO = 0x1549A966
TIMECODE_SCALE = 0x2AD7B1
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_TYPE = 0x83
CODEC_ID = 0x86
VIDEO = 0xE0
PIXEL_WIDTH = 0xB0
PIXEL_HEIGHT = 0xBA
CLUSTER = 0x1F43B675
CLUSTER_TIMECODE = 0xE7
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1
DURATION = 0x4489
MUXING_APP = 0x4D80
WRITING_APP = 0x5741
DOC_TYPE = 0x4282
EBML_VERSION = 0x4286
DOCTYPE_VERSION = 0x4287
DOCTYPE_READ_VERSION = 0x4285


def _read_vint(data, pos, strip_marker=True):
    first = data[pos]
    mask = 0x80
    length = 1
    while length <= 8 and not (first & mask):
        mask >>= 1
        length += 1
    if length > 8:
        raise ValueError("bad vint")
    value = first & (mask - 1) if strip_marker else first
    for i in range(1, length):
        value = (value << 8) | data[pos + i]
    return value, pos + length


def _read_id(data, pos):
    first = data[pos]
    length = 1
    mask = 0x80
    while length <= 4 and not (first & mask):
        mask >>= 1
        length += 1
    value = 0
    for i in range(length):
        value = (value << 8) | data[pos + i]
    return value, pos + length


def _uint(payload):
    v = 0
    for b in payload:
        v = (v << 8) | b
    return v


@dataclass
class WebMStream:
    width: int = 0
    height: int = 0
    timecode_scale: int = 1000000
    frames: list = field(default_factory=list)  # (payload, timecode_ms, key)


def read_webm(path_or_bytes) -> WebMStream:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    out = WebMStream()
    vp8_track = None

    def walk(pos, end, cluster_tc=0):
        nonlocal vp8_track, cluster_tc_holder
        while pos < end:
            eid, pos = _read_id(data, pos)
            size, pos = _read_vint(data, pos)
            if size == (1 << 56) - 1:  # unknown size: scan to end
                size = end - pos
            nxt = pos + size
            if eid in (SEGMENT, TRACKS, CLUSTER, BLOCK_GROUP):
                if eid == CLUSTER:
                    cluster_tc_holder[0] = 0
                walk(pos, nxt)
            elif eid == TRACK_ENTRY:
                info = parse_track(pos, nxt)
                if info.get("codec") == b"V_VP8":
                    vp8_track = info.get("number", 1)
                    out.width = info.get("width", 0)
                    out.height = info.get("height", 0)
            elif eid == TIMECODE_SCALE:
                out.timecode_scale = _uint(data[pos:nxt])
            elif eid == CLUSTER_TIMECODE:
                cluster_tc_holder[0] = _uint(data[pos:nxt])
            elif eid in (SIMPLE_BLOCK, BLOCK):
                tnum, p2 = _read_vint(data, pos)
                rel_tc = struct.unpack(">h", data[p2:p2 + 2])[0]
                flags = data[p2 + 2]
                payload = data[p2 + 3:nxt]
                if vp8_track is None or tnum == vp8_track:
                    key = bool(flags & 0x80) if eid == SIMPLE_BLOCK else \
                        (len(payload) > 0 and not (payload[0] & 1))
                    out.frames.append((payload,
                                       cluster_tc_holder[0] + rel_tc, key))
            pos = nxt

    def parse_track(pos, end):
        info = {}
        while pos < end:
            eid, pos = _read_id(data, pos)
            size, pos = _read_vint(data, pos)
            nxt = pos + size
            if eid == TRACK_NUMBER:
                info["number"] = _uint(data[pos:nxt])
            elif eid == CODEC_ID:
                info["codec"] = data[pos:nxt]
            elif eid == VIDEO:
                p = pos
                while p < nxt:
                    vid, p = _read_id(data, p)
                    vsz, p = _read_vint(data, p)
                    if vid == PIXEL_WIDTH:
                        info["width"] = _uint(data[p:p + vsz])
                    elif vid == PIXEL_HEIGHT:
                        info["height"] = _uint(data[p:p + vsz])
                    p += vsz
            pos = nxt
        return info

    cluster_tc_holder = [0]
    walk(0, len(data))
    return out


# ---------------------------------------------------------------------------
# muxer

def _enc_id(eid):
    out = b""
    while eid:
        out = bytes([eid & 0xFF]) + out
        eid >>= 8
    return out


def _enc_size(n):
    # 8-byte length descriptor keeps things simple and always valid
    return bytes([0x01]) + n.to_bytes(7, "big")


def _elem(eid, payload):
    return _enc_id(eid) + _enc_size(len(payload)) + payload


def _uint_payload(v, width=None):
    out = b"" if v else b"\x00"
    while v:
        out = bytes([v & 0xFF]) + out
        v >>= 8
    if width:
        out = out.rjust(width, b"\x00")
    return out


def write_webm(path, stream: WebMStream):
    ebml = _elem(EBML, b"".join([
        _elem(EBML_VERSION, b"\x01"),
        _elem(DOC_TYPE, b"webm"),
        _elem(DOCTYPE_VERSION, b"\x02"),
        _elem(DOCTYPE_READ_VERSION, b"\x02"),
    ]))
    info = _elem(INFO, b"".join([
        _elem(TIMECODE_SCALE, _uint_payload(stream.timecode_scale)),
        _elem(MUXING_APP, b"libvpx_opencl_tpu"),
        _elem(WRITING_APP, b"tpuvpxenc"),
    ]))
    video = _elem(VIDEO, b"".join([
        _elem(PIXEL_WIDTH, _uint_payload(stream.width)),
        _elem(PIXEL_HEIGHT, _uint_payload(stream.height)),
    ]))
    track = _elem(TRACK_ENTRY, b"".join([
        _elem(TRACK_NUMBER, b"\x01"),
        _elem(TRACK_TYPE, b"\x01"),  # video
        _elem(CODEC_ID, b"V_VP8"),
        video,
    ]))
    tracks = _elem(TRACKS, track)
    clusters = b""
    # one cluster per ~32 frames
    for base in range(0, len(stream.frames), 32):
        group = stream.frames[base:base + 32]
        tc0 = int(group[0][1])
        blocks = b""
        for payload, tc, key in group:
            rel = int(tc) - tc0
            hdr = bytes([0x81]) + struct.pack(">h", rel) + \
                bytes([0x80 if key else 0x00])
            blocks += _elem(SIMPLE_BLOCK, hdr + payload)
        clusters += _elem(CLUSTER,
                          _elem(CLUSTER_TIMECODE, _uint_payload(tc0)) +
                          blocks)
    segment = _elem(SEGMENT, info + tracks + clusters)
    with open(path, "wb") as f:
        f.write(ebml + segment)
