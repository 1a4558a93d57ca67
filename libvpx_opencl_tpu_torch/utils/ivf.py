"""IVF container reader/writer.

IVF is the trivial 32-byte-header container the reference tools use for
raw VP8 streams (reference: vpxdec.c:150-171 file_is_ivf probe,
vpxenc.c:412-467 ivf_write_file_header/ivf_write_frame_header).
Layout: 32-byte file header ('DKIF', version, header size, fourcc,
width, height, timebase num/den, frame count) then per-frame 12-byte
headers (frame size u32 LE, pts u64 LE) + payload.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field


IVF_FILE_HDR = struct.Struct("<4sHH4sHHIIII")
IVF_FRAME_HDR = struct.Struct("<IQ")
FOURCC_VP8 = b"VP80"


@dataclass
class IvfStream:
    width: int
    height: int
    timebase_num: int = 1
    timebase_den: int = 30
    fourcc: bytes = FOURCC_VP8
    frames: list = field(default_factory=list)  # list of (payload: bytes, pts: int)


def read_ivf(path_or_bytes) -> IvfStream:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    (magic, version, hdr_sz, fourcc, w, h, den, num,
     _nframes, _unused) = IVF_FILE_HDR.unpack_from(data, 0)
    if magic != b"DKIF":
        raise ValueError(f"not an IVF file (magic={magic!r})")
    if version != 0:
        raise ValueError(f"unsupported IVF version {version}")
    stream = IvfStream(width=w, height=h, timebase_num=num, timebase_den=den,
                       fourcc=fourcc)
    pos = hdr_sz
    while pos + IVF_FRAME_HDR.size <= len(data):
        size, pts = IVF_FRAME_HDR.unpack_from(data, pos)
        pos += IVF_FRAME_HDR.size
        stream.frames.append((data[pos:pos + size], pts))
        pos += size
    return stream


def write_ivf(path, stream: IvfStream) -> None:
    with open(path, "wb") as f:
        f.write(IVF_FILE_HDR.pack(
            b"DKIF", 0, 32, stream.fourcc, stream.width, stream.height,
            stream.timebase_den, stream.timebase_num, len(stream.frames), 0))
        for payload, pts in stream.frames:
            f.write(IVF_FRAME_HDR.pack(len(payload), pts))
            f.write(payload)
