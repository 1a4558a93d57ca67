"""IVF container reader (32-byte file header, then a 12-byte header and
the payload per frame), independent of the program."""
import struct

_FILE = struct.Struct("<4sHH4sHHIIII")
_FRAME = struct.Struct("<IQ")


def read_ivf(file):
    """(width, height, [payload bytes, ...]) of an IVF file."""
    with open(file, "rb") as f:
        data = f.read()
    magic, _ver, hdr, _cc, w, h = _FILE.unpack_from(data, 0)[:6]
    if magic != b"DKIF":
        raise ValueError(f"{file}: not an IVF file")
    frames, pos = [], hdr
    while pos + _FRAME.size <= len(data):
        size, _pts = _FRAME.unpack_from(data, pos)
        pos += _FRAME.size
        frames.append(data[pos:pos + size])
        pos += size
    return w, h, frames
