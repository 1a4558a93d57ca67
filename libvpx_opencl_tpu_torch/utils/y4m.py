"""YUV4MPEG2 (.y4m) reader/writer (the role of y4minput.c in the reference
tools). Supports C420 family color spaces (420jpeg/420mpeg2/420paldv/420)."""
from __future__ import annotations

import numpy as np


class Y4MReader:
    def __init__(self, path):
        self.f = open(path, "rb")
        header = b""
        while not header.endswith(b"\n"):
            ch = self.f.read(1)
            if not ch:
                raise ValueError("truncated y4m header")
            header += ch
        fields = header.decode().split()
        if fields[0] != "YUV4MPEG2":
            raise ValueError("not a y4m file")
        self.w = self.h = 0
        self.fps = (30, 1)
        self.colorspace = "420jpeg"
        for f in fields[1:]:
            if f[0] == "W":
                self.w = int(f[1:])
            elif f[0] == "H":
                self.h = int(f[1:])
            elif f[0] == "F":
                num, den = f[1:].split(":")
                self.fps = (int(num), int(den))
            elif f[0] == "C":
                self.colorspace = f[1:]
        if not self.colorspace.startswith("420"):
            raise ValueError(f"unsupported colorspace {self.colorspace}")

    def __iter__(self):
        cw, ch = (self.w + 1) // 2, (self.h + 1) // 2
        ysz, csz = self.w * self.h, cw * ch
        while True:
            line = b""
            while not line.endswith(b"\n"):
                b_ = self.f.read(1)
                if not b_:
                    return
                line += b_
            if not line.startswith(b"FRAME"):
                return
            data = self.f.read(ysz + 2 * csz)
            if len(data) < ysz + 2 * csz:
                return
            y = np.frombuffer(data[:ysz], np.uint8).reshape(self.h, self.w)
            u = np.frombuffer(data[ysz:ysz + csz], np.uint8).reshape(ch, cw)
            v = np.frombuffer(data[ysz + csz:], np.uint8).reshape(ch, cw)
            yield y, u, v


def write_y4m(path, frames, w, h, fps=(30, 1)):
    with open(path, "wb") as f:
        f.write(b"YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 C420jpeg\n"
                % (w, h, fps[0], fps[1]))
        for y, u, v in frames:
            f.write(b"FRAME\n")
            f.write(np.ascontiguousarray(y, np.uint8).tobytes())
            f.write(np.ascontiguousarray(u, np.uint8).tobytes())
            f.write(np.ascontiguousarray(v, np.uint8).tobytes())
