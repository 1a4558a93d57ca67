"""Frame MD5 conformance oracle.

Matches the reference `vpxdec --md5 --i420` output: the MD5 is computed
over the frame's visible pixels written plane-by-plane (Y then U then V,
row by row, no strides/borders) — reference vpxdec.c:322-371 out_put with
do_md5, which MD5Updates each buffered plane row-range exactly as written.
"""
import hashlib

import numpy as np


def frame_md5(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> str:
    m = hashlib.md5()
    m.update(np.ascontiguousarray(y, dtype=np.uint8).tobytes())
    m.update(np.ascontiguousarray(u, dtype=np.uint8).tobytes())
    m.update(np.ascontiguousarray(v, dtype=np.uint8).tobytes())
    return m.hexdigest()


def load_golden_md5s(path) -> list:
    with open(path) as f:
        return [line.split()[0] for line in f if line.strip()]
