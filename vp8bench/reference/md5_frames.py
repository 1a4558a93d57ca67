"""Decode check: every shown frame the run produced, on all three planes,
against the golden per-frame MD5s that the reference libvpx
`vpxdec --md5 --i420` wrote for the stream (a copy beside it,
`config["golden_md5"]`). The MD5 runs over the visible pixels plane by
plane, Y then U then V, row by row (vpxdec.c's --md5 output).

The drivers hand each frame's visible planes to `digest` as the window
runs (with the clock stopped) and the check compares the digests.

Compared: md5_mismatch_frames, the frames whose MD5 differs or that could
not be read (digest None), limit 0 (the configuration's guarantee: every
shown frame is bit-exact). A run that produced no frame counts one.
"""
import hashlib
import os

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frame_md5(y, u, v):
    m = hashlib.md5()
    for p in (y, u, v):
        m.update(np.ascontiguousarray(p, dtype=np.uint8).tobytes())
    return m.hexdigest()


def digest(y, u, v):
    """What the check compares of one frame: its MD5."""
    return frame_md5(y, u, v)


def golden(config):
    with open(os.path.join(HERE, config["golden_md5"])) as f:
        return [line.split()[0] for line in f if line.strip()]


def check(config, traffic, outputs, seed, log):
    want = golden(config)
    n = bad = 0
    first_bad = None
    for k, md5 in outputs["frames"]:
        n += 1
        if md5 is None or md5 != want[k]:
            bad += 1
            if first_bad is None:
                first_bad = (n - 1, k)
    log(f"md5: {n} frames compared with the golden MD5s, {bad} differ"
        + (f" (first: frame {first_bad[0]}, stream index {first_bad[1]})"
           if first_bad else ""))
    return [{"name": "md5_mismatch_frames", "value": bad + (n == 0),
             "limit": 0}]
