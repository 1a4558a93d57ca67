"""Source-frame lookahead buffer (vp8/encoder/lookahead.c:63-208).

The reference buffers up to 25 raw source frames (onyx.h:137-138
lag_in_frames) so the encoder can look ahead for altref synthesis and
two-pass statistics. Same contract here: push copies in, peek by distance,
pop in display order.
"""
from __future__ import annotations

import numpy as np


class Lookahead:
    def __init__(self, max_lag=25):
        self.max_lag = max_lag
        self._q = []

    def depth(self):
        return len(self._q)

    def full(self):
        return len(self._q) >= self.max_lag

    def push(self, y, u, v, pts=0):
        """vp8_lookahead_push (copies the planes like the reference's
        vp8_copy_and_extend_frame into the lookahead ring)."""
        if self.full():
            raise IndexError("lookahead full")
        self._q.append((np.asarray(y).copy(), np.asarray(u).copy(),
                        np.asarray(v).copy(), pts))

    def peek(self, distance):
        """vp8_lookahead_peek: entry `distance` ahead of the read point."""
        if 0 <= distance < len(self._q):
            return self._q[distance]
        return None

    def pop(self):
        """vp8_lookahead_pop: oldest entry, in display order."""
        if not self._q:
            return None
        return self._q.pop(0)
