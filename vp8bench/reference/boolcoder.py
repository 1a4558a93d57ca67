"""VP8 boolean (binary-arithmetic) coder — host reference implementation.

Decoder semantics mirror the reference's BOOL_DECODER exactly
(vp8/decoder/dboolhuff.{h,c}): a 64-bit left-justified value window,
`count` = buffered bits minus 8, `range` in [128, 255] (with one documented
transient exception, see `read_sign_det`), zero-fill past the end of the
buffer, and renormalization via the NORM shift table.

The detokenizer's coefficient-sign reads use a slightly different
renormalization (split = (range+1)>>1 followed by one unconditional
doubling — vp8/decoder/detokenize.c:101-117 DECODE_AND_APPLYSIGN) which can
leave range == 256 transiently; `read_sign_det` replicates that behavior so
our decode is bit-exact versus the reference decoder.
"""
from __future__ import annotations

from . import vp8_tables as tables

BITS = 64
MASK64 = (1 << BITS) - 1
LOTS_OF_BITS = 0x40000000
_NORM = tables.NORM.tolist()


class BoolDecoder:
    """Reference arithmetic decoder (dboolhuff.h:76-114 semantics)."""

    __slots__ = ("buf", "pos", "n", "value", "count", "range")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.n = len(buf)
        self.value = 0
        self.count = -8
        self.range = 255
        self._fill()

    def _fill(self):
        # VP8DX_BOOL_DECODER_FILL (dboolhuff.h:51-73)
        shift = BITS - 8 - (self.count + 8)
        bits_left = (self.n - self.pos) * 8
        x = shift + 8 - bits_left
        loop_end = 0
        if x >= 0:
            self.count += LOTS_OF_BITS
            loop_end = x
            if bits_left == 0:
                return
        buf, pos, value, count = self.buf, self.pos, self.value, self.count
        while shift >= loop_end:
            count += 8
            value |= buf[pos] << shift
            pos += 1
            shift -= 8
        self.pos, self.value, self.count = pos, value, count

    def read(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.count < 0:
            self._fill()
        bigsplit = split << (BITS - 8)
        if self.value >= bigsplit:
            rng = self.range - split
            self.value -= bigsplit
            bit = 1
        else:
            rng = split
            bit = 0
        shift = _NORM[rng]
        self.range = rng << shift
        self.value = (self.value << shift) & MASK64
        self.count -= shift
        return bit

    def read_bit(self) -> int:
        return self.read(0x80)

    def read_literal(self, bits: int) -> int:
        z = 0
        for _ in range(bits):
            z = (z << 1) | self.read(0x80)
        return z

    def read_tree(self, tree, probs) -> int:
        """vp8_treed_read (vp8/decoder/treereader.h:40-50)."""
        i = tree[self.read(probs[0])]
        while i > 0:
            i = tree[i + self.read(probs[i >> 1])]
        return -i

    def read_sign_det(self) -> int:
        """Detokenizer sign read (detokenize.c DECODE_AND_APPLYSIGN).

        split = (range+1)>>1, then one unconditional doubling of range and
        value (range may transiently become 256).  Returns 1 if negative.
        """
        split = (self.range + 1) >> 1
        if self.count < 0:
            self._fill()
        bigsplit = split << (BITS - 8)
        if self.value < bigsplit:
            self.range = split
            neg = 0
        else:
            self.range -= split
            self.value -= bigsplit
            neg = 1
        self.range += self.range
        self.value = (self.value + self.value) & MASK64
        self.count -= 1
        return neg

    def error(self) -> bool:
        """vp8dx_bool_error (dboolhuff.h:129-153): read past end of data."""
        return BITS < self.count < LOTS_OF_BITS
