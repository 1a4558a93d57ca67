"""VP8 boolean (binary-arithmetic) encoder — host reference implementation.

Mirrors the reference BOOL_CODER exactly (vp8/encoder/boolhuff.{h,c}):
24-bit lowvalue window with carry propagation into already-emitted bytes,
norm-table renormalization, and the 32-zero-bit flush.  Verified by
round-trip against models/boolcoder.BoolDecoder (the decoder the TPU
framework is bit-exact against).
"""
from __future__ import annotations

from ..ops import tables

_NORM = tables.NORM.tolist()


class BoolEncoder:
    __slots__ = ("lowvalue", "range", "count", "buf")

    def __init__(self):
        self.lowvalue = 0
        self.range = 255
        self.count = -24
        self.buf = bytearray()

    def write(self, bit: int, prob: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        lowvalue = self.lowvalue
        if bit:
            lowvalue += split
            rng = self.range - split
        else:
            rng = split
        shift = _NORM[rng]
        rng <<= shift
        count = self.count + shift
        if count >= 0:
            offset = shift - count
            if (lowvalue << (offset - 1)) & 0x80000000:
                # carry into emitted bytes (boolhuff.h:100-110)
                x = len(self.buf) - 1
                while x >= 0 and self.buf[x] == 0xFF:
                    self.buf[x] = 0
                    x -= 1
                self.buf[x] += 1
            self.buf.append((lowvalue >> (24 - offset)) & 0xFF)
            lowvalue <<= offset
            shift = count
            lowvalue &= 0xFFFFFF
            count -= 8
        self.lowvalue = (lowvalue << shift) & 0xFFFFFFFF
        self.range = rng
        self.count = count

    def write_bit(self, bit: int):
        self.write(bit, 0x80)

    def write_literal(self, value: int, bits: int):
        for b in range(bits - 1, -1, -1):
            self.write((value >> b) & 1, 0x80)

    def write_tree(self, tree, probs, value: int):
        """Encode a tree token (dual of vp8_treed_read): walk from the root
        emitting the branch bits along the path to leaf -value."""
        # build path by walking: at node i, children tree[i], tree[i+1]
        path = _tree_path(tuple(tree), value)
        for node, bit in path:
            self.write(bit, probs[node >> 1])

    def stop(self):
        """vp8_stop_encode: flush with 32 zero bits."""
        for _ in range(32):
            self.write(0, 128)
        return bytes(self.buf)


_PATH_CACHE = {}


def _tree_path(tree, value):
    key = (tree, value)
    hit = _PATH_CACHE.get(key)
    if hit is not None:
        return hit
    # DFS from root (index 0)
    def dfs(i, path):
        for bit in (0, 1):
            nxt = tree[i + bit]
            if nxt <= 0:
                if -nxt == value:
                    return path + [(i, bit)]
            else:
                r = dfs(nxt, path + [(i, bit)])
                if r is not None:
                    return r
        return None
    path = dfs(0, [])
    if path is None:
        raise ValueError(f"value {value} not in tree")
    _PATH_CACHE[key] = path
    return path
