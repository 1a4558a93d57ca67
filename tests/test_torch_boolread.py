"""K4's bool read and token-tree walk (csrc/boolread.cuh, csrc/detokenize.cu),
held with the plain reader of ops/entropy_device.py (the CUDA kernel cannot
run here).

* The fast read's domain: from any range in [128, 256] and probability in
  [0, 255], a read_bool leaves a range in [1, 255] before it normalises
  (where the JAX gather's wrap and clamp in norm_shift change nothing and
  the shift is clz - 24) and in [128, 255] after; a read_sign leaves one in
  [128, 256]. So a lane that starts there stays there.
* `_FastLane`, the fast read written out in Python in the kernel's order
  (both outcomes normalised beside the compare; the fill's 2 or 3 bytes
  from two aligned words loaded at the previous fill; the exact fill near
  the end of the partition and off the usual states), equals the plain
  `_Lane` state for state after every read: random partitions at every
  alignment of the buffer, blen 0 to 3, partitions that end mid-window,
  reads far past the end, and states that start the exact fill at once.
  Its look-ahead reads only aligned words that hold a byte of the buffer.
* `_walk_block`, the kernel's token loop (a token's probabilities taken
  into registers at its start, the tree's next probability picked by a
  select on the bit, the category extra bits under immediate
  probabilities), equals the plain `_decode_block` on random bytes; and a
  whole frame through `_FastLane` and `_walk_block` equals
  `detokenize_frame_plain`, partition states included.
Change these together with the kernel.
"""
import functools

import numpy as np
import pytest
import torch

from conftest import vector
from libvpx_opencl_tpu_torch.models.refdec import RefDecoder
from libvpx_opencl_tpu_torch.ops import entropy_device as ED
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf

torch.set_num_threads(1)
MASK = 0xFFFFFFFF
GARBAGE = 0xA5       # bytes around a partition buffer in the emulated memory

# COEF_BANDS[c] for c = 0..15, three bits each (kBandBits in detokenize.cu)
BAND_BITS = (0 | 1 << 3 | 2 << 6 | 3 << 9 | 6 << 12 | 4 << 15 | 5 << 18 |
             6 << 21 | 6 << 24 | 6 << 27 | 6 << 30 | 6 << 33 | 6 << 36 |
             6 << 39 | 6 << 42 | 7 << 45)


def _clz32(x):
    assert 0 < x <= MASK
    return 32 - x.bit_length()


def test_fast_read_domain_is_closed():
    """Every (range, probability) pair the fast read can meet."""
    r = np.arange(128, 257)[:, None]
    p = np.arange(256)[None, :]
    split = 1 + (((r - 1) * p) >> 8)
    for pre in (split, r - split):                   # bit 0, bit 1
        pre = np.broadcast_to(pre, split.shape).ravel()
        assert pre.min() >= 1 and pre.max() <= 255
        sh = np.asarray([ED._norm(int(v)) for v in pre])
        assert (sh == np.asarray([_clz32(int(v)) - 24 for v in pre])).all()
        post = pre << sh
        assert post.min() >= 128 and post.max() <= 255
    r = np.arange(128, 257)
    split = (r + 1) >> 1
    for pre in (split, r - split):                   # read_sign
        assert (2 * pre).min() >= 128 and (2 * pre).max() <= 256
    assert [(BAND_BITS >> (3 * c)) & 7 for c in range(16)] == ED.COEF_BANDS


class _FastLane(ED._Lane):
    """read_bool<true> and read_sign<true> of csrc/boolread.cuh on one lane
    whose buffer starts `base` bytes past a 4-byte boundary; the buffer
    sits in memory between GARBAGE bytes."""

    __slots__ = ("mem", "base", "w0", "w1", "off8", "ahead", "words")

    def __init__(self, buf, blen, state, base=0):
        super().__init__(buf, blen, state)
        self.base = base
        self.mem = bytes([GARBAGE] * base) + bytes(buf) + bytes([GARBAGE] * 8)
        self.words = set()
        self.ahead = 0 <= self.pos <= self.blen <= len(self.buf)
        if self.ahead:
            self._look_ahead()

    def _word(self, a):
        self.words.add(a)
        return int.from_bytes(self.mem[a:a + 4], "little")

    def _look_ahead(self):
        a = self.base + self.pos
        end = self.base + self.blen
        w = a & ~3
        self.off8 = (a & 3) * 8
        self.w0 = self._word(w) if w < end else 0
        self.w1 = self._word(w + 4) if w + 4 < end else 0

    def _fill_fast(self):
        shift = 8 - self.count
        if self.ahead and shift <= 16 and \
                (self.blen - self.pos) * 8 > shift + 8:
            k = (shift >> 3) + 1
            le = (((self.w1 << 32) | self.w0) >> self.off8) & MASK
            be = int.from_bytes(le.to_bytes(4, "little"), "big")
            self.value |= ((be >> (32 - 8 * k)) << (shift - 8 * (k - 1))) \
                & MASK
            self.count += 8 * k
            self.pos += k
            self._look_ahead()
        else:
            self.ahead = False
            self._fill()

    def read(self, prob):
        self.reads += 1
        split = 1 + (((self.rng - 1) * prob) >> 8)
        if self.count < 0:
            self._fill_fast()
        bigsplit = split << 16
        bit = int(self.value >= bigsplit)
        r1 = self.rng - split
        sh0, sh1 = _clz32(split) - 24, _clz32(r1) - 24
        v0 = (self.value << sh0) & MASK
        v1 = ((self.value - bigsplit) << sh1) & MASK
        self.value = v1 if bit else v0
        self.rng = r1 << sh1 if bit else split << sh0
        self.count -= sh1 if bit else sh0
        return bit

    def read_sign(self):
        self.reads += 1
        split = (self.rng + 1) >> 1
        if self.count < 0:
            self._fill_fast()
        bigsplit = split << 16
        neg = int(self.value >= bigsplit)
        rng, value = (self.rng - split, self.value - bigsplit) if neg \
            else (split, self.value)
        self.rng = rng + rng
        self.value = (value + value) & MASK
        self.count -= 1
        return neg


def _lane_cases():
    """(buf, blen, state) partitions: blen 0-3, random lengths, buffers
    longer than blen, skewed and flat bytes, usual and unusual states."""
    rng = np.random.default_rng(41)
    fresh = [0, 255, -8, 0]
    cases = [(b"", 0, fresh), (b"\x80", 1, fresh), (b"\xff\x00", 2, fresh),
             (b"\x12\x34\x56", 3, fresh)]
    for i in range(36):
        L = int(rng.integers(1, 200))
        blen = int(rng.integers(0, L + 1))
        buf = rng.integers(0, 256, L).astype(np.uint8)
        if i % 3 == 0:
            buf = np.where(rng.random(L) < 0.8, 0, buf).astype(np.uint8)
        state = fresh
        if i % 4 == 1:       # mid-stream: value fits its window
            count = int(rng.integers(-7, 16))
            rg = int(rng.integers(128, 257))
            pos = int(rng.integers(0, blen + 1))
            free = max(0, 16 - count)
            value = int(rng.integers(0, rg << 16)) >> free << free
            state = [value, rg, count, pos]
        if i % 9 == 2:       # off the usual states: the exact fill at once
            state = [0, 200, -12, 0]
        cases.append((bytes(buf.tolist()), blen, state))
    return cases


@pytest.mark.parametrize("base", [0, 1, 2, 3])
def test_fast_read_matches_plain_state_by_state(base):
    rng = np.random.default_rng(500 + base)
    for buf, blen, state in _lane_cases():
        want = ED._Lane(buf, blen, state)
        got = _FastLane(buf, blen, state, base)
        # enough reads to run well past the end of the partition
        for i in range(8 * blen + 400):
            if rng.random() < 0.15:
                bits = (got.read_sign(), want.read_sign())
            else:
                prob = int(rng.integers(0, 256)) if i % 2 else \
                    int(rng.choice([1, 2, 128, 250, 254, 255]))
                bits = (got.read(prob), want.read(prob))
            assert bits[0] == bits[1]
            assert got.state() == want.state(), (i, blen, state)
        lo, hi = base & ~3, base + len(buf)
        assert all(lo <= a < hi for a in got.words), "read outside the buffer"


def _cat_value(lane, cat):
    """cat_value: the extra bits of a category under its fixed
    probabilities, MSB first."""
    e = 0
    for p in ED.CAT_PROBS[cat]:
        e = e << 1 | lane.read(p)
    return ED.CAT_MIN[cat] + e


def _walk_block(lane, probs_b, start, ctx, q):
    """decode_block of csrc/detokenize.cu: (eob, nonzero) into q [16]."""
    c = start
    check_eob = True
    nz = 0
    while c < 16:
        p = probs_b[(BAND_BITS >> (3 * c)) & 7][ctx]   # the token's row
        if check_eob and not lane.read(p[0]):
            break
        if not lane.read(p[1]):
            if c == 15:
                break
            ctx = 0
            check_eob = False
            c += 1
            continue
        if not lane.read(p[2]):
            val, ctx = 1, 1
        else:
            ctx = 2
            b3 = lane.read(p[3])
            b = lane.read(p[6] if b3 else p[4])
            if not b3:
                val = 3 + lane.read(p[5]) if b else 2
            elif not b:
                val = _cat_value(lane, lane.read(p[7]))
            else:
                b8 = lane.read(p[8])
                val = _cat_value(lane, 2 + 2 * b8 +
                                 lane.read(p[10] if b8 else p[9]))
        if lane.read_sign():
            val = -val
        q[ED.ZIGZAG[c]] = val
        nz = 1
        check_eob = True
        if c == 15:
            break
        c += 1
    return c, nz


@functools.lru_cache(maxsize=None)
def _stream_frame(name, index):
    """K4's inputs for frame `index` of a test stream."""
    frames = []

    class Probe(RefDecoder):
        use_native = True

        def _detokenize_all(self):
            frames.append(ED.frame_inputs(self))
            super()._detokenize_all()

    dec = Probe()
    for payload, _ in read_ivf(vector(name)).frames[:index + 1]:
        dec.decode_frame(payload)
    return frames[index]


def test_tree_walk_matches_plain_decode_block():
    """Random bytes under a real frame's probabilities, every block type,
    start and context: the same eob, nonzero flag, coefficients and reader
    state as ED._decode_block."""
    probs = _stream_frame("part4_cif.ivf", 0)[6].tolist()
    rng = np.random.default_rng(3)
    for trial in range(60):
        buf = bytes(rng.integers(0, 256, 300).astype(np.uint8).tolist())
        blen = int(rng.integers(0, 301))
        want_lane = ED._Lane(buf, blen, [0, 255, -8, 0])
        got_lane = ED._Lane(buf, blen, [0, 255, -8, 0])
        for _ in range(40):
            btype, start = int(rng.integers(0, 4)), int(rng.integers(0, 2))
            ctx = int(rng.integers(0, 3))
            qw, qg = [0] * 16, [0] * 16
            want = ED._decode_block(want_lane, probs[btype], start, ctx, qw)
            got = _walk_block(got_lane, probs[btype], start, ctx, qg)
            assert got == want and qg == qw
            assert got_lane.state() == want_lane.state()


@pytest.mark.parametrize("name,index", [("part4_cif.ivf", 0),
                                        ("inter_qcif.ivf", 1),
                                        ("random", 0)])
def test_fast_lane_and_tree_walk_match_plain_frame(monkeypatch, name,
                                                   index):
    """A whole frame through _FastLane (each partition at its own
    alignment, as bufs [P, L] lays them out) and _walk_block ==
    detokenize_frame_plain on every output."""
    R, C, P, *arrays = _stream_frame(
        "part4_cif.ivf" if name == "random" else name, index)
    if name == "random":
        rng = np.random.default_rng(9)
        R, C, P, L = 6, 8, 4, 301
        arrays = [rng.integers(0, 256, (P, L)).astype(np.uint8),
                  np.asarray([L, 17, 0, 250], np.int32),
                  np.tile(np.asarray([0, 255, -8, 0], np.int32), (P, 1)),
                  arrays[3], rng.random(R * C) < 0.7,
                  (rng.random(R * C) < 0.2).astype(np.int32)]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    want = ED.detokenize_frame_plain(R, C, P, *t)
    L = arrays[0].shape[1]
    made = []

    def lane(buf, blen, state):
        made.append(_FastLane(buf, blen, state, base=(len(made) * L) % 4))
        return made[-1]

    monkeypatch.setattr(ED, "_Lane", lane)
    monkeypatch.setattr(ED, "_decode_block", _walk_block)
    got = ED.detokenize_frame_plain(R, C, P, *t)
    assert len(made) == P
    for g, w in zip(got, want):
        assert torch.equal(g, w)
