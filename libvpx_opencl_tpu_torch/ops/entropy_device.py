"""K4: on-device VP8 token decode, the boolean arithmetic decoder and the
detokenizer over every macroblock of a frame.

Counterpart of libvpx_opencl_tpu/ops/entropy_device.py
(detokenize_frame_device), which is one jitted `lax.scan` over MBs and has
no Pallas kernel behind it. The decoder state machine is the 32-bit form of
the reference's bool decoder (dboolhuff.h:51-116: a 24-bit window in a
uint32, BITS = 24) and the control flow that of detokenize.c:183-384.
Partition p decodes MB rows p, p+P, p+2P, ... (decodframe.c:1112-1129);
the entropy contexts are above [C,9], shared by all rows, and left [9],
reset at the start of each row.

  * `detokenize_frame_device`: for CUDA tensors it launches
    csrc/detokenize.cu (one launch per call, counted in
    `launches["detokenize"]`) or raises; for CPU tensors it runs
    `detokenize_frame_plain`. There is no fallback from one to the other.
  * `detokenize_frame_plain`: the same function on Python ints, one
    `_mb_step` per MB on an explicit per-partition `_Lane`, the step a K4
    lane takes.

This is the validated device alternative, as in the JAX package: a serial
arithmetic decoder cannot beat the host C++ path
(csrc/host/vp8_entropy.cpp), so the decoders keep the host path and
nothing on the decode path calls this module. What a device path would buy
is the upload: the token partitions (~100 KB per 1080p inter frame)
instead of the dense coefficients.

Outputs equal the JAX function's bit for bit, partition states included:
those follow the 24-bit window, so they differ from the 64-bit window of
the host C++ runtime after the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.refdec import B_PRED, SPLITMV
from . import _cuda
from . import tables as T

BITS = 24
LOTS_OF_BITS = 0x4000
_MASK = 0xFFFFFFFF

ZIGZAG = [int(x) for x in T.ZIGZAG]
COEF_BANDS = [int(x) for x in T.COEF_BANDS]
BLOCK2ABOVE = [0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3,
               4, 5, 4, 5, 6, 7, 6, 7, 8]
BLOCK2LEFT = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
              4, 4, 5, 5, 6, 6, 7, 7, 8]
CAT_MIN = [5, 7, 11, 19, 35, 67]
CAT_PROBS = [[int(x) for x in p] for p in (T.PCAT1, T.PCAT2, T.PCAT3,
                                           T.PCAT4, T.PCAT5, T.PCAT6)]
CAT_LEN = [len(p) for p in CAT_PROBS]                    # 1,2,3,4,5,11

# vp8_norm: left-shift that renormalizes range into [128, 255]
_NORM = [0] * 256
for _i in range(1, 256):
    _v, _s = _i, 0
    while _v < 128:
        _v <<= 1
        _s += 1
    _NORM[_i] = _s

# block order / type / start tables (detokenize.c:183-243)
ORDER_Y2 = [24] + list(range(24))
ORDER_NOY2 = list(range(25))                  # 24 = inactive pad
BTYPE_Y2 = [1] + [0] * 16 + [2] * 8
BTYPE_NOY2 = [3] * 16 + [2] * 8 + [0]
START_Y2 = [0] + [1] * 16 + [0] * 8

launches = _cuda.launches
#: bool reads per partition of the last `detokenize_frame_plain` call
#: (sign reads included): the chain each K4 lane walks
plain_reads = []


def _norm(rng):
    """_NORM[rng] with the JAX gather's index rules (negative indices wrap
    once, then clamp): range stays in [1, 256] on any real stream."""
    i = rng + 256 if rng < 0 else rng
    return _NORM[min(max(i, 0), 255)]


class _Lane:
    """One partition's bool decoder: (value, range, count, pos) as in the
    JAX state, `buf` its padded bytes (length L) and `blen` its length."""

    __slots__ = ("buf", "blen", "value", "rng", "count", "pos", "reads",
                 "left")

    def __init__(self, buf, blen, state):
        self.buf, self.blen = buf, blen
        self.value = state[0] & _MASK
        self.rng, self.count, self.pos = state[1], state[2], state[3]
        self.reads = 0
        self.left = [0] * 9

    def state(self):
        """(value, range, count, pos) as int32, as the JAX function returns."""
        v = self.value
        return [v - (1 << 32) if v >= 1 << 31 else v, self.rng, self.count,
                self.pos]

    def _fill(self):
        """VP8DX_BOOL_DECODER_FILL (dboolhuff.h:51-73), BITS=24, three
        unrolled steps: a loop would take a fourth byte when count < -15."""
        count, pos = self.count, self.pos
        shift = BITS - 8 - (count + 8)
        bits_left = (self.blen - pos) * 8
        x = shift + 8 - bits_left
        loop_end = 0
        if x >= 0:
            count += LOTS_OF_BITS
            loop_end = x
            if bits_left <= 0:
                self.count = count
                return
        buf, value, last = self.buf, self.value, len(self.buf) - 1
        for _ in range(3):
            if shift < loop_end:
                break
            if pos < self.blen and shift < 32:
                value |= (buf[min(max(pos, 0), last)] << shift) & _MASK
            count += 8
            pos += 1
            shift -= 8
        self.value, self.count, self.pos = value, count, pos

    def read(self, prob):
        """vp8dx_decode_bool (dboolhuff.h:76-114)."""
        self.reads += 1
        split = 1 + (((self.rng - 1) * prob) >> 8)
        if self.count < 0:
            self._fill()
        bigsplit = (split << (BITS - 8)) & _MASK
        if self.value >= bigsplit:
            bit, rng, value = 1, self.rng - split, self.value - bigsplit
        else:
            bit, rng, value = 0, split, self.value
        sh = _norm(rng)
        self.value = (value << sh) & _MASK
        self.rng = rng << sh
        self.count -= sh
        return bit

    def read_sign(self):
        """Detokenizer sign read (DECODE_AND_APPLYSIGN): split=(range+1)>>1
        with one unconditional doubling; range may transiently reach 256."""
        self.reads += 1
        split = (self.rng + 1) >> 1
        if self.count < 0:
            self._fill()
        bigsplit = (split << (BITS - 8)) & _MASK
        if self.value >= bigsplit:
            neg, rng, value = 1, self.rng - split, self.value - bigsplit
        else:
            neg, rng, value = 0, split, self.value
        self.rng = rng + rng
        self.value = (value + value) & _MASK
        self.count -= 1
        return neg


def _decode_block(lane, probs_b, start, ctx, q):
    """One 4x4 block's token loop (detokenize.c:245-330) into q [16]
    (raster order, zero on entry); returns (eob, nonzero)."""
    c = start
    check_eob = True
    nz = 0
    while c < 16:
        p = probs_b[COEF_BANDS[c]][ctx]
        if check_eob and not lane.read(p[0]):
            break                                    # EOB
        if not lane.read(p[1]):                      # ZERO token
            if c == 15:
                break                                # malformed-input guard
            ctx = 0
            check_eob = False
            c += 1
            continue
        if not lane.read(p[2]):
            val, ctx = 1, 1
        else:
            ctx = 2
            if not lane.read(p[3]):
                if not lane.read(p[4]):
                    val = 2
                else:
                    val = 4 if lane.read(p[5]) else 3
            else:
                if not lane.read(p[6]):
                    cat = lane.read(p[7])
                elif not lane.read(p[8]):
                    cat = 2 + lane.read(p[9])
                else:
                    cat = 4 + lane.read(p[10])
                extra = 0
                for pj in CAT_PROBS[cat]:            # fixed probs, MSB first
                    extra = (extra << 1) | lane.read(pj)
                val = CAT_MIN[cat] + extra
        if lane.read_sign():
            val = -val
        q[ZIGZAG[c]] = val
        nz = 1
        check_eob = True
        if c == 15:
            break               # a coded 16th coefficient leaves eob 15
        c += 1
    return c, nz


class _Frame:
    """A frame's inputs as Python lists, its shared above contexts and its
    outputs: what the K4 block keeps in shared and device memory."""

    def __init__(self, R, C, P, bufs, blens, states0, coef_probs, has_y2,
                 skip_in):
        self.R, self.C, self.P = R, C, P
        bl = blens.tolist()
        st = states0.tolist()
        self.lanes = [_Lane(bytes(b.tolist()), bl[p], st[p])
                      for p, b in enumerate(bufs)]
        self.probs = coef_probs.tolist()
        self.has_y2 = [bool(x) for x in has_y2.tolist()]
        self.skip_in = skip_in.tolist()
        self.above = [[0] * 9 for _ in range(C)]
        N = R * C
        self.q = [[[0] * 16 for _ in range(25)] for _ in range(N)]
        self.eobs = [[0] * 25 for _ in range(N)]
        self.skipped = [0] * N


def _mb_step(fr, r, c):
    """Decode MB (r, c) on partition r % P; needs MB (r-1, c) done, since
    it reads and then writes above[c]."""
    lane = fr.lanes[r % fr.P]
    n = r * fr.C + c
    if c == 0:
        lane.left = [0] * 9
    above, left = fr.above[c], lane.left
    hy2 = fr.has_y2[n]
    if fr.skip_in[n]:
        # vp8_reset_mb_tokens_context (detokenize.c:70-84)
        for k in range(9 if hy2 else 8):
            above[k] = left[k] = 0
        fr.skipped[n] = 1
        return
    q, e = fr.q[n], fr.eobs[n]
    eobtotal = -16 if hy2 else 0
    for k in range(25 if hy2 else 24):
        if hy2:
            i, btype, start = ORDER_Y2[k], BTYPE_Y2[k], START_Y2[k]
        else:
            i, btype, start = ORDER_NOY2[k], BTYPE_NOY2[k], 0
        ia, il = BLOCK2ABOVE[i], BLOCK2LEFT[i]
        eob, nz = _decode_block(lane, fr.probs[btype], start,
                                above[ia] + left[il], q[i])
        e[i] = eob
        above[ia] = left[il] = nz
        eobtotal += eob
    fr.skipped[n] = int(eobtotal == 0)


def _outputs(fr, device):
    global plain_reads
    plain_reads = [lane.reads for lane in fr.lanes]
    i32 = torch.int32
    return (torch.tensor(fr.q, dtype=i32, device=device).reshape(-1, 25, 16),
            torch.tensor(fr.eobs, dtype=i32, device=device).reshape(-1, 25),
            torch.tensor(fr.skipped, dtype=i32, device=device),
            torch.tensor([lane.state() for lane in fr.lanes], dtype=i32,
                         device=device).reshape(fr.P, 4))


def detokenize_frame_plain(R, C, P, bufs, blens, states0, coef_probs, has_y2,
                           skip_in):
    """Whole-frame token decode on Python ints, MBs in raster order (the
    JAX scan's order); arguments and results as `detokenize_frame_device`,
    on the inputs' device. Records the bool reads per partition in
    `plain_reads`.

    Python ints and not torch ops: a bool read as tensor operations is ~10
    dependent launches, ~50 us, which would be minutes per CIF frame and
    hours per 1080p frame."""
    fr = _Frame(R, C, P, bufs, blens, states0, coef_probs, has_y2, skip_in)
    for r in range(R):
        for c in range(C):
            _mb_step(fr, r, c)
    return _outputs(fr, bufs.device)


def frame_inputs(dec, L=None):
    """K4's inputs for the frame a RefDecoder is decoding, as numpy arrays
    (bufs [P, L] uint8 zero-padded, blens, states0, coef_probs, has_y2,
    skip_in), with (R, C, P) first. Call it from `_detokenize_all` before
    the host detokenizer runs (that one sets `skip` where eobtotal is 0).
    Each partition starts from a fresh bool decoder, value 0, range 255,
    count -8, pos 0. L defaults to the longest partition."""
    R, C = dec.mb_rows, dec.mb_cols
    parts = [np.frombuffer(p.buf, np.uint8) for p in dec.bool_parts]
    P = len(parts)
    L = L or max(1, *map(len, parts))
    bufs = np.zeros((P, L), np.uint8)
    for i, b in enumerate(parts):
        bufs[i, :len(b)] = b
    blens = np.asarray([len(b) for b in parts], np.int32)
    states0 = np.tile(np.asarray([0, 255, -8, 0], np.int32), (P, 1))
    modes = dec.mode[1:, 1:].reshape(-1)
    has_y2 = ~np.isin(modes, (B_PRED, SPLITMV))
    skip_in = dec.skip.reshape(-1).astype(np.int32)
    # a copy: the next frame's header updates fc.coef_probs in place
    probs = np.array(dec.fc.coef_probs, np.int32)
    return R, C, P, bufs, blens, states0, probs, has_y2, skip_in


_ARGS = (("bufs", torch.uint8), ("blens", torch.int32),
         ("states0", torch.int32), ("coef_probs", torch.int32),
         ("has_y2", torch.bool), ("skip_in", torch.int32))
MAX_ROWS = 1024           # MB rows and columns K4 takes: VP8 sizes are
MAX_COLS = 1024           # 14 bits
MAX_PARTS = 8             # token partitions of a VP8 frame: 1, 2, 4 or 8


def _check_cuda(R, C, P, args):
    """Validate the kernel's arguments; raise on anything it does not take."""
    if not (1 <= R <= MAX_ROWS and 1 <= C <= MAX_COLS and
            1 <= P <= MAX_PARTS):
        raise ValueError(f"K4 takes 1..{MAX_ROWS} MB rows, 1..{MAX_COLS} "
                         f"columns and 1..{MAX_PARTS} partitions, got "
                         f"{R}x{C}, P={P}")
    N = R * C
    L = args[0].shape[-1] if args[0].dim() == 2 else -1
    shapes = ((P, L), (P,), (P, 4), (4, 8, 3, 11), (N,), (N,))
    dev = args[0].device
    for t, (name, dtype), shp in zip(args, _ARGS, shapes):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shp or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shp} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if L < 1:
        raise ValueError("bufs must hold at least one byte per partition")


def launch(R, C, P, bufs, blens, states0, coef_probs, has_y2, skip_in,
           q, eobs, skipped, states):
    """One launch of csrc/detokenize.cu on the current stream of the
    inputs' device into q [N,25,16] (zero on entry: K4 writes only the
    coefficients it decodes), eobs [N,25], skipped [N] and states [P,4],
    all int32 and contiguous. Arguments as checked by
    `detokenize_frame_device`."""
    fn = _cuda.load()["detokenize"]
    with torch.cuda.device(bufs.device):
        stream = torch.cuda.current_stream(bufs.device).cuda_stream
        rc = fn(bufs.data_ptr(), bufs.shape[1], blens.data_ptr(),
                states0.data_ptr(), coef_probs.data_ptr(),
                has_y2.view(torch.uint8).data_ptr(), skip_in.data_ptr(),
                q.data_ptr(), eobs.data_ptr(), skipped.data_ptr(),
                states.data_ptr(), R, C, P, stream)
    _cuda.check(rc, "detokenize")
    _cuda.count_launch("detokenize")


def detokenize_frame_device(R, C, P, bufs, blens, states0, coef_probs,
                            has_y2, skip_in):
    """Whole-frame token decode.

    bufs [P, L] uint8 (padded partition buffers), blens [P] int32, states0
    [P, 4] int32 (value/range/count/pos: the host hands over the
    post-header bool states; value must fit the 24-bit window), coef_probs
    [4,8,3,11] int32, has_y2 [R*C] bool, skip_in [R*C] int32
    (mb_no_coeff_skip flags).

    Returns (qcoeff [R*C, 25, 16], eobs [R*C, 25], skip_out [R*C],
    states [P, 4]), int32 on the inputs' device.

    CUDA tensors: one launch of csrc/detokenize.cu, counted in
    launches["detokenize"]. CPU tensors: the plain version. The decoders
    do not call this: they detokenize on the host (module docstring)."""
    args = (bufs, blens, states0, coef_probs, has_y2, skip_in)
    if all(t.device.type == "cpu" for t in args):
        return detokenize_frame_plain(R, C, P, *args)
    _check_cuda(R, C, P, args)
    N = R * C
    dev = bufs.device
    q = torch.zeros((N, 25, 16), dtype=torch.int32, device=dev)
    eobs = torch.empty((N, 25), dtype=torch.int32, device=dev)
    skipped = torch.empty(N, dtype=torch.int32, device=dev)
    states = torch.empty((P, 4), dtype=torch.int32, device=dev)
    launch(R, C, P, *args, q, eobs, skipped, states)
    return q, eobs, skipped, states
