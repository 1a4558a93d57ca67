"""K3's launch geometry and packed-byte arithmetic, without a card.

csrc/sad_grid.cu runs only on a CUDA card, so its arithmetic is held here
by a numpy emulation that follows the kernel step by step, with the
geometry the wrapper passes (ops/me_sad.py:_plan): the per-block shared
buffer (packed source words, windows at the plan's row pitch, zero tail),
one thread per (dy, run of K dx), 32-bit little-endian word loads (every
load must be aligned and inside the buffer), the funnel-shift alignment
to the run's first dx and to each offset, and the packed absolute
difference summed into 32 bits. Its output must equal sad_grid_plain
exactly (integer math, tolerance 0). With K = 11 the runs start at dx 0,
11 and 22, so the alignment shifts are 0, 3 and 2 bytes and the
per-offset shifts 0-3 bytes; windows start at every wx mod 4.
"""
import numpy as np
import pytest
import torch

from libvpx_opencl_tpu_torch.ops import me_sad

torch.set_num_threads(1)
M32 = np.uint64(0xFFFFFFFF)


def _funnelshift_r(lo, hi, sh):
    """__funnelshift_r for shifts below 32: (hi:lo >> sh) & 0xffffffff."""
    return ((hi << np.uint64(32) | lo) >> np.asarray(sh, np.uint64)) & M32


def _sad4(a, b, acc):
    """__dp4a(__vabsdiffu4(a, b), 0x01010101, acc): acc + the sum over
    the 4 bytes of |a - b|."""
    for k in range(4):
        s = np.uint64(8 * k)
        acc = acc + np.abs(((a >> s) & np.uint64(255)).astype(np.int64)
                           - ((b >> s) & np.uint64(255)).astype(np.int64)
                           ).astype(np.uint64)
    assert int(acc.max(initial=0)) < 2 ** 32       # no 32-bit overflow
    return acc


def emulate_kernel(plane, wy, wx, src, rng):
    """csrc/sad_grid.cu in numpy: [N, 2*rng+1, 2*rng+1] int64; an offset
    no thread stores stays -1."""
    p = me_sad._plan(rng)
    n_c, n = 2 * rng + 1, len(wy)
    w = n_c + 15
    sb = me_sad._SRC_BYTES
    na = (p.k + 14) // 4 + 1
    out = np.full((n, n_c, n_c), -1, np.int64)
    threads = p.mbs * p.threads_per_mb
    n_warps = threads >> 5
    for n0 in range(0, n, p.mbs):
        nm = min(p.mbs, n - n0)
        # shared memory starts as garbage: a byte no loop writes shows
        buf = np.full(p.shared, 0xA5, np.uint8)
        win0 = p.mbs * sb
        assert win0 % 16 == 0 and p.pitch % 16 == 0
        for m in range(p.mbs):           # packed source words, 0 past nm
            px = src[n0 + m].reshape(64, 4).astype(np.uint32) if m < nm \
                else np.zeros((64, 4), np.uint32)
            words = px[:, 0] | px[:, 1] << 8 | px[:, 2] << 16 | px[:, 3] << 24
            buf[m * sb:m * sb + 256] = words.astype("<u4").view(np.uint8)
        # a window row per full warp, its lanes striding the pitch (a
        # warp has only the lanes of threads that exist)
        for warp in range(n_warps):
            c = np.concatenate([np.arange(lane, p.pitch, 32) for lane in
                                range(min(32, threads - 32 * warp))])
            for row in range(warp, p.mbs * w, n_warps):
                m, r = divmod(row, w)
                v = np.zeros(len(c), np.uint8)
                if m < nm:
                    v[c < w] = plane[wy[n0 + m] + r, wx[n0 + m] + c[c < w]]
                buf[win0 + row * p.pitch + c] = v
        buf[win0 + p.mbs * w * p.pitch:] = 0                # zero tail

        def load(byte_off):
            assert (byte_off % 4 == 0).all()
            assert (byte_off >= 0).all() and (byte_off + 4 <= p.shared).all()
            idx = byte_off // 4
            return buf.view("<u4")[idx].astype(np.uint64)

        tid = np.arange(nm * p.threads_per_mb)
        m = tid // p.threads_per_mb
        ll = tid % p.threads_per_mb
        i = ll // p.groups
        j0 = ll % p.groups * p.k
        sh = 8 * (j0 & 3)
        wrow = win0 + (m * w + i) * p.pitch + 4 * (j0 >> 2)
        acc = np.zeros((len(tid), p.k), np.uint64)
        for r in range(16):
            s4 = [load(m * sb + 16 * r + 4 * q) for q in range(4)]
            wv = [load(wrow + r * p.pitch + 4 * q) for q in range(na + 1)]
            a = [_funnelshift_r(wv[q], wv[q + 1], sh) for q in range(na)]
            for t in range(p.k):
                for q in range(4):
                    b = (t >> 2) + q
                    x = _funnelshift_r(a[b], a[b + 1], 8 * (t & 3)) \
                        if t & 3 else a[b]
                    acc[:, t] = _sad4(x, s4[q], acc[:, t])
        for t in range(p.k):
            ok = j0 + t < n_c
            out[n0 + m[ok], i[ok], j0[ok] + t] = acc[ok, t].astype(np.int64)
    return out


def _plain(plane, wy, wx, src, rng):
    return me_sad.sad_grid_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                                   for a in (plane, wy, wx, src)),
                                 rng).numpy()


@pytest.mark.parametrize("rng", range(1, me_sad.MAX_RNG + 1))
def test_plan_covers_every_offset_once(rng):
    p = me_sad._plan(rng)
    n_c = 2 * rng + 1
    seen = np.zeros((n_c, n_c), np.int64)
    for ll in range(p.threads_per_mb):
        i, g = divmod(ll, p.groups)
        for j in range(g * p.k, min(g * p.k + p.k, n_c)):
            seen[i, j] += 1
    assert (seen == 1).all()
    assert p.threads_per_mb == n_c * p.groups and p.groups * p.k >= n_c
    assert (p.groups - 1) * p.k < n_c                 # no empty run
    assert 32 <= p.mbs * p.threads_per_mb <= me_sad._THREADS
    assert p.shared <= me_sad._MAX_SHARED
    assert p.pitch % 16 == 0 and p.pitch >= n_c + 15
    if rng == 16:                                     # the encoder's radius
        assert (p.k, p.groups, p.threads_per_mb) == (11, 3, 99)


def test_wrapper_rejects_radii_outside_the_plan():
    plane = torch.zeros(100, 100, dtype=torch.uint8)
    z = torch.zeros(1, dtype=torch.int32)
    src = torch.zeros(1, 16, 16, dtype=torch.int32)
    for rng in (0, me_sad.MAX_RNG + 1):
        with pytest.raises(ValueError, match="radii"):
            me_sad.sad_grid(plane, z, z, src, rng)


@pytest.mark.parametrize("rng", [1, 2, 6, 7, 11, 16])
def test_emulated_kernel_matches_plain(rng):
    """N = 3 at every wx mod 4 (random bytes); at rng 16 also N = 11, two
    full blocks of 5 MBs and a partial one."""
    gen = np.random.default_rng(rng)
    w = 2 * rng + 16
    plane = gen.integers(0, 256, (w + 21, w + 27)).astype(np.uint8)
    for phase in range(4):
        wy = gen.integers(0, 21, 3).astype(np.int32)
        wx = (4 * gen.integers(0, 6, 3) + (phase + np.arange(3)) % 4) \
            .astype(np.int32)
        src = gen.integers(0, 256, (3, 16, 16)).astype(np.int32)
        np.testing.assert_array_equal(emulate_kernel(plane, wy, wx, src, rng),
                                      _plain(plane, wy, wx, src, rng))
    if rng == 16:
        n = 2 * me_sad._plan(rng).mbs + 1
        wy = gen.integers(0, 21, n).astype(np.int32)
        wx = gen.integers(0, 27, n).astype(np.int32)
        src = gen.integers(0, 256, (n, 16, 16)).astype(np.int32)
        np.testing.assert_array_equal(emulate_kernel(plane, wy, wx, src, rng),
                                      _plain(plane, wy, wx, src, rng))


def test_emulated_kernel_saturates_at_65280():
    """Plane 0, source 255: every offset's SAD is 255 * 256 = 65280."""
    plane = np.zeros((60, 61), np.uint8)
    wy = np.array([0, 5, 12], np.int32)
    wx = np.array([1, 6, 11], np.int32)
    src = np.full((3, 16, 16), 255, np.int32)
    got = emulate_kernel(plane, wy, wx, src, 16)
    assert (got == 65280).all()
    np.testing.assert_array_equal(got, _plain(plane, wy, wx, src, 16))
