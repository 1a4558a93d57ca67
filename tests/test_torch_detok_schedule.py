"""The lane schedule of K4 (csrc/detokenize.cu), held with the plain
per-MB step (the CUDA kernel cannot run here).

K4 gives each token partition a lane; lane p decodes MB rows p, p+P, ...
left to right, and MB (r, c) starts once row r-1 has finished c+1 MBs
(a lag of 1: it reads above[c], which MB (r-1, c) wrote last). Here random
interleavings of the P lanes that keep that rule apply
ops/entropy_device.py:_mb_step one MB at a time, and must give exactly the
raster-order result, partition states included. The control: the most
eager order that keeps only a lag of 0 gives a different qcoeff, so the
test would see a kernel that waited too little.
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

N_ORDERS = 3


@functools.lru_cache(maxsize=None)
def _case(name):
    """part4_cif's keyframe (P = 4), or random bytes over 16 x 8 MBs in
    eight partitions under its probabilities (P = 8, no skip MBs)."""
    frames = []

    class Probe(RefDecoder):
        use_native = True

        def _detokenize_all(self):
            if not frames:
                frames.append(ED.frame_inputs(self))
            super()._detokenize_all()

    dec = Probe()
    dec.decode_frame(read_ivf(vector("part4_cif.ivf")).frames[0][0])
    R, C, P, *arrays = frames[0]
    if name == "random_p8":
        rng = np.random.default_rng(8)
        R, C, P = 16, 8, 8
        arrays = [rng.integers(0, 256, (P, 4096)).astype(np.uint8),
                  np.full(P, 4096, np.int32),
                  np.tile(np.asarray([0, 255, -8, 0], np.int32), (P, 1)),
                  arrays[3], rng.random(R * C) < 0.7,
                  np.zeros(R * C, np.int32)]
    return R, C, P, [torch.from_numpy(np.ascontiguousarray(a))
                     for a in arrays]


def _order(rng, R, C, P, lag, eager=False):
    """An order of all MBs in which lane p takes its rows in turn, each
    left to right, and row r takes column c only once row r-1 has
    finished c + lag MBs: a random lane among those that may go, or
    always the one on the highest-numbered row (eager: rows below run as
    far ahead as the rule lets them)."""
    done = [0] * R
    row = list(range(P))               # the row each lane is on
    order = []
    while len(order) < R * C:
        ok = [p for p in range(P) if row[p] < R and
              (row[p] == 0 or done[row[p] - 1] >= min(done[row[p]] + lag,
                                                      C))]
        p = max(ok, key=row.__getitem__) if eager else \
            ok[rng.integers(len(ok))]
        r = row[p]
        order.append((r, done[r]))
        done[r] += 1
        if done[r] == C:
            row[p] += P
    return order


def _run(R, C, P, arrays, order):
    fr = ED._Frame(R, C, P, *arrays)
    for r, c in order:
        ED._mb_step(fr, r, c)
    return ED._outputs(fr, "cpu")


@pytest.mark.parametrize("name", ["part4_cif", "random_p8"])
def test_lag1_interleavings_match_raster_order(name):
    R, C, P, arrays = _case(name)
    want = ED.detokenize_frame_plain(R, C, P, *arrays)
    rng = np.random.default_rng(R * C + P)
    for _ in range(N_ORDERS):
        got = _run(R, C, P, arrays, _order(rng, R, C, P, lag=1))
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["part4_cif", "random_p8"])
def test_lag0_order_differs(name):
    R, C, P, arrays = _case(name)
    want = ED.detokenize_frame_plain(R, C, P, *arrays)
    got = _run(R, C, P, arrays, _order(None, R, C, P, lag=0, eager=True))
    assert not torch.equal(got[0], want[0])
