"""The port's device detokenizer (ops/entropy_device.py, K4's plain
version) against the JAX function and the golden Python detokenizer.

The same numpy inputs go through the jitted JAX detokenize_frame_device
and through the port's detokenize_frame_device on CPU tensors (which runs
the plain version): all four outputs (qcoeff, eobs, skipped, states) over
all MBs, tolerance 0 (integer math). The cases: real frames of inter_qcif
(one partition) and part4_cif (four), random partition bytes in
part4_cif's shape (cat 3-6 tokens, eob 15), every blen cut to half (reads
past the end) and R < P. Buffers are padded to one L per shape, so that
JAX compiles once per (R, C, P, L): three compiles.

Then the plain version against the golden Python detokenizer of the
port's RefDecoder on every frame of every small stream, on the MBs that
carry tokens, as tests/test_entropy_device.py holds the JAX function. The
kernel itself runs only on a card: the cuda-marked test and chip_smoke.py.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import VECTOR_DIR, vector
from libvpx_opencl_tpu.ops.entropy_device import \
    detokenize_frame_device as jax_detokenize
from libvpx_opencl_tpu_torch.models.refdec import RefDecoder
from libvpx_opencl_tpu_torch.ops import entropy_device as ED
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf

torch.set_num_threads(1)

L_QCIF = 8192             # longest partition of inter_qcif: 7012 bytes
L_CIF = 8704              # of part4_cif: 8390


@functools.lru_cache(maxsize=None)
def _stream_inputs(name, L):
    """K4's inputs for every frame of a stream (host decoder, native)."""
    frames = []

    class Probe(RefDecoder):
        use_native = True

        def _detokenize_all(self):
            frames.append(ED.frame_inputs(self, L))
            super()._detokenize_all()

    dec = Probe()
    for payload, _ in read_ivf(vector(f"{name}.ivf")).frames:
        dec.decode_frame(payload)
    return tuple(frames)


def _assert_same(case):
    """JAX and the port on one case: all four outputs equal."""
    R, C, P, *arrays = case
    want = jax_detokenize(R, C, P, *(jnp.asarray(a) for a in arrays))
    got = ED.detokenize_frame_device(
        R, C, P, *(torch.from_numpy(np.ascontiguousarray(a))
                   for a in arrays))
    for name, g, w in zip(("qcoeff", "eobs", "skipped", "states"), got,
                          want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("name,frame,L", [
    ("inter_qcif", 0, L_QCIF), ("inter_qcif", 1, L_QCIF),
    ("part4_cif", 0, L_CIF), ("part4_cif", 1, L_CIF)])
def test_matches_jax_on_stream_frames(name, frame, L):
    _assert_same(_stream_inputs(name, L)[frame])


def test_matches_jax_on_random_bytes():
    """Random partition bytes under part4_cif frame 1's probabilities and
    modes, no skip MBs: the case reaches every token category and both
    eob-15 exits."""
    R, C, P, bufs, blens, states0, probs, has_y2, _ = \
        _stream_inputs("part4_cif", L_CIF)[1]
    rng = np.random.default_rng(11)
    bufs = rng.integers(0, 256, bufs.shape).astype(np.uint8)
    blens = np.full(P, bufs.shape[1], np.int32)
    q, e, _, _ = _assert_same((R, C, P, bufs, blens, states0, probs, has_y2,
                               np.zeros(R * C, np.int32)))
    mags = q.abs()
    for lo, hi in ((11, 18), (19, 34), (35, 66), (67, 2048)):   # cat 3-6
        assert ((mags >= lo) & (mags <= hi)).any(), (lo, hi)
    assert (e == 15).any()


def test_matches_jax_with_truncated_partitions():
    """part4_cif's keyframe with every blen cut to half: the decoders run
    past the end (zeros, the LOTS_OF_BITS path) though bytes follow."""
    R, C, P, bufs, blens, *rest = _stream_inputs("part4_cif", L_CIF)[0]
    _assert_same((R, C, P, bufs, blens // 2, *rest))


def test_matches_jax_with_fewer_rows_than_partitions():
    """R = 2 < P = 4: partitions 2 and 3 decode nothing and return their
    states unchanged; partition 1 starts from a state mid-stream."""
    R, C, P = 2, 3, 4
    rng = np.random.default_rng(5)
    bufs = rng.integers(0, 256, (P, 64)).astype(np.uint8)
    blens = np.asarray([64, 40, 64, 64], np.int32)
    states0 = np.asarray([[0, 255, -8, 0], [0x5A0000, 200, 2, 5],
                          [0x123456, 200, 3, 17], [7, 129, -3, 60]],
                         np.int32)
    probs = _stream_inputs("part4_cif", L_CIF)[0][6]
    has_y2 = np.asarray([1, 0, 1, 1, 1, 0], bool)
    skip_in = np.asarray([0, 0, 1, 0, 0, 1], np.int32)
    _, _, _, states = _assert_same((R, C, P, bufs, blens, states0, probs,
                                    has_y2, skip_in))
    assert states[2:].tolist() == states0[2:].tolist()


def test_cpu_tensors_run_the_plain_version():
    """On CPU tensors the wrapper launches nothing and counts nothing; the
    checks of the CUDA path refuse what the kernel does not take."""
    case = _stream_inputs("inter_qcif", L_QCIF)[1]
    R, C, P, *arrays = case
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    before = dict(ED.launches)
    got = ED.detokenize_frame_device(R, C, P, *t)
    want = ED.detokenize_frame_plain(R, C, P, *t)
    assert ED.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(ED.plain_reads) == P and ED.plain_reads[0] > 0
    ED._check_cuda(R, C, P, t)
    bad = [t[0], t[1], t[2], t[3], t[4].to(torch.uint8), t[5]]
    with pytest.raises(ValueError, match="has_y2"):
        ED._check_cuda(R, C, P, bad)
    with pytest.raises(ValueError, match="partitions"):
        ED._check_cuda(R, C, 9, t)


_STREAMS = sorted(f[:-4] for f in os.listdir(VECTOR_DIR)
                  if f.endswith(".ivf") and f != "bench_1080p.ivf")


@pytest.mark.parametrize("name", _STREAMS)
def test_plain_matches_golden_detokenizer(name):
    """Plain version == the golden Python detokenizer (RefDecoder,
    use_native = False) on every frame, on the MBs that carry tokens."""
    checked = []

    class Compare(RefDecoder):
        use_native = False

        def _detokenize_all(self):
            R, C, P, *arrays = ED.frame_inputs(self)
            skip_in = arrays[-1]
            super()._detokenize_all()
            q, e, sk, _ = ED.detokenize_frame_plain(
                R, C, P, *(torch.from_numpy(a) for a in arrays))
            live = skip_in.reshape(R, C) == 0
            n = len(checked)
            np.testing.assert_array_equal(
                q.numpy().reshape(R, C, 25, 16)[live], self.qcoeff[live],
                err_msg=f"qcoeff, frame {n}")
            np.testing.assert_array_equal(
                e.numpy().reshape(R, C, 25)[live], self.eobs[live],
                err_msg=f"eobs, frame {n}")
            np.testing.assert_array_equal(
                sk.numpy().reshape(R, C)[live], self.skip[live],
                err_msg=f"skip, frame {n}")
            checked.append(n)

    dec = Compare()
    frames = read_ivf(vector(f"{name}.ivf")).frames
    for payload, _ in frames:
        dec.decode_frame(payload)
    assert len(checked) == len(frames)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run by chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    """K4 on the card equals its plain version on every part4_cif frame,
    one launch per call."""
    for R, C, P, *arrays in _stream_inputs("part4_cif", L_CIF):
        t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        want = ED.detokenize_frame_plain(R, C, P, *t)
        before = ED.launches["detokenize"]
        got = ED.detokenize_frame_device(R, C, P,
                                         *(x.to(cuda_device) for x in t))
        assert ED.launches["detokenize"] == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
