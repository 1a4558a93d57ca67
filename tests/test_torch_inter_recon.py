"""Stages 1-2 of the port's decoder (residuals, motion compensation, the
inter reconstruction): `inter_recon_planes`, one launch of
csrc/inter_recon.cu on CUDA tensors, against its plain version
`inter_planes`, exact equality (integer math: tolerance 0).

On the CPU: the wrapper is `inter_planes`, with the references stacked or
given as three planes each; a CPU decode records `dec.inter` with kernel 0
and each frame's inter and SPLITMV MB counts; the wrapper's checks refuse
a wrong dtype, shape, alignment or device (meta tensors stand in for a
card's, so that the checks run before any build).

On the card (`cuda` marker; skipped without one): the kernel's residuals
and inter MBs' pixels equal `inter_planes` on every frame of the eleven
conformance streams and of bench_1080p.ivf, each decode MD5-exact, with
one launch per frame; and on synthetic tables: keyframes, SPLITMV,
bilinear taps, MVs that reach past every edge of the bordered planes (the
dynamic_slice start rule's wrap and clamp), 1x5, 5x1 and 3x3 MBs. This
file imports nothing of JAX, so that the card runs it:

    python -m pytest tests/test_torch_inter_recon.py -q
    python -m pytest tests/test_torch_inter_recon.py -q -m cuda --noconftest
"""
import collections
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from libvpx_opencl_tpu_torch.models import torch_decoder as TD  # noqa: E402
from libvpx_opencl_tpu_torch.ops import _cuda  # noqa: E402
from libvpx_opencl_tpu_torch.ops import predict as P  # noqa: E402
from libvpx_opencl_tpu_torch.ops import wavefront as W  # noqa: E402
from libvpx_opencl_tpu_torch.utils import trace  # noqa: E402
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf  # noqa: E402
from libvpx_opencl_tpu_torch.utils.md5 import (  # noqa: E402
    frame_md5, load_golden_md5s)

VECTORS = os.path.join(HERE, "vectors")
STREAMS = ["kf_qcif", "kf_cif", "inter_qcif", "inter_cif", "lowrate_qcif",
           "odd_65x49", "part4_cif", "profile1_qcif", "profile2_qcif",
           "profile3_qcif", "seg_roi_qcif", "bench_1080p"]

# synthetic cases: (R, C, inter share, SPLITMV share of the inter MBs,
# MV reach in 1/8 pixels, bilinear taps)
CASES = {
    "keyframe": (4, 6, 0.0, 0.0, 64, False),
    "inter": (4, 6, 0.7, 0.0, 64, False),
    "splitmv": (3, 5, 0.8, 0.5, 64, False),
    "bilinear": (4, 6, 0.7, 0.3, 64, True),
    "far_mvs": (3, 4, 1.0, 0.4, 8 * 400, False),
    "geom_1x5": (1, 5, 0.8, 0.4, 8 * 60, False),
    "geom_5x1": (5, 1, 0.8, 0.4, 8 * 60, True),
    "geom_3x3": (3, 3, 0.6, 0.5, 8 * 60, False),
}


def synthetic(name, seed=0):
    """A frame's stage 1-2 inputs as CPU tensors: (R, C, refs, mb, taps,
    split), refs three planes each. Coefficients mostly small with some
    at the int16 extremes, any dequant factors, Y2 full or DC-only, MVs
    up to the case's reach (far cases start windows above, left, right
    and below the bordered planes)."""
    R, C, inter_share, split_share, reach, bilinear = CASES[name]
    rng = np.random.default_rng(seed * 1000 + sum(map(ord, name)))
    N = R * C
    tab = np.zeros((N, TD.MB_COLS), np.int32)
    intra = rng.random(N) >= inter_share
    tab[:, TD.COL_INTRA + 2] = intra
    tab[:, TD.COL_REF] = rng.integers(0, 3, N)
    tab[:, TD.COL_HASY2] = rng.random(N) < 0.7
    tab[:, TD.COL_Y2BIG] = rng.random(N) < 0.5
    tab[:, TD.COL_DQ:TD.COL_DQ + 6] = rng.integers(1, 320, (N, 6))
    tab[:, TD.COL_MV:TD.COL_MV + 2] = rng.integers(-reach, reach + 1, (N, 2))
    tab[:, TD.COL_UVMV:TD.COL_UVMV + 2] = rng.integers(-reach // 2,
                                                       reach // 2 + 1, (N, 2))
    q = rng.integers(-60, 61, (N, 25, 16))
    q[rng.random((N, 25, 16)) < 0.6] = 0
    ext = rng.random((N, 25, 16)) < 0.02
    q[ext] = rng.choice([-32768, 32767, -2048, 2047], ext.sum())
    inter_idx = np.flatnonzero(~intra).astype(np.int64)
    K = len(inter_idx)
    split = None
    pos = np.flatnonzero(rng.random(K) < split_share).astype(np.int64)
    if len(pos):
        S = len(pos)
        split = (pos, rng.integers(-reach, reach + 1, (S, 16, 2)),
                 rng.integers(-reach // 2, reach // 2 + 1, (S, 4, 2)))
        split = tuple(torch.from_numpy(np.ascontiguousarray(
            a, dtype=np.int64 if k == 0 else np.int32))
            for k, a in enumerate(split))
    shapes = W.plane_shapes(R, C)
    refs = tuple(tuple(torch.from_numpy(rng.integers(0, 256, shape)
                                        .astype(np.uint8))
                       for _ in range(3)) for shape in shapes)
    taps = P.BILINEAR_AS_SIXTAP if bilinear else P.SIXTAP_TABLE
    mb = {"table": torch.from_numpy(tab),
          "qcoeff": torch.from_numpy(q.astype(np.int16)),
          "inter_idx": torch.from_numpy(inter_idx)}
    return (R, C, refs if K else None, mb,
            torch.from_numpy(np.asarray(taps, np.int32)), split)


def _stacked(refs):
    return None if refs is None else tuple(torch.stack(p) for p in refs)


def _assert_same(R, C, mb, got, want, label):
    """Residuals whole; planes at the inter MBs (the intra MBs' pixels are
    K1's to write, and both leave them unset)."""
    (gp, gr), (wp, wr) = got, want
    for g, w in zip(gr, wr):
        assert torch.equal(g.cpu(), w.cpu()), f"{label}: residuals differ"
    idx = mb["inter_idx"].cpu()
    r, c = idx // C, idx % C
    for g, w, n in zip(gp, wp, (16, 8, 8)):
        assert torch.equal(W.mb_view(g.cpu(), R, C, n)[r, c],
                           W.mb_view(w.cpu(), R, C, n)[r, c]), \
            f"{label}: {n}x{n} planes differ at the inter MBs"


# -- CPU ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_on_cpu_is_inter_planes(name):
    R, C, refs, mb, taps, split = synthetic(name)
    want = TD.inter_planes(R, C, _stacked(refs), mb, taps, split)
    before = dict(_cuda.launches)
    for given in (refs, _stacked(refs)):
        got = TD.inter_recon_planes(R, C, given, mb, taps, split)
        _assert_same(R, C, mb, got, want, name)
    assert _cuda.launches == before


def test_cpu_decode_records_dec_inter():
    """One `dec.inter` per frame inside `dec.enqueue`, kernel 0 on the
    CPU, and the inter and SPLITMV MB counts of the arrays the frame
    sent."""
    sent = []
    prep = TD.TorchDecoder._prep_arrays

    def keep(self):
        out = prep(self)
        sent.append(out)
        return out
    mp = pytest.MonkeyPatch()
    mp.setattr(TD.TorchDecoder, "_prep_arrays", keep)
    trace.reset()
    trace.enable()
    try:
        dec = TD.TorchDecoder(device="cpu")
        golden = load_golden_md5s(os.path.join(VECTORS,
                                               "inter_qcif.ivf.md5"))
        for k, (payload, _) in enumerate(list(read_ivf(os.path.join(
                VECTORS, "inter_qcif.ivf")).frames)[:5]):
            _, planes = dec.decode_frame(payload)
            assert frame_md5(*planes) == golden[k]
        dec.close()
        recs = trace.snapshot()
    finally:
        trace.enable(False)
        trace.reset()
        mp.undo()
    by_name = collections.defaultdict(list)
    for r in recs:
        by_name[r.name].append(r)
    inter = sorted(by_name["dec.inter"], key=lambda r: r.frame)
    enqueue = {r.frame: r for r in by_name["dec.enqueue"]}
    assert len(inter) == len(sent) == 5
    assert any(a[4] is not None for a in sent)     # SPLITMV MBs appear
    for r, (_, _, inter_idx, _, split) in zip(inter, sent):
        e = enqueue[r.frame]
        assert r.parent == e.id and e.t0 <= r.t0 <= r.t1 <= e.t1
        assert r.attrs == {"kernel": 0, "inter_mbs": len(inter_idx),
                           "split_mbs": 0 if split is None
                           else len(split[0])}
    s = trace.summary(records=recs)
    assert s["dec.inter"]["kernel_per_frame"] == 0


def _meta(name, change):
    """The `name` synthetic case on the meta device (no data, no card),
    with `change(args)` applied to its argument dict."""
    R, C, refs, mb, taps, split = synthetic(name)

    def m(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    args = dict(R=R, C=C, refs=tuple(tuple(m(t) for t in p) for p in refs),
                mb={k: m(v) for k, v in mb.items()}, taps=m(taps),
                split=tuple(m(t) for t in split))
    change(args)
    return args


def _set(path, value):
    def change(args):
        d = args
        for key in path[:-1]:
            d = d[key]
        d[path[-1]] = value(d[path[-1]])
    return change


CHECKS = {
    "table_dtype": (_set(("mb", "table"), lambda t: t.to(torch.int64)),
                    "table must be"),
    "table_shape": (_set(("mb", "table"), lambda t: t[:, :-1]),
                    "table must be"),
    "qcoeff_int32": (_set(("mb", "qcoeff"), lambda t: t.to(torch.int32)),
                     "qcoeff must be"),
    "qcoeff_on_cpu": (_set(("mb", "qcoeff"),
                           lambda t: torch.zeros(t.shape, dtype=t.dtype)),
                      "qcoeff must be"),
    "inter_idx_int32": (_set(("mb", "inter_idx"),
                             lambda t: t.to(torch.int32)),
                        "inter_idx must be"),
    "taps_shape": (_set(("taps",), lambda t: t[:4]), "taps must be"),
    "split_y_mv_shape": (_set(("split",), lambda s: (s[0], s[1][:, :8],
                                                     s[2])),
                         "split y_mv must be"),
    "no_refs": (_set(("refs",), lambda r: None), "inter MBs need refs"),
    "two_refs": (_set(("refs",), lambda r: tuple(p[:2] for p in r)),
                 "last, golden and altref"),
    "ref_shape": (_set(("refs",), lambda r: (r[0], tuple(
        t[:-1] for t in r[1]), r[2])), "reference plane must be"),
    "not_cuda": (lambda args: None, "CUDA or CPU tensors"),
}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_wrapper_checks_refuse(check):
    change, match = CHECKS[check]
    args = _meta("splitmv", change)
    before = dict(_cuda.launches)
    with pytest.raises(ValueError, match=match):
        TD.inter_recon_planes(**args)
    assert _cuda.launches == before


# -- the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the card: see the "
                    "module docstring)")
    return torch.device("cuda")


def _to(dev, R, C, refs, mb, taps, split):
    return (R, C,
            None if refs is None else tuple(tuple(t.to(dev) for t in p)
                                            for p in refs),
            {k: v.to(dev) for k, v in mb.items()}, taps.to(dev),
            None if split is None else tuple(t.to(dev) for t in split))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_synthetic_tables(card, name):
    for seed in range(3):
        R, C, refs, mb, taps, split = _to(card, *synthetic(name, seed))
        before = _cuda.launches["inter_recon"]
        got = TD.inter_recon_planes(R, C, refs, mb, taps, split)
        assert _cuda.launches["inter_recon"] == before + 1
        want = TD.inter_planes(R, C, _stacked(refs), mb, taps, split)
        torch.cuda.synchronize()
        _assert_same(R, C, mb, got, want, f"{name} seed {seed}")


@pytest.mark.cuda
@pytest.mark.parametrize("stream", STREAMS)
def test_kernel_matches_plain_on_every_frame(card, stream, monkeypatch):
    """The stream decoded on the card, each frame's stages 1-2 held
    against `inter_planes` on the same inputs; MD5 of every frame; one
    launch per frame."""
    kernel = TD.inter_recon_planes
    frames = []

    def check(R, C, refs, mb, taps, split):
        got = kernel(R, C, refs, mb, taps, split)
        want = TD.inter_planes(R, C, _stacked(refs), mb, taps, split)
        _assert_same(R, C, mb, got, want, f"{stream} frame {len(frames)}")
        frames.append(split is not None)
        return got
    monkeypatch.setattr(TD, "inter_recon_planes", check)
    path = os.path.join(VECTORS, f"{stream}.ivf")
    golden = load_golden_md5s(path + ".md5")
    before = _cuda.launches["inter_recon"]
    got = [frame_md5(*p) for p in TD.decode_ivf_torch(path, device="cuda")]
    assert got == golden
    assert _cuda.launches["inter_recon"] - before == len(frames) > 0
