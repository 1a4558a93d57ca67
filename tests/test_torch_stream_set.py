"""The stream-set decoder (libvpx_opencl_tpu_torch/parallel/gop.py:
StreamSetDecoder) on four CPU groups: four vectors of uneven lengths,
started at different sets, each stream's frames equal to its golden MD5s;
a truncated payload fails its stream alone and the stream is exact again
from its next keyframe; traced, each set is one frame of the trace (one
`gop.set` root, four `gop.stream` and four `dec.decode` under it); close()
ends every thread the decoder started. `decode_streams` returns what it
did when it ran a decoder per group in a thread pool. A thread works
under its decoder's card only where the card has an index.

    python -m pytest tests/test_torch_stream_set.py -q
"""
import collections
import threading

import numpy as np
import pytest
import torch

from conftest import vector
from libvpx_opencl_tpu_torch.models.torch_decoder import use_card
from libvpx_opencl_tpu_torch.parallel.gop import (StreamSetDecoder,
                                                  StreamSetError,
                                                  decode_streams)
from libvpx_opencl_tpu_torch.utils import trace
from libvpx_opencl_tpu_torch.utils.ivf import read_ivf
from libvpx_opencl_tpu_torch.utils.md5 import frame_md5

#: (vector, frames decoded, first set): uneven lengths and offsets
STREAMS = [("inter_qcif", 4, 0), ("lowrate_qcif", 2, 1), ("kf_qcif", 2, 0),
           ("part4_cif", 1, 2)]
#: inter_qcif's frame 1 (inter) is cut to 2 bytes; its frame 2 is a
#: keyframe
BAD_STREAM, BAD_FRAME = 0, 1
N_SETS = max(n + start for _, n, start in STREAMS)


def _payloads(name):
    return [p for p, _ in read_ivf(vector(name + ".ivf")).frames]


def _golden(name):
    with open(vector(name + ".ivf.md5")) as f:
        return [line.split()[0] for line in f if line.strip()]


@pytest.fixture(scope="module")
def traced_set():
    """The four streams through one StreamSetDecoder with tracing on:
    per stream the (frame index, MD5) of each frame returned, the sets
    that raised and their errors, the trace's records, and the threads
    alive before the decoder was built and after close()."""
    payloads = [_payloads(name) for name, _, _ in STREAMS]
    payloads[BAD_STREAM][BAD_FRAME] = payloads[BAD_STREAM][BAD_FRAME][:2]
    was_on = trace._on
    trace.enable()
    trace.reset()
    before = set(threading.enumerate())
    got = [[] for _ in STREAMS]
    raised = {}
    dec = StreamSetDecoder(len(STREAMS), device="cpu")
    try:
        for t in range(N_SETS):
            idx = [t - start if 0 <= t - start < n else None
                   for _, n, start in STREAMS]
            try:
                frames = dec.decode([None if i is None else payloads[k][i]
                                     for k, i in enumerate(idx)])
            except StreamSetError as e:
                raised[t] = e.errors
                frames = e.frames
            for k, (i, planes) in enumerate(zip(idx, frames)):
                if planes is not None:
                    got[k].append((i, frame_md5(*planes)))
    finally:
        dec.close()
        after = set(threading.enumerate())
        records = trace.snapshot()
        trace.reset()
        trace.enable(was_on)
    return dict(got=got, raised=raised, records=records, before=before,
                after=after)


def test_every_stream_equals_its_golden_md5s(traced_set):
    for k, (name, n, _) in enumerate(STREAMS):
        want = _golden(name)
        frames = [i for i, _ in traced_set["got"][k]]
        assert frames == [i for i in range(n)
                          if (k, i) != (BAD_STREAM, BAD_FRAME)], name
        assert all(md5 == want[i] for i, md5 in traced_set["got"][k]), name


def test_a_failed_frame_fails_its_stream_alone(traced_set):
    t_bad = STREAMS[BAD_STREAM][2] + BAD_FRAME
    assert list(traced_set["raised"]) == [t_bad]
    errors = traced_set["raised"][t_bad]
    assert list(errors) == [BAD_STREAM]
    assert isinstance(errors[BAD_STREAM], IndexError)
    # the other streams took a frame in the failing set and stay exact
    # after it (previous test); the failed stream is exact from its next
    # keyframe on
    later = [i for i, _ in traced_set["got"][BAD_STREAM] if i > BAD_FRAME]
    assert later == [2, 3]


def test_one_frame_id_per_set(traced_set):
    recs = traced_set["records"]
    by_frame = collections.defaultdict(collections.Counter)
    for r in recs:
        by_frame[r.frame][r.name] += 1
    assert None not in by_frame
    assert len(by_frame) == N_SETS
    roots = [r for r in recs if r.parent is None]
    assert sorted(r.name for r in roots) == ["gop.set"] * N_SETS
    assert len({r.frame for r in roots}) == N_SETS
    for t, frame in enumerate(sorted(by_frame)):
        n = sum(0 <= t - start < n for _, n, start in STREAMS)
        names = by_frame[frame]
        assert names["gop.set"] == 1 and names["gop.set_wait"] == 1
        assert names["gop.stream"] == names["dec.decode"] == n, names
    # each stream's dec.decode sits in its gop.stream, on the group's
    # thread, with a card and a stream attribute
    by_id = {r.id: r for r in recs}
    streams = [r for r in recs if r.name == "gop.stream"]
    assert len({r.thread for r in streams}) == len(STREAMS)
    for r in recs:
        if r.name == "dec.decode":
            parent = by_id[r.parent]
            assert parent.name == "gop.stream" and parent.thread == r.thread
            assert by_id[parent.parent].name == "gop.set"
    assert sorted({r.attrs["stream"] for r in streams}) == [0, 1, 2, 3]
    assert all(r.attrs["card"] == -1 and r.attrs["frames.cpu"] == 1
               for r in streams)


def test_close_ends_every_thread(traced_set):
    left = [t for t in traced_set["after"] - traced_set["before"]
            if t.is_alive()]
    assert not left, left


def test_decode_streams_results_as_before():
    """Two QCIF streams of uneven length: per stream a list of (y, u, v)
    uint8 copies of the shown frames, each equal to its golden MD5."""
    names, lengths = ("kf_qcif", "lowrate_qcif"), (2, 3)
    streams = [_payloads(name)[:n] for name, n in zip(names, lengths)]
    out = decode_streams(streams, n_devices=2, gop=2, device="cpu")
    assert [len(frames) for frames in out] == list(lengths)
    for name, frames in zip(names, out):
        want = _golden(name)
        for i, planes in enumerate(frames):
            assert isinstance(planes, tuple) and len(planes) == 3
            assert all(isinstance(p, np.ndarray) and p.dtype == np.uint8
                       and p.flags.owndata for p in planes)
            assert frame_md5(*planes) == want[i], (name, i)


def test_use_card_sets_only_an_indexed_card(monkeypatch):
    """A group thread or dispatch worker of a decoder on "cuda:2" works
    under card 2; one on "cuda" (the current card, as the one-stream
    decoder is built) or on the CPU changes nothing."""
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    for d in ("cuda", "cpu", "cuda:2"):
        use_card(torch.device(d))
    assert calls == [torch.device("cuda", 2)]
